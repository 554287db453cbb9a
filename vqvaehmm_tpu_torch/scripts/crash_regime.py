"""Crash-regime recall on the fixture (counterpart of
scripts/crash_regime.py): why is the rare crash regime's recall (regime
2, some 2% of days) near zero, is it the reference's own behaviour, and
what moves it?

  torch_ref       the reference's own torch model (RefVAEHMM below, a
                  copy of its architecture, loss and Adam loop: beta
                  warm-up, no clip) on the fixture windows, 40 epochs at
                  lr 1e-3, B=64, on --device; scored by its only decode,
                  the mean-field argmax.
  current         the port's quality configuration through TrainPipeline
                  (kernels C and D on the card), all three decodes
                  (kernels 8; 11 and the plain recursions; 11 and B).
  oversample_gt   windows holding a crash day repeated 4 extra times in
                  the training pool (uses the ground truth: an upper
                  bound).
  oversample_vol  the top 20% of windows by mean rolling volatility
                  repeated 4 times: the label-free proxy.
  k5_merge        K=5 states, merged to the 3 labels by majority overlap.

Every arm runs --seeds (default 3).  Output <outdir>/crash_regime.json,
one section a stage (stages merge into the file), with the committed
artifacts/crash_regime.json's summaries beside them under jax_artifact;
the oversampled pools go to <outdir>/crash_pools.

    python -m vqvaehmm_tpu_torch.scripts.crash_regime [--stage all]
        [--seeds 42 43 44] [--epochs 40] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import recipe
from ..core.device import resolve_device
from ..models.vae_hmm import VAEHMM
from ..train.pipeline import TrainPipeline
from ._common import (data_dir, device_record, jax_artifact, load_windows,
                      log, parser, write_json)

ARTIFACT = "crash_regime.json"
K_TRUE = 3
CRASH = 2  # the fixture's ground-truth label of the rare crash regime
STAGES = ["torch_ref", "current", "oversample_gt", "oversample_vol",
          "k5_merge"]
MODES = ("meanfield_argmax", "smoothed_argmax", "viterbi")


def majority_map(pred, true, n_states):
    """state -> true-label map by majority overlap (many-to-one; the K > 3
    analogue of the best permutation used everywhere else)."""
    m = np.zeros(n_states, np.int64)
    for s in range(n_states):
        sel = pred == s
        m[s] = (np.bincount(true[sel], minlength=K_TRUE).argmax()
                if sel.any() else 0)
    return m


def score(pred_w, z_w, n_states=K_TRUE):
    """Per-regime recalls and headline metrics of an (N, T) window decode
    against (N, T) ground truth: the best label permutation for 3 states,
    the majority merge map for more."""
    pred, true = pred_w.reshape(-1), z_w.reshape(-1)
    if n_states == K_TRUE:
        _, perm = recipe._best_perm_acc(pred, true)
        mapped = np.asarray(perm)[pred]
    else:
        mapped = majority_map(pred, true, n_states)[pred]
    recalls = {f"recall_regime{k}":
               round(float((mapped[true == k] == k).mean()), 4)
               for k in range(K_TRUE)}
    # episode detection: the share of contiguous ground-truth crash runs
    # (within a window) with at least one day decoded as crash
    mz = mapped.reshape(z_w.shape)
    hits, total = 0, 0
    for i in range(z_w.shape[0]):
        t = 0
        while t < z_w.shape[1]:
            if z_w[i, t] == CRASH:
                t2 = t
                while t2 < z_w.shape[1] and z_w[i, t2] == CRASH:
                    t2 += 1
                total += 1
                hits += int((mz[i, t:t2] == CRASH).any())
                t = t2
            else:
                t += 1
    return {
        "acc": round(float((mapped == true).mean()), 4),
        "balanced_acc": round(float(np.mean(
            [(mapped[true == k] == k).mean() for k in range(K_TRUE)
             if (true == k).any()])), 4),
        **recalls,
        "switch_rate": round(float((np.diff(
            mapped.reshape(z_w.shape), axis=1) != 0).mean()), 4),
        "crash_episodes_detected": f"{hits}/{total}",
    }


def agg(rows):
    """Seed-distribution summary: per-key [min, median, max]."""
    keys = [k for k in rows[0] if isinstance(rows[0][k], (int, float))
            and k not in ("seed", "wall_seconds")]
    return {k: [round(float(np.min([r[k] for r in rows])), 4),
                round(float(np.median([r[k] for r in rows])), 4),
                round(float(np.max([r[k] for r in rows])), 4)]
            for k in keys}


# ---------------------------------------------------------------- the reference


class RefVAEHMM(torch.nn.Module):
    """The reference's own VAE_HMM (VQ_VAE_HMM_fixed.py:31-143): encoder
    convs C -> H -> H2 -> K; prior MLP u -> K*K, row log-softmax, and
    learnable initial logits; decoder: a soft codebook (K, H), then convs
    H -> H -> 2C.  torch.nn's default initialisation, drawn from the
    global generator."""

    def __init__(self, K=3, C=5, H=64, H2=32, U=4, TH=128):
        super().__init__()
        self.K, self.C, self.U = K, C, U
        self.e1 = torch.nn.Conv1d(C, H, 3, padding=1)
        self.e2 = torch.nn.Conv1d(H, H2, 3, padding=1)
        self.e3 = torch.nn.Conv1d(H2, K, 1)
        self.log_prior = torch.nn.Parameter(torch.zeros(K))
        self.p1 = torch.nn.Linear(U, TH)
        self.p2 = torch.nn.Linear(TH, K * K)
        self.emb = torch.nn.Embedding(K, H)
        self.d1 = torch.nn.Conv1d(H, H, 3, padding=1)
        self.d2 = torch.nn.Conv1d(H, H, 3, padding=1)
        self.d3 = torch.nn.Conv1d(H, 2 * C, 1)

    def encode(self, x):
        h = F.relu(self.e1(x))
        h = F.relu(self.e2(h))
        return self.e3(h)

    def loss(self, x, u, lengths, beta):
        K, C, U = self.K, self.C, self.U
        B, _, T = x.shape
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths[:, None])                       # (B, T)
        log_pi = F.log_softmax(self.log_prior, dim=-1)
        uu = u.permute(0, 2, 1).reshape(B * T, U)
        log_A = F.log_softmax(
            self.p2(F.relu(self.p1(uu))).view(B, T, K, K), -1)
        logits = self.encode(x)
        q = F.softmax(logits, dim=1)
        e = torch.matmul(q.permute(0, 2, 1),
                         self.emb.weight).permute(0, 2, 1)
        h = F.relu(self.d1(e))
        h = F.relu(self.d2(h))
        p = self.d3(h)
        mu, logvar = p[:, :C], p[:, C:]
        var = logvar.exp().clamp(min=1e-8)
        nll = 0.5 * (torch.log(2 * math.pi * var) + (mu - x) ** 2 / var)
        recon = ((nll * mask.unsqueeze(1).float()).sum()
                 / (mask.sum() * C).clamp(min=1.0))
        init_l = (q[:, :, 0] * log_pi[None]).sum(1)
        qp = q[:, :, :-1].permute(0, 2, 1).unsqueeze(-1)
        qn = q[:, :, 1:].permute(0, 2, 1).unsqueeze(-2)
        tr = (qp * qn * log_A[:, 1:]).sum((2, 3))
        tmask = (mask[:, 1:] & mask[:, :-1]).float()
        prior_l = -(init_l + (tr * tmask).sum(1)).mean()
        ent = -(q * F.log_softmax(logits, 1)).sum(1)
        ent = (ent * mask.float()).sum() / B
        return recon + beta * (prior_l - ent)


def ref_batch(rng, x_w, u_w, bs=64):
    """One batch of the reference's RandomChunkDataset and collate_fn
    (:10-29, 164-179): a random window, a chunk length in [20, min(200,
    T)], a random start; zero-padded to the batch's longest chunk."""
    chunks = []
    for _ in range(bs):
        si = int(rng.integers(0, len(x_w)))
        T0 = x_w.shape[2]
        ln = int(rng.integers(20, min(200, T0) + 1))
        st = int(rng.integers(0, T0 - ln + 1))
        chunks.append((x_w[si, :, st:st + ln], u_w[si, :, st:st + ln], ln))
    mx = max(c[2] for c in chunks)
    xb = np.zeros((bs, 5, mx), np.float32)
    ub = np.zeros((bs, 4, mx), np.float32)
    lb = np.zeros((bs,), np.int64)
    for i, (cx, cu, ln) in enumerate(chunks):
        xb[i, :, :ln], ub[i, :, :ln], lb[i] = cx, cu, ln
    return xb, ub, lb


def stage_torch_ref(outdir, seeds, epochs, device):
    """The reference's model trained on the fixture windows with its own
    loop, scored by its mean-field argmax decode."""
    dev = resolve_device(device)
    # full float32 on the card, as the port's models run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x_w, u_w, z_w = load_windows(outdir)
    rows = []
    for seed in seeds:
        torch.manual_seed(seed)
        rng = np.random.default_rng(seed)
        model = RefVAEHMM().to(dev)     # drawn on the CPU, then moved
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        spe, bs = 1000, 64
        nb = spe // bs
        t0 = time.time()
        for ep in range(epochs):
            beta = min(1.0, 2.0 * (ep + 1) / epochs)
            ep_loss = 0.0
            for _ in range(nb):
                xb, ub, lb = (torch.from_numpy(a).to(dev)
                              for a in ref_batch(rng, x_w, u_w, bs))
                opt.zero_grad()
                loss = model.loss(xb, ub, lb, beta)
                loss.backward()
                opt.step()
                ep_loss += float(loss.detach())
            log(f"[torch_ref seed {seed}] epoch {ep + 1}/{epochs} "
                f"loss {ep_loss / nb:.4f}")
        wall = time.time() - t0
        with torch.no_grad():
            q = F.softmax(model.encode(torch.from_numpy(
                x_w.astype(np.float32)).to(dev)), dim=1).cpu().numpy()
        row = score(q.argmax(1), z_w)
        row["seed"] = seed
        row["wall_seconds"] = round(wall, 1)
        rows.append(row)
        log(f"[torch_ref seed {seed}] {json.dumps(row)}")
    return {"decode": "meanfield_argmax (the reference's only decode, "
                      "backtesting.py:155)",
            "config": f"{epochs} epochs @ lr=1e-3, B=64, beta warmup, no "
                      "grad clip (train_model, VQ_VAE_HMM_fixed.py:145-162)",
            "per_seed": rows, "summary": agg(rows)}


# ---------------------------------------------------------------- the port


def train_variant(outdir, tag, seed, x_path, u_path, epochs, device,
                  model_over=None):
    """The quality configuration on a pool, through TrainPipeline: (cfg,
    the trained model's float32 state_dict, wall seconds)."""
    cfg = recipe.recipe_config(outdir, quality=True)
    with tempfile.TemporaryDirectory(prefix=f"vqhmm_crash_{tag}_") as ck:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **(model_over or {})),
            data=dataclasses.replace(cfg.data, x_sequences_path=x_path,
                                     u_sequences_path=u_path),
            training=dataclasses.replace(cfg.training, seed=seed,
                                         save_freq=0, num_epochs=epochs,
                                         checkpoint_dir=ck))
        t0 = time.time()
        pipe = TrainPipeline(cfg, device=device)
        state = pipe.train(log_fn=None)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        wall = time.time() - t0
    params = {k: v.detach().to("cpu", torch.float32)
              for k, v in state.model.state_dict().items()}
    return cfg, params, wall


def eval_all_modes(cfg, params, x_w, u_w, z_w, device):
    """The three decodes of the float32 model, each scored."""
    model = VAEHMM(dataclasses.replace(cfg.model, compute_dtype="float32",
                                       matmul_precision="highest"),
                   device=device)
    model.load_state_dict(params)
    preds = recipe._decodes(model.eval(), x_w, u_w, device)
    return {m: score(preds[m], z_w, cfg.model.K) for m in MODES}


def run_framework_arm(outdir, tag, seeds, x_path, u_path, epochs, device,
                      model_over=None):
    x_w, u_w, z_w = load_windows(outdir)
    per_seed, by_mode = [], {}
    for seed in seeds:
        cfg, params, wall = train_variant(outdir, tag, seed, x_path, u_path,
                                          epochs, device, model_over)
        modes = eval_all_modes(cfg, params, x_w, u_w, z_w, device)
        per_seed.append({"seed": seed, "wall_seconds": round(wall, 1),
                         **modes})
        log(f"[{tag} seed {seed}] viterbi={json.dumps(modes['viterbi'])}")
    for mode in MODES:
        by_mode[mode] = agg([r[mode] for r in per_seed])
    return {"per_seed": per_seed, "summary_by_mode": by_mode}


def _panel_paths(outdir):
    d = data_dir(outdir)
    return (os.path.join(d, "x_sequences.npy"),
            os.path.join(d, "u_sequences.npy"))


def stage_current(outdir, seeds, epochs, device):
    return run_framework_arm(outdir, "current", seeds, *_panel_paths(outdir),
                             epochs, device)


def _write_pool(outdir, x, u, tag):
    d = os.path.join(outdir, "crash_pools")
    os.makedirs(d, exist_ok=True)
    xp, up = (os.path.join(d, f"{n}_{tag}.npy") for n in ("x", "u"))
    np.save(xp, x)
    np.save(up, u)
    return xp, up


def stage_oversample_gt(outdir, seeds, epochs, device, repeat=4):
    """The oracle-assisted bound: windows holding a crash day repeated
    `repeat` extra times in the training pool."""
    x_w, u_w, z_w = load_windows(outdir)
    sel = (z_w == CRASH).any(axis=1)
    x2 = np.concatenate([x_w] + [x_w[sel]] * repeat)
    u2 = np.concatenate([u_w] + [u_w[sel]] * repeat)
    z2 = np.concatenate([z_w] + [z_w[sel]] * repeat)
    log(f"oversample_gt: {int(sel.sum())}/{len(x_w)} crash windows "
        f"x{repeat} -> pool {len(x2)}; crash-day share "
        f"{float((z_w == CRASH).mean()):.4f} -> "
        f"{float((z2 == CRASH).mean()):.4f}")
    out = run_framework_arm(outdir, "os_gt", seeds,
                            *_write_pool(outdir, x2, u2, "gt"), epochs,
                            device)
    out["pool"] = {"crash_windows": int(sel.sum()), "repeat": repeat,
                   "pool_size": len(x2)}
    return out


def stage_oversample_vol(outdir, seeds, epochs, device, repeat=4, frac=0.2):
    """The label-free proxy: the top `frac` of windows by mean rolling
    volatility (feature 2) repeated."""
    x_w, u_w, z_w = load_windows(outdir)
    vol = x_w[:, 2, :].mean(axis=1)
    sel = vol >= np.quantile(vol, 1.0 - frac)
    x2 = np.concatenate([x_w] + [x_w[sel]] * repeat)
    u2 = np.concatenate([u_w] + [u_w[sel]] * repeat)
    overlap = float((z_w[sel] == CRASH).mean())
    log(f"oversample_vol: top {frac:.0%} vol = {int(sel.sum())} windows "
        f"(crash-day share inside them {overlap:.4f}) x{repeat}")
    out = run_framework_arm(outdir, "os_vol", seeds,
                            *_write_pool(outdir, x2, u2, "vol"), epochs,
                            device)
    out["pool"] = {"selected_windows": int(sel.sum()), "repeat": repeat,
                   "crash_day_share_in_selected": round(overlap, 4)}
    return out


def stage_k5_merge(outdir, seeds, epochs, device):
    """K=5 states merged to the 3 labels by majority overlap."""
    return run_framework_arm(outdir, "k5", seeds, *_panel_paths(outdir),
                             epochs, device, model_over={"K": 5})


RUNNERS = {"torch_ref": stage_torch_ref, "current": stage_current,
           "oversample_gt": stage_oversample_gt,
           "oversample_vol": stage_oversample_vol,
           "k5_merge": stage_k5_merge}


def main(argv=None) -> int:
    ap = parser("crash_regime", "Crash-regime recall: the reference's "
                "model, the port's, two oversampled pools and K=5.")
    ap.add_argument("--stage", default="all", choices=STAGES + ["all"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    ap.add_argument("--epochs", type=int, default=recipe.QUALITY_EPOCHS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    path = os.path.join(args.outdir, ARTIFACT)
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    _, _, z_w = load_windows(args.outdir)
    out["crash_day_share"] = round(float((z_w == CRASH).mean()), 4)
    out["seeds"] = args.seeds
    out["epochs"] = args.epochs
    out.update(device_record(device))
    jax = jax_artifact(ARTIFACT) or {}
    todo = STAGES if args.stage == "all" else [args.stage]
    for s in todo:
        log(f"=== stage: {s} ===")
        out[s] = RUNNERS[s](args.outdir, args.seeds, args.epochs, device)
        out["jax_artifact"] = {
            "source": "artifacts/crash_regime.json",
            "seeds": jax.get("seeds"),
            "crash_day_share": jax.get("crash_day_share"),
            **{k: (jax[k].get("summary") or jax[k].get("summary_by_mode"))
               for k in STAGES if k in out and k in jax}}
        write_json(args.outdir, ARTIFACT, out)
    print(json.dumps({s: out[s].get("summary") or out[s].get("summary_by_mode")
                      for s in todo}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
