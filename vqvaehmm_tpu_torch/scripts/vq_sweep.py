"""The VQ family's quality ceiling, measured: counterpart of
scripts/vq_sweep.py.

  sweep   num_codes x commitment_beta, and codebook_lr_scale at the
          default point: 40-epoch fixture runs through train_vq_stack
          (the quantizer's two kernels a step, the gather kernel an
          epoch, the code-HMM's EM), scored on the windows' ground truth
          (the nearest-code kernel, the plain recursions, the Viterbi
          kernel).
  joint   after the standard run, alternate (a) the code-HMM's smoothed
          predictive code distribution, (b) 10 full-batch finetune steps
          of encoder and codebook on the VQ loss plus lam x the
          cross-entropy between softmax(-d^2 / tau) and that distribution,
          (c) a refit of the code-HMM, then score.
  seeds   the default point, n8_c0.5 and the joint finetune at lam 0.3
          over seeds 42-46, with paired deltas against the default.

JAX's `lrscale` stage is not here: it patched two rows of a JAX
artifact measured with an earlier knob, and `sweep` computes those rows
with the current one.  Output <outdir>/vq_sweep.json (stages merge into
the file), with the committed artifacts/vq_sweep.json's blocks beside
them under jax_artifact.

    python -m vqvaehmm_tpu_torch.scripts.vq_sweep [--stage all]
        [--epochs 40] [--lam 0.3 1.0] [--seeds 42 43 44 45 46]
        [--device cuda]
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import torch

from .. import recipe
from ..core.config import (Config, DataConfig, ModelConfig, TrainConfig,
                           VQConfig)
from ..core.device import resolve_device
from ..models.hmm import fit_categorical_em
from ..ops import hmm as hmm_ops
from ..train.pipeline import TrainPipeline
from ..train.trainer import ClippedAdam
from ..train.vq_pipeline import VQStack, panel_windows, train_vq_stack
from ._common import (data_dir, device_record, jax_artifact, load_windows,
                      log, parser, write_json)

ARTIFACT = "vq_sweep.json"
STAGES = ("sweep", "joint", "seeds")
SCORE_KEYS = ("acc_smoothed", "bal_acc_smoothed", "switch_smoothed",
              "acc_viterbi", "bal_acc_viterbi", "switch_viterbi")


def base_config(outdir: str, epochs: int, num_codes: int = 8,
                commitment: float = 0.25, lr_scale: float = 1.0,
                seed: int = 42) -> Config:
    """The VQ configuration of a sweep point: the recipe's widths, M codes
    of D=16, lr 3e-3, B=64, no periodic checkpoint."""
    d = data_dir(outdir)
    return Config(
        model=ModelConfig(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32,
                          u_dim=4, trans_hidden=128, family="vqvae"),
        vq=VQConfig(num_codes=num_codes, latent_dim=16,
                    commitment_beta=commitment, codebook_lr_scale=lr_scale),
        data=DataConfig(min_len=20, max_len=200,
                        x_sequences_path=os.path.join(d, "x_sequences.npy"),
                        u_sequences_path=os.path.join(d, "u_sequences.npy")),
        training=TrainConfig(batch_size=64, num_epochs=epochs,
                             learning_rate=3e-3, seed=seed, save_freq=0,
                             checkpoint_dir=os.path.join(outdir, "vqsw")))


def sq_dist(z, E):
    """Squared distances (B, T, V) of latents z (B, T, D) to codes E (V, D)."""
    return ((z ** 2).sum(-1, keepdim=True) - 2.0 * z @ E.T
            + (E ** 2).sum(-1)[None, None])


def code_targets(model, hmm, xw, lw):
    """(a) of the joint stage: the code-HMM's smoothed predictive code
    distribution over the panel windows xw (B, T, V), and tau, the median
    squared distance, so that the soft assignment starts neither saturated
    nor uniform."""
    with torch.no_grad():
        codes = model.codes(xw)
        gamma = hmm_ops.posterior_marginals(
            hmm.log_pi, hmm.log_A, hmm.emission.log_prob(codes), lw)
        p_code = gamma @ torch.exp(hmm.emission.logits)
        d2 = sq_dist(model.encode(xw).transpose(1, 2), model.codebook)
        tau = max(float(np.median(d2.cpu().numpy())), 1e-3)
    return p_code, tau


def finetune(model, xw, lw, vmask, p_code, tau, lam, steps, clip):
    """(b) of the joint stage: `steps` full-batch steps (Adam at 1e-3,
    the global norm clipped to `clip`) of encoder and codebook on the VQ
    loss plus lam x the cross-entropy between softmax(-d^2 / tau) and
    p_code over the valid steps.  The last step's (VQ loss, cross-entropy)."""
    vcount = torch.clamp(vmask.sum(), min=1).to(torch.float32)
    opt = ClippedAdam(model.parameters(), 1e-3, gradient_clip=clip)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        parts = model.compute_loss(xw, lw)
        z = model.encode(xw).transpose(1, 2)                     # (B,T,D)
        logq = torch.log_softmax(-sq_dist(z, model.codebook) / tau,
                                 dim=-1)                         # (B,T,V)
        ce = -(p_code * logq).sum(-1)                            # (B,T)
        ce = (ce * vmask).sum() / vcount
        (parts.total + lam * ce).backward()
        opt.update()
    return parts.total.detach(), ce.detach()


def _device_of(stack) -> torch.device:
    return stack.model.device


def score_stack(stack, x: np.ndarray, z_w: np.ndarray) -> dict:
    """Accuracy, balanced accuracy and switch rate of the code-HMM's
    smoothed argmax and Viterbi path over the windows x, and the stack's
    codebook usage."""
    dev = _device_of(stack)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    lens = torch.full((x.shape[0],), x.shape[2], dtype=torch.int32,
                      device=dev)
    with torch.inference_mode():
        gamma = stack.regime_marginals(xt, lens).cpu().numpy()   # (N,T,K)
        vit = stack.viterbi(xt, lens).cpu().numpy()
    zf = z_w.reshape(-1)
    out = {}
    for name, pred in [("smoothed", gamma.argmax(-1)), ("viterbi", vit)]:
        acc, perm = recipe._best_perm_acc(pred.reshape(-1), zf)
        out[f"acc_{name}"] = round(acc, 4)
        out[f"bal_acc_{name}"] = round(
            recipe._balanced_acc(pred.reshape(-1), zf, perm), 4)
        out[f"switch_{name}"] = round(
            float((np.diff(pred, axis=1) != 0).mean()), 4)
    out["codebook_usage"] = stack.usage
    return out


class Study:
    """The points trained in this run, each once: the default operating
    point is a grid point and the joint stage's base (once a lam)."""

    def __init__(self, outdir: str, device):
        self.outdir, self.device = outdir, resolve_device(device)
        self.cache = {}

    def run_point(self, epochs, num_codes, commitment, lr_scale, tag,
                  seed=42):
        key = (epochs, num_codes, commitment, lr_scale, seed)
        if key in self.cache:
            log(f"[{tag}] reusing already-trained point {key}")
            return self.cache[key]
        cfg = base_config(self.outdir, epochs, num_codes, commitment,
                          lr_scale, seed)
        dataset = TrainPipeline(cfg, device=self.device).load_data()
        t0 = time.time()
        stack, state, _ = train_vq_stack(cfg, dataset, log_fn=None,
                                         resume=False, checkpoint_dir=None,
                                         device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        x, _, z_w = load_windows(self.outdir)
        row = {"num_codes": num_codes, "commitment_beta": commitment,
               "codebook_lr_scale": lr_scale, "seed": seed,
               "wall_seconds": round(wall, 1),
               "final_vq_loss": round(stack.history[-1], 4),
               **score_stack(stack, x, z_w)}
        log(f"[{tag}] {json.dumps(row)}")
        self.cache[key] = (row, stack, state, cfg, dataset)
        return self.cache[key]

    def stage_sweep(self, epochs) -> dict:
        rows = []
        for num_codes in (4, 8, 16):
            for commitment in (0.1, 0.25, 0.5):
                tag = f"n{num_codes}_c{commitment}"
                rows.append(self.run_point(epochs, num_codes, commitment,
                                           1.0, tag)[0])
        for lr_scale in (0.5, 2.0):
            tag = f"n8_c0.25_s{lr_scale}"
            rows.append(self.run_point(epochs, 8, 0.25, lr_scale, tag)[0])
        best = max(rows, key=lambda r: r["bal_acc_smoothed"])
        return {"epochs": epochs, "grid": rows,
                "best_by_bal_acc_smoothed": best}

    def stage_joint(self, epochs, outer_iters=2, finetune_epochs=10,
                    lam=1.0, seed=42) -> dict:
        """Joint finetune: does letting the code-HMM talk back to the
        encoder move the quality ceiling?"""
        row0, stack, _, cfg, dataset = self.run_point(
            epochs, 8, 0.25, 1.0, f"joint_base_s{seed}", seed=seed)
        # the cached point stays as trained: the finetune works on a copy
        model = copy.deepcopy(stack.model).train()
        v, t, dev = cfg.vq, cfg.training, self.device
        xw_np, lw_np = panel_windows(dataset.x_seqs, dataset.max_len)
        xw = torch.from_numpy(xw_np).to(dev)
        lw = torch.from_numpy(lw_np).to(dev)
        x_eval, _, z_w = load_windows(self.outdir)
        vmask = (torch.arange(xw.shape[-1], device=dev)[None, :]
                 < lw[:, None])
        iters_log = [{"iter": 0, **score_stack(stack, x_eval, z_w)}]
        hmm = stack.hmm
        for it in range(1, outer_iters + 1):
            p_code, tau = code_targets(model, hmm, xw, lw)
            base, ce = finetune(model, xw, lw, vmask, p_code, tau, lam,
                                finetune_epochs,
                                float(t.gradient_clip or 1.0))
            # (c) refit the regime HMM on the new codes
            codes = model.codes(xw)
            em = fit_categorical_em(codes, K=cfg.model.K, V=v.num_codes,
                                    n_iters=v.hmm_iters, seed=t.seed,
                                    lengths=lw, n_init=v.hmm_restarts,
                                    sticky=v.hmm_sticky)
            hmm = em.model
            scored = VQStack(model.eval(), hmm, stack.history, usage=None)
            row = {"iter": it, "vq_loss": round(float(base), 4),
                   "hmm_ce": round(float(ce), 4),
                   **score_stack(scored, x_eval, z_w)}
            model.train()
            # the shipped usage over the panel's valid steps, for the log
            cu = np.bincount(codes.cpu().numpy()[vmask.cpu().numpy()]
                             .reshape(-1), minlength=v.num_codes)
            row["codebook_usage"] = [round(float(s), 4)
                                     for s in cu / max(cu.sum(), 1)]
            log(f"[joint iter {it}] {json.dumps(row)}")
            iters_log.append(row)
        return {"base": row0, "lam": lam, "tau": "median d^2 per iter",
                "outer_iters": outer_iters, "seed": seed,
                "finetune_epochs": finetune_epochs, "iterations": iters_log}

    def stage_seeds(self, epochs, seeds=(42, 43, 44, 45, 46),
                    prior_per_seed=()) -> dict:
        """The sweep's single-seed headline over seeds: per-seed paired
        deltas against the default point.  prior_per_seed: rows of an
        earlier run to merge (a seed run again supersedes its row)."""
        arms = {"default": (8, 0.25), "n8_c0.5": (8, 0.5)}
        per_seed = [r for r in prior_per_seed if r["seed"] not in set(seeds)]
        for seed in seeds:
            row = {"seed": seed}
            for name, (nc, cb) in arms.items():
                r = self.run_point(epochs, nc, cb, 1.0,
                                   f"seed{seed}_{name}", seed=seed)[0]
                row[name] = {k: r[k] for k in SCORE_KEYS}
                row[name]["min_usage"] = round(min(r["codebook_usage"]), 4)
            last = self.stage_joint(epochs, lam=0.3,
                                    seed=seed)["iterations"][-1]
            row["joint_lam0.3"] = {k: last[k] for k in SCORE_KEYS}
            log(f"[seeds] {json.dumps(row)}")
            per_seed.append(row)
        per_seed.sort(key=lambda r: r["seed"])
        return seeds_summary(epochs, per_seed)


def seeds_summary(epochs, per_seed) -> dict:
    """The seeds block: each arm's values and median (the upper middle
    for an even count), and the paired deltas against the default."""

    def dist(arm, key):
        vals = sorted(r[arm][key] for r in per_seed)
        return {"values": vals, "median": vals[len(vals) // 2]}

    def paired(arm, key):
        ds = sorted(round(r[arm][key] - r["default"][key], 4)
                    for r in per_seed)
        return {"deltas": ds, "median": ds[len(ds) // 2]}

    keys = ("bal_acc_smoothed", "bal_acc_viterbi", "acc_smoothed",
            "acc_viterbi", "switch_smoothed", "switch_viterbi")
    return {"epochs": epochs,
            "seeds": sorted(r["seed"] for r in per_seed),
            "per_seed": per_seed,
            "distributions": {a: {k: dist(a, k) for k in keys}
                              for a in ("default", "n8_c0.5",
                                        "joint_lam0.3")},
            "paired_vs_default": {a: {k: paired(a, k) for k in keys}
                                  for a in ("n8_c0.5", "joint_lam0.3")}}


def main(argv=None) -> int:
    ap = parser("vq_sweep", "The VQ family's codebook sweep, joint "
                "finetune and seed study on the fixture windows.")
    ap.add_argument("--stage", default="all", choices=list(STAGES) + ["all"])
    ap.add_argument("--epochs", type=int, default=recipe.VQ_EPOCHS)
    ap.add_argument("--lam", type=float, nargs="+", default=[0.3, 1.0],
                    help="HMM-consistency weights of the joint stage (a "
                         "self-contained run a value)")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46],
                    help="seeds of --stage seeds; they merge with (and "
                         "supersede) any already in the outdir's file")
    args = ap.parse_args(argv)
    study = Study(args.outdir, args.device)
    load_windows(args.outdir)

    path = os.path.join(args.outdir, ARTIFACT)
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.update(device_record(study.device))
    jax = jax_artifact(ARTIFACT) or {}
    todo = ["sweep", "joint"] if args.stage == "all" else [args.stage]
    summary = {}
    for s in todo:
        log(f"=== stage: {s} ===")
        if s == "sweep":
            out[s] = study.stage_sweep(args.epochs)
            summary[s] = out[s]["best_by_bal_acc_smoothed"]
        elif s == "seeds":
            prior = out.get("seeds", {}).get("per_seed", [])
            out[s] = study.stage_seeds(args.epochs, tuple(args.seeds),
                                       prior_per_seed=prior)
            summary[s] = out[s]["paired_vs_default"]
        else:
            for lam in args.lam:
                key = f"joint_lam{lam}"
                log(f"--- {key} ---")
                out[key] = study.stage_joint(args.epochs, lam=lam)
                summary[key] = out[key]["iterations"][-1]
        # JAX's blocks of the same stages, as committed
        out["jax_artifact"] = {
            "source": "artifacts/vq_sweep.json",
            **{k: v for k, v in jax.items()
               if k in out and k not in ("jax_artifact",)
               and (k in STAGES or k.startswith("joint_lam"))}}
        write_json(args.outdir, ARTIFACT, out)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
