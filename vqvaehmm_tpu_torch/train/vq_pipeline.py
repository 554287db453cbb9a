"""Training pipeline of the true-VQ family (model.family: vqvae).

Counterpart of vqvaehmm_tpu/train/vq_pipeline.py: config-driven training
of models/vqvae_hmm.py through TrainPipeline, the fit of the code-HMM,
one portable archive (VQ parameters and the fitted HMM in one .npz, in
the JAX package's layout, so either package loads the other's), and the
inference surface that serving binds to (codes and regime posteriors).

    python -m vqvaehmm_tpu_torch.train.pipeline artifacts/config_vq.json \
        --device cuda
    # -> <checkpoint_dir>/vq_stack.npz, served by serve/vq.py

The regime HMM has `model.K` states with categorical emissions over
`vq.num_codes` code symbols, fit by multi-restart Baum-Welch after the VQ
training (models/hmm.py::fit_categorical_em).

The VQ loss trains through autograd (the nearest-code kernel gives the
indices, ops/vq.py).  A resume or a rerun reproduces a run bit for bit on
the card because every gradient is a matrix product with a fixed
summation order: the convolutions are computed as matrix products
(ops/nn.py::conv1d_same_matmul; cuDNN's default convolution backward adds
with atomics and was seen to differ between two runs from one seed, and
its deterministic algorithm took 15 times the device time), and z_q is
rebuilt as a one-hot matrix product.
"""

from __future__ import annotations

import json
import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..data.checkpoint import (VQ_LEAF_ORDER, load_checkpoint, load_metadata,
                               save_checkpoint, validate_params_for,
                               vq_params_from_numpy)
from ..data.dataset import RandomChunkDataset, epoch_arrays, epoch_skip
from ..models.hmm import (CategoricalEmission, HiddenMarkovModel,
                          fit_categorical_em)
from ..models.vqvae_hmm import VQVAEConfig, VQVAEHMM
from ..ops import hmm as hmm_ops
from .pipeline import _sigterm_flag
from .trainer import ClippedAdam, TrainState, resolve_input_pipeline


def make_vq_model(cfg: Config, device=None,
                  generator: Optional[torch.Generator] = None) -> VQVAEHMM:
    """VQVAEHMM from the unified config: encoder and decoder widths from
    the `model` section, VQ hyperparameters from the `vq` section."""
    m, v = cfg.model, cfg.vq
    return VQVAEHMM(VQVAEConfig(
        input_dim=m.input_dim, hidden_dim=m.hidden_dim,
        hidden_dim2=m.hidden_dim2, num_codes=v.num_codes,
        latent_dim=v.latent_dim, commitment_beta=v.commitment_beta),
        device=device, generator=generator)


def panel_windows(x_seqs, max_len: int,
                  min_len: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic full-coverage windows of a sequence pool: each source
    sequence split into consecutive max_len windows (the tail kept when
    >= min_len), zero-padded to max_len.  Returns (x (N, C, max_len) f32,
    lengths (N,) i32): the panel the code-HMM is fit on (training batches
    are random chunks; the HMM fit wants every time step exactly once)."""
    C = x_seqs[0].shape[0]
    xs, lens = [], []
    for s in x_seqs:
        s = np.asarray(s, np.float32)
        for start in range(0, s.shape[1], max_len):
            w = s[:, start:start + max_len]
            if w.shape[1] < min_len and start > 0:
                break
            pad = np.zeros((C, max_len), np.float32)
            pad[:, :w.shape[1]] = w
            xs.append(pad)
            lens.append(w.shape[1])
    return np.stack(xs), np.asarray(lens, np.int32)


def make_vq_optimizer(model: VQVAEHMM, lr: float,
                      gradient_clip: Optional[float] = None,
                      codebook_lr_scale: float = 1.0) -> ClippedAdam:
    """Adam over the model, the codebook in a parameter group of its own
    at lr * codebook_lr_scale.

    vq.codebook_lr_scale must act on the codebook's update, not on its
    gradient: Adam divides each parameter's step by its own gradient
    scale, so a constant factor on the gradient cancels to eps-level
    noise.  Adam's update is linear in the learning rate and its moments
    do not depend on it, so a group learning rate is exactly the JAX
    package's scaling of the update after the optimizer step: 0.0 freezes
    the codebook, 0.5 and 2.0 halve and double its effective rate while
    the moment estimates stay those of the unscaled gradient."""
    rest = [p for p in model.parameters() if p is not model.codebook]
    return ClippedAdam(
        [{"params": rest},
         {"params": [model.codebook], "lr": lr * codebook_lr_scale}],
        lr, gradient_clip)


def make_vq_epoch_step(model: VQVAEHMM, optimizer: ClippedAdam):
    """epoch(xs, lens) -> (mean loss, per-code counts of the epoch), both
    device tensors, over the stacked batches xs (N, B, C, T) and lens
    (N, B) on the model's device.  Nothing in it waits for the device; the
    caller's read of the two results is the epoch's one host sync."""

    def epoch(xs: torch.Tensor, lens: torch.Tensor):
        total = torch.zeros((), dtype=torch.float32, device=xs.device)
        counts = torch.zeros(model.cfg.num_codes, dtype=torch.int64,
                             device=xs.device)
        for i in range(xs.shape[0]):
            optimizer.zero_grad(set_to_none=True)
            parts = model.compute_loss(xs[i], lens[i])
            parts.total.backward()
            optimizer.update()
            total = total + parts.total.detach()
            counts = counts + parts.counts
        return total / xs.shape[0], counts

    return epoch


def make_code_reinit(model: VQVAEHMM):
    """Dead-code restart: replace the codebook rows flagged in `dead` with
    encoder latents of the given valid (row, t) positions, the standard
    revival move for gradient-VQ collapse (a dead code receives exactly
    zero gradient, so nothing else can ever move it).  Also the
    data-dependent init (dead = all ones)."""

    def reinit(x: torch.Tensor, rows, ts, dead) -> None:
        dev = x.device
        rows, ts, dead = (torch.as_tensor(a, device=dev)
                          for a in (rows, ts, dead))
        with torch.no_grad():
            z_e = model.encode(x)                            # (B, D, T)
            samples = z_e[rows.long(), :, ts.long()]         # (num_codes, D)
            model.codebook.copy_(torch.where(dead[:, None], samples,
                                             model.codebook))

    return reinit


def _sample_valid_positions(rng, lens_np, n):
    """n random (row, t) pairs with t < lens[row] (on the host)."""
    rows = rng.integers(0, len(lens_np), size=n)
    ts = (rng.random(n) * lens_np[rows]).astype(np.int32)
    return rows.astype(np.int32), ts


class VQStack(NamedTuple):
    """A trained VQ-VAE and its fitted code-HMM: what the pipeline
    archives and serving loads (one .npz, no pickle)."""

    model: VQVAEHMM
    hmm: HiddenMarkovModel
    history: list
    # each code's share of the assignments on the full panel at fit time
    # (None for archives written before this field and for demo stacks)
    usage: Optional[list] = None

    # -- inference ----------------------------------------------------

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) int32 code indices (the nearest-code lookup)."""
        return self.model.codes(x)

    def log_obs(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, T, K) emission log-probs of a code sequence."""
        return self.hmm.emission.log_prob(codes)

    def regime_marginals(self, x: torch.Tensor, lengths=None,
                         mode: str = "smoothed") -> torch.Tensor:
        """(B, T, K) exact regime posteriors over the code sequence:
        'smoothed' (all data) or 'filtered' (causal)."""
        if mode not in ("smoothed", "filtered"):
            raise ValueError(f"unknown mode {mode!r}")
        fn = (hmm_ops.posterior_marginals if mode == "smoothed"
              else hmm_ops.filtered_marginals)
        with torch.no_grad():
            return fn(self.hmm.log_pi, self.hmm.log_A,
                      self.log_obs(self.codes(x)), lengths)

    def viterbi(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        """(B, T) MAP regime path over the code sequence."""
        with torch.no_grad():
            return self.hmm.posterior_mode(self.codes(x), lengths)

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        cfg = self.model.cfg
        sd = self.model.state_dict()
        arrays = {f"vq_{i}": sd[k].detach().cpu().numpy()
                  for i, k in enumerate(VQ_LEAF_ORDER)}
        meta = {
            "family": "vqvae",
            "model": {"input_dim": cfg.input_dim,
                      "hidden_dim": cfg.hidden_dim,
                      "hidden_dim2": cfg.hidden_dim2,
                      "num_codes": cfg.num_codes,
                      "latent_dim": cfg.latent_dim,
                      "commitment_beta": cfg.commitment_beta},
            "K": int(self.hmm.K),
            "codebook_usage": self.usage,
        }
        # write, then rename: a kill mid-write can never leave a cut
        # archive at the published path (np.savez appends .npz when it is
        # missing, so the name is made whole first)
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + ".tmp.npz"
        np.savez(tmp,
                 meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 hmm_log_pi=self.hmm.log_pi.cpu().numpy(),
                 hmm_log_A=self.hmm.log_A.cpu().numpy(),
                 hmm_log_B=self.hmm.emission.logits.cpu().numpy(),
                 history=np.asarray(self.history, np.float64),
                 **arrays)
        os.replace(tmp, final)

    @classmethod
    def load(cls, path: str, device="cuda") -> "VQStack":
        dev = resolve_device(device)
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("family") != "vqvae":
                raise ValueError(f"{path!r} is not a vq_stack archive")
            m = meta["model"]
            model = VQVAEHMM(VQVAEConfig(
                input_dim=m["input_dim"], hidden_dim=m["hidden_dim"],
                hidden_dim2=m["hidden_dim2"], num_codes=m["num_codes"],
                latent_dim=m["latent_dim"],
                commitment_beta=m["commitment_beta"]), device=dev)
            n = sum(1 for k in z.files if k.startswith("vq_"))
            if n != len(VQ_LEAF_ORDER):
                raise ValueError(
                    f"archive {path!r} holds {n} arrays but the current "
                    f"VQVAEHMM has {len(VQ_LEAF_ORDER)}")
            state = vq_params_from_numpy([z[f"vq_{i}"] for i in range(n)])
            log_pi, log_A, log_B = (torch.from_numpy(z[k]).to(dev) for k in
                                    ("hmm_log_pi", "hmm_log_A", "hmm_log_B"))
            history = z["history"].tolist()
        validate_params_for(model, state,
                            what=f"archive {path!r} (leaf shape mismatch)")
        model.load_state_dict(state)
        hmm = HiddenMarkovModel(torch.exp(log_pi), torch.exp(log_A),
                                CategoricalEmission(log_B))
        # the saved logs replace the round trip through probabilities, so
        # save -> load is bit-exact
        hmm.log_pi, hmm.log_A = log_pi, log_A
        return cls(model.eval(), hmm, history,
                   usage=meta.get("codebook_usage"))


def train_vq_stack(cfg: Config, dataset: RandomChunkDataset,
                   log_fn=print, resume: bool = True,
                   checkpoint_dir: Optional[str] = None, device="cuda",
                   init_state: Optional[Dict[str, torch.Tensor]] = None,
                   em_init=None
                   ) -> Tuple[Optional[VQStack], TrainState, bool]:
    """Config-driven VQ training and code-HMM fit on `device`.

    Honoured from cfg.training: num_epochs, learning_rate, batch_size,
    gradient_clip, seed, input_pipeline ('auto': the device epoch
    assembly of data/device_sampler.py on a CUDA device), save_freq (the
    periodic `vq_periodic` checkpoint, resumed from automatically) and
    the SIGTERM protocol (checkpoint the epoch boundary and return), the
    contract TrainPipeline.train documents for the VAE family.  A resume
    follows the uninterrupted run's trajectory exactly: the dataset rng
    is fast-forwarded by the draws of the epochs done, and the state of
    the dead-code restarts' rng rides the checkpoint's metadata.

    The HMM is fit afterwards on deterministic full-coverage windows of
    the source pool (panel_windows), with cfg.model.K regime states over
    cfg.vq.num_codes code symbols.

    init_state: a VQVAEHMM state_dict to start from in place of the draw
    from training.seed; em_init: the EM restarts' starting points
    (fit_categorical_em's `init`).  Both exist because the JAX package
    draws them from jax.random inside its own train_vq_stack: a caller
    that holds its draws can hand them over.

    Returns (stack, state, preempted); stack is None when preempted (the
    HMM fit is skipped; a rerun resumes and completes it)."""
    t, v = cfg.training, cfg.vq
    dev = resolve_device(device)
    model = make_vq_model(cfg, device=dev,
                          generator=torch.Generator().manual_seed(t.seed))
    if init_state is not None:
        validate_params_for(model, init_state, what="init_state")
        model.load_state_dict(init_state)
    state = TrainState(model, make_vq_optimizer(
        model, t.learning_rate, t.gradient_clip,
        codebook_lr_scale=float(v.codebook_lr_scale)))
    epoch_step = make_vq_epoch_step(model, state.optimizer)

    sampler = None
    if resolve_input_pipeline(t.input_pipeline, dev) == "device":
        from ..data.device_sampler import DeviceEpochSampler

        sampler = DeviceEpochSampler(dataset, dev)
    num_batches = len(dataset) // t.batch_size

    reinit = make_code_reinit(model)
    rng = np.random.default_rng(t.seed + 1)

    save_freq = int(t.save_freq or 0)
    periodic = (os.path.join(checkpoint_dir, "vq_periodic")
                if checkpoint_dir else None)
    start_epoch, history = 0, []
    meta = (load_metadata(periodic)
            if resume and periodic is not None else None)
    if meta is not None and os.path.exists(periodic + ".pt"):
        state = load_checkpoint(periodic, state)
        start_epoch = int(meta.get("epoch", 0))
        history = [float(l) for l in meta.get("history", [])]
        # the restart rng's number of draws depends on the data (one draw
        # an epoch WITH dead codes), so it cannot be replayed: the saved
        # bit-generator state resumes it exactly
        if meta.get("rng_state") is not None:
            rng.bit_generator.state = meta["rng_state"]
        if log_fn:
            log_fn(f"Resumed from epoch {start_epoch} "
                   f"(step {state.step})")
        # fast-forward the stateful data stream
        for _ in range(start_epoch):
            if sampler is not None:
                sampler.sample_indices_fast(t.batch_size, num_batches)
            else:
                epoch_skip(dataset, t.batch_size)

    def draw_epoch():
        """(xs (N, B, C, T), lens (N, B)) on the device."""
        if sampler is not None:
            # the host ships index triples and the card gathers the
            # windows, one gather a batch (the VQ loss needs x only; the
            # gather of u is the cost of sharing the VAE family's path)
            xs, _, lens = sampler.epoch(t.batch_size, num_batches,
                                        exact_stream=False)
            return xs, lens
        xs, _, lens = epoch_arrays(dataset, t.batch_size)
        return torch.from_numpy(xs).to(dev), torch.from_numpy(lens).to(dev)

    def restart_dead(counts, xs, lens, tag) -> int:
        """Dead-code check on the host and the restart; returns how many
        codes were restarted."""
        c = np.asarray(counts)
        dead = c < max(1.0, v.dead_code_min_usage * c.sum() / v.num_codes)
        if not dead.any():
            return 0
        rows, ts = _sample_valid_positions(rng, lens[0].cpu().numpy(),
                                           v.num_codes)
        reinit(xs[0], rows, ts, dead)
        if log_fn is not None:
            log_fn(f"  restarted {int(dead.sum())} dead codes{tag} "
                   f"(usage {np.array2string(c, precision=0)})")
        return int(dead.sum())

    def save_periodic(epoch, **extra):
        save_checkpoint(periodic, state, metadata={
            "epoch": epoch, "history": [float(l) for l in history],
            "rng_state": rng.bit_generator.state, **extra})

    def panel_codes_and_counts():
        """Codes and per-code assignment counts over the valid time steps
        of the full panel: the criterion the archive's usage audit ships
        with, so the polish and the final warning agree."""
        xw, lw = panel_windows(dataset.x_seqs, dataset.max_len)
        codes = model.codes(torch.from_numpy(xw).to(dev))
        codes_np = codes.cpu().numpy()
        pmask = np.arange(codes_np.shape[1])[None, :] < lw[:, None]
        pc = np.bincount(codes_np[pmask].reshape(-1), minlength=v.num_codes)
        return torch.from_numpy(lw).to(dev), codes, pc

    already_polished = bool(meta.get("polished")) if meta else False
    xs = lens = None

    # The SIGTERM window covers the whole run, the polish tail and the EM
    # fit included: a reclaim during the stages after training must not
    # kill the process in the middle of a write.
    with _sigterm_flag() as sig:
        for ep in range(start_epoch, t.num_epochs):
            xs, lens = draw_epoch()
            if ep == 0 and v.data_init:
                # data-dependent codebook init: the codes start on the
                # latent manifold (nothing revives a code that never wins
                # an assignment)
                rows, ts = _sample_valid_positions(
                    rng, lens[0].cpu().numpy(), v.num_codes)
                reinit(xs[0], rows, ts, np.ones(v.num_codes, bool))
            mean_loss, counts = epoch_step(xs, lens)
            loss = float(mean_loss)       # the epoch's host sync
            if v.dead_code_reinit and ep < t.num_epochs - 1:
                # restart codes below dead_code_min_usage of a uniform
                # share; the last epoch is left alone (a freshly restarted
                # code would ship untrained)
                restart_dead(counts.cpu().numpy(), xs, lens, "")
            history.append(loss)
            if log_fn is not None:
                log_fn(f"Epoch {ep + 1}/{t.num_epochs}, Loss: {loss:.4f}")
            at_save = save_freq and (ep + 1) % save_freq == 0
            if (at_save or sig) and periodic is not None:
                save_periodic(ep + 1, loss=loss, preempted=bool(sig))
            if sig:
                if log_fn:
                    log_fn(f"SIGTERM: checkpointed epoch {ep + 1}/"
                           f"{t.num_epochs}; rerun to auto-resume")
                return None, state, True

        # Final codebook polish.  The criterion is the PANEL usage, the
        # number the archive ships with, so it is defined on every path,
        # a resume that lands past the last training epoch included.  If
        # the shipping usage has codes under the threshold, restart them
        # and train up to `final_polish_epochs` more epochs; codes still
        # dead are recorded (and warned about) through `codebook_usage`.
        polish_done = 0
        max_polish = int(v.final_polish_epochs or 0)
        lw, codes, pc = panel_codes_and_counts()
        if v.dead_code_reinit and max_polish and not already_polished:
            if xs is None:
                # resumed past the last epoch: draw a batch stream for the
                # restart latents and the polish training
                xs, lens = draw_epoch()
            for _ in range(max_polish):
                if restart_dead(pc, xs, lens, " (final polish)") == 0:
                    break
                xs, lens = draw_epoch()
                mean_loss, _ = epoch_step(xs, lens)
                polish_done += 1
                history.append(float(mean_loss))
                if log_fn is not None:
                    log_fn(f"Polish epoch {polish_done}/{max_polish}, "
                           f"Loss: {history[-1]:.4f}")
                lw, codes, pc = panel_codes_and_counts()
                if sig:
                    break
            if polish_done and periodic is not None \
                    and os.path.exists(periodic + ".pt"):
                # the periodic checkpoint now predates the polish: write
                # the polished state over it, so a rerun of the completed
                # command publishes the SAME archive again
                save_periodic(t.num_epochs, preempted=bool(sig),
                              polished=not sig)
            if sig:
                if log_fn:
                    log_fn("SIGTERM during final polish: checkpointed; "
                           "rerun to finish the polish and publish")
                return None, state, True

        # Baum-Welch over the code indices of the full pool, still inside
        # the SIGTERM window: the fit completes and the caller publishes
        # atomically
        em = fit_categorical_em(codes, K=cfg.model.K, V=v.num_codes,
                                n_iters=v.hmm_iters, seed=t.seed,
                                lengths=lw, n_init=v.hmm_restarts,
                                sticky=v.hmm_sticky, init=em_init)
    if log_fn:
        log_fn(f"code-HMM EM: final loglik "
               f"{float(em.log_likelihoods[-1]):.2f} "
               f"({v.hmm_restarts} restarts, {v.hmm_iters} iters)")
    # final codebook health: the panel usage share the archive ships with
    # (padding excluded), from the parameters after the polish
    usage = pc / max(1, pc.sum())
    thresh = v.dead_code_min_usage / v.num_codes
    low = [i for i, s in enumerate(usage) if s < thresh]
    if low and log_fn:
        log_fn(f"WARNING: codebook ships {len(low)} code(s) below the "
               f"dead-code threshold ({thresh:.4f}): "
               f"{[(i, round(float(usage[i]), 4)) for i in low]}; "
               f"consider raising vq.final_polish_epochs or lowering "
               f"vq.num_codes")
    stack = VQStack(model.eval(), em.model, history,
                    usage=[round(float(s), 4) for s in usage])
    return stack, state, False


def train_vq_pipeline(pipeline, log_fn=print,
                      resume: bool = True) -> TrainState:
    """TrainPipeline's vqvae branch: train (resumable, periodic
    checkpoints, SIGTERM-safe), fit the HMM, write the archive to
    <checkpoint_dir>/vq_stack.npz.  Returns the final TrainState, so the
    pipeline's return contract holds for both families; sets
    pipeline.preempted (and writes no archive) when SIGTERM stopped the
    run."""
    cfg = pipeline.cfg
    dataset = pipeline.load_data()
    os.makedirs(cfg.training.checkpoint_dir, exist_ok=True)
    stack, state, preempted = train_vq_stack(
        cfg, dataset, log_fn=log_fn, resume=resume,
        checkpoint_dir=cfg.training.checkpoint_dir, device=pipeline.device)
    pipeline.preempted = preempted
    if preempted:
        return state
    pipeline.history = stack.history
    path = os.path.join(cfg.training.checkpoint_dir, "vq_stack.npz")
    stack.save(path)
    if log_fn:
        log_fn(f"Saved VQ stack to {path}")
    return state
