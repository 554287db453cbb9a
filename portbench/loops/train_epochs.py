"""Closed-loop training: the trainer issues epochs back to back.

The traffic's parameters: a pool of `pool.sequences` regime-switching
panels of `pool.steps` steps (harness/data.py), held on the device by
the program's `DeviceEpochSampler`; epochs of `batches_per_epoch`
batches of `batch` chunks, whose lengths lie in the configuration's
[min_len, max_len]; the published clipped Adam and beta warm-up, beta
read by epoch index; one host fetch of the loss an epoch.

The window drives `DeviceEpochSampler.draw_epoch` and the `epoch` that
`make_epoch_step(model, optimizer, fused=True)` returns: kernel D
gathers the windows, chunk by chunk, kernel C computes the loss and every
gradient (in the configuration's mode), clip and Adam update.  Set-up
drives the same object through the first `checked_steps` steps, one
batch a call, keeping the losses, the first gradient as Adam's state
holds it and the parameters after the last; then through one whole
epoch of `batches_per_epoch` batches by the window's own call, keeping
its mean loss and the parameters after it.  The reference follows all
of those steps from the same weights, pool and draws."""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict

from portbench.harness import counts, data
from portbench.harness.device import sync
from portbench.reference import precision
from portbench.reference import train as ref_train
from portbench.reference import vaehmm as ref

ADAM_BETA1 = 0.9
# leaves whose first gradient in the reference is under this share of the
# median leaf's, and elements under this share of their leaf's RMS
# element, move under Adam by round-off alone: Adam's first steps move an
# element by about lr whatever its gradient's size, so where that gradient
# is a near-cancelling sum or near Adam's eps, rounding decides how far it
# moves.  Neither is compared in a change.
NEGLIGIBLE_GRAD = 1e-3


class Loop:
    # check() compares the steps that set-up drove through the window's
    # own call, not a window
    CHECKS_WINDOW = False

    def __init__(self, ctx):
        from vqvaehmm_tpu_torch.core.config import ModelConfig
        from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
        from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
        from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM
        from vqvaehmm_tpu_torch.train.trainer import make_optimizer

        torch, dev = ctx.torch, ctx.device
        self.ctx, self.torch, self.dev = ctx, torch, dev
        cfg, tr = ctx.config, ctx.traffic
        train = cfg["training"]
        self.d = ref.dims_of(cfg["model"])
        self.B, self.nb = tr["batch"], tr["batches_per_epoch"]
        self.T = train["max_len"]
        self.lr, self.clip = train["learning_rate"], train["gradient_clip"]
        self.beta_epochs = train["num_epochs"]
        self.warmup = train["beta_warmup"]
        pool = tr["pool"]
        g = data.generator(torch, dev, ctx.seed, "pool")
        self.px, self.pu = data.regime_panels(
            torch, pool["sequences"], pool["steps"], self.d.C, self.d.U,
            self.d.K, g, pool["stickiness"], pool["noise_scale"])
        self.init = data.make_weights(torch, self.d, ctx.seed, dev)
        sync(torch, dev)
        ctx.mark("data")

        ds = RandomChunkDataset(
            self.px.cpu().numpy(), self.pu.cpu().numpy(), train["min_len"],
            train["max_len"], samples_per_epoch=self.B * self.nb,
            seed=data.sub_seed(ctx.seed, "draws"))
        self.sampler = DeviceEpochSampler(ds, dev)
        self.model = VAEHMM(ModelConfig(**cfg["model"]), device=dev)
        self.model.load_state_dict(self.init)
        self.opt = make_optimizer(self.model, self.lr, self.clip)
        self.epoch_fn = self.sampler.make_epoch_step(self.model, self.opt,
                                                     fused=True)
        ctx.mark("program")
        self.ep = 0
        self.checked, self.betas = [], []
        self.prog: Dict[str, object] = {"losses": []}
        for i in range(tr["checked_steps"]):
            si, st, ln = self.sampler.draw_epoch(self.B, 1)
            self.checked.append(tuple(a[0].cpu().numpy()
                                      for a in (si, st, ln)))
            self.betas.append(self.beta(0))
            if ctx.control:
                continue
            self.prog["losses"].append(
                float(self.epoch_fn(si, st, ln, self.betas[-1])))
            if i == 0:
                self.prog["first"] = {
                    n: self.opt.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)) / (1.0 - ADAM_BETA1)
                    for n, p in self.model.named_parameters()}
        self.prog["params"] = self._params()
        # one whole epoch by the window's own call: kernel D's chunks, and
        # each step's batch and lengths taken from its chunk
        self.ep = 1
        self.epoch_beta = self.beta(self.ep)
        trip = self.sampler.draw_epoch(self.B, self.nb)
        host = [a.cpu().numpy() for a in trip]
        self.epoch_batches = [tuple(a[s] for a in host)
                              for s in range(self.nb)]
        if not ctx.control:
            self.prog["epoch_loss"] = float(self.epoch_fn(*trip,
                                                          self.epoch_beta))
            self.prog["epoch_params"] = self._params()
        ctx.mark("checked steps")
        self.ep = 2
        if not ctx.control:
            for _ in range(tr["warmup_epochs"]):
                self.epoch_fn(*self.sampler.draw_epoch(self.B, self.nb),
                              self.beta(self.ep))
                self.ep += 1
            sync(torch, dev)
            ctx.mark("warm-up")

    def _params(self) -> Dict[str, object]:
        return {n: p.detach().clone()
                for n, p in self.model.named_parameters()}

    def beta(self, ep: int) -> float:
        """The published KL warm-up, min(1, 2 (ep + 1) / num_epochs)."""
        return min(1.0, 2.0 * (ep + 1) / self.beta_epochs) \
            if self.warmup else 1.0

    def window(self, seconds: float) -> dict:
        torch = self.torch
        enqueue = 0.0
        epochs = failed = 0
        lengths = []
        t0 = time.perf_counter()
        while True:
            trip = self.sampler.draw_epoch(self.B, self.nb)
            b = time.perf_counter()
            loss = self.epoch_fn(*trip, self.beta(self.ep))
            enqueue += time.perf_counter() - b
            value = float(loss)
            e = time.perf_counter()
            epochs += 1
            self.ep += 1
            failed += not math.isfinite(value)
            lengths.append(trip[2])
            if e - t0 >= seconds:
                break
        elapsed = e - t0
        steps = int(torch.stack(lengths).long().sum())
        return {"metrics": {"train_seqs_per_s":
                            epochs * self.nb * self.B / elapsed},
                "units": {"epoch": epochs, "step": epochs * self.nb},
                "attempted": epochs, "failed": failed, "seconds": elapsed,
                "flops": counts.train_work(self.d, self.B, steps)[0],
                "host": {"enqueue_s": enqueue}}

    def slice(self, span) -> dict:
        """`slice_epochs` more epochs, each phase in a host span; records
        each step's lengths."""
        lengths = []
        for _ in range(self.ctx.traffic["slice_epochs"]):
            with span("draw"):
                trip = self.sampler.draw_epoch(self.B, self.nb)
            with span("epoch"):
                loss = self.epoch_fn(*trip, self.beta(self.ep))
            with span("sync"):
                float(loss)
            self.ep += 1
            lengths.append(trip[2])
        return {"lengths": lengths, "B": self.B}

    def drop_program(self) -> None:
        del self.model, self.opt, self.epoch_fn, self.sampler
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, fault: str = "") -> Dict[str, float]:
        """The checked steps and epoch against the reference's, computed
        in the cell's `reference` rounding: loss_gap, the largest relative
        gap of a checked step's loss; grad_gap, the worst leaf's gap of
        the first gradient's norm; change_gap, the worst leaf's gap of the
        norm of the parameters' change over the checked steps (of the
        elements `moving` keeps); epoch_loss_gap, the relative gap of the
        checked epoch's mean loss; epoch_change_gap, as change_gap over
        that epoch (the control's readings with a control; with a fault,
        the reference's own steps with that fault planted)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        reference = precision.BY_NAME[self.ctx.rules["reference"]]
        ref_run = self._follow(reference)
        if self.ctx.control or fault:
            rnd = precision.BY_NAME[self.ctx.control] if self.ctx.control \
                else reference
            prog = self._follow(rnd, fault)
        else:
            prog = self.prog
        return compare(prog, ref_run, self.init)

    def _follow(self, rnd, fault: str = "") -> dict:
        """The reference through the checked steps, then the checked
        epoch, in the rounding `rnd`, with `fault` planted."""
        pool = (self.px, self.pu)
        losses, first, params, opt = ref_train.steps(
            self.init, *pool, self.checked, self.T, self.lr, self.clip,
            self.betas, rnd=rnd, fault=fault)
        e_losses, _, e_params, _ = ref_train.steps(
            params, *pool, self.epoch_batches, self.T, self.lr, self.clip,
            [self.epoch_beta] * self.nb, rnd=rnd, fault=fault, opt=opt)
        return {"losses": losses, "first": first, "params": params,
                "epoch_loss": sum(e_losses) / len(e_losses),
                "epoch_params": e_params}


def _norms(tensors: dict) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _leaf_gaps(prog: Dict[str, float], ref_: Dict[str, float],
               names) -> list:
    """|prog norm - reference norm| / max(reference norm, the median
    leaf's reference norm), a leaf."""
    med = statistics.median(ref_[n] for n in names)
    return [abs(prog[n] - ref_[n]) / max(ref_[n], med, 1e-30)
            for n in names]


def _change_gap(prog: dict, ref_: dict, start: str, end: str,
                kept: dict) -> float:
    """The worst leaf's gap of the norm of the change of its `kept`
    elements from `start` to `end`, each side from its own parameters."""
    def change(side):
        return _norms({n: (side[end][n] - side[start][n])[k]
                       for n, k in kept.items()})
    return max(_leaf_gaps(change(prog), change(ref_), list(kept)))


def moving(first: dict) -> dict:
    """Leaf -> the mask of its elements compared in a change, by the
    reference's first gradient (NEGLIGIBLE_GRAD)."""
    norms = _norms(first)
    med = statistics.median(norms.values())
    return {n: g.abs() >= NEGLIGIBLE_GRAD * norms[n] / g.numel() ** 0.5
            for n, g in first.items() if norms[n] >= NEGLIGIBLE_GRAD * med}


def compare(prog: dict, ref_: dict, init: dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                       ref_["losses"]))
    g_ref = _norms(ref_["first"])
    grad_gap = max(_leaf_gaps(_norms(prog["first"]), g_ref, list(g_ref)))
    kept = moving(ref_["first"])
    prog, ref_ = {**prog, "init": init}, {**ref_, "init": init}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": _change_gap(prog, ref_, "init", "params", kept),
            "epoch_loss_gap": abs(prog["epoch_loss"] - ref_["epoch_loss"])
            / abs(ref_["epoch_loss"]),
            "epoch_change_gap": _change_gap(prog, ref_, "params",
                                            "epoch_params", kept)}
