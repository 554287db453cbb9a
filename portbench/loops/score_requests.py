"""Closed-loop bulk scoring, one client: the next request is sent when the
last one's outputs are ready on the device.

The traffic's parameters: a ring of `books` books of `assets` asset
panels each (harness/data.py), made on the device at set-up.  Each
book's listed lengths are the same stratified set, `assets` values spread
evenly over [panel.steps_min, panel.steps_max] with both ends in it,
dealt to the book's assets in an order drawn from the seed; each panel is
zero past its length and the book is padded to its longest.  So every
seed and every book asks the same work, in another order.

A request scores one book: `VAEHMM.posterior(x)` (the backtester's
posterior, over the whole padded T) and `VAEHMM.viterbi_decode(x, u,
lengths)` (the regime path), under torch.inference_mode, as bulk scoring
runs.  Its latency runs from the call to the device's synchronise.  The
outputs stay on the device; a sample of `checked_requests` of the
window's requests, drawn from the seed (a reservoir), is kept for the
comparison: the posterior against the reference's, and the path by the
log-probability it gives away under the reference's HMM."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench.harness import counts, data
from portbench.harness.device import sync
from portbench.reference import hmm as ref_hmm
from portbench.reference import precision
from portbench.reference import vaehmm as ref

# rows of a book the reference takes at once
REF_ROWS = 256


def stratified_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


class Loop:
    # check() compares requests that a window ran
    CHECKS_WINDOW = True

    def __init__(self, ctx):
        from vqvaehmm_tpu_torch.core.config import ModelConfig
        from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

        torch, dev = ctx.torch, ctx.device
        self.ctx, self.torch, self.dev = ctx, torch, dev
        tr = ctx.traffic
        self.d = d = ref.dims_of(ctx.config["model"])
        panel = tr["panel"]
        nbooks, A = tr["books"], tr["assets"]
        lens = stratified_lengths(A, panel["steps_min"], panel["steps_max"])
        order = np.random.default_rng(data.sub_seed(ctx.seed, "books"))
        T = int(lens.max())
        g = data.generator(torch, dev, ctx.seed, "panels")
        x, u = data.regime_panels(torch, nbooks * A, T, d.C, d.U, d.K, g,
                                  panel["stickiness"], panel["noise_scale"])
        self.books = []
        t = torch.arange(T, device=dev)
        for b in range(nbooks):
            ln = torch.as_tensor(order.permutation(lens), device=dev)
            keep = (t[None, :] < ln[:, None]).float()[:, None, :]
            rows = slice(b * A, (b + 1) * A)
            self.books.append(((x[rows] * keep).contiguous(),
                               (u[rows] * keep).contiguous(),
                               ln.to(torch.int32)))
        del x, u
        self.steps = int(lens.sum())          # valid panel-days a request
        self.weights = data.make_weights(torch, d, ctx.seed, dev)
        sync(torch, dev)
        ctx.mark("data")
        if ctx.control:
            rnd = precision.BY_NAME[ctx.control]
            self.request = lambda book: _reference_request(
                torch, self.weights, book, rnd)
        else:
            self.model = VAEHMM(ModelConfig(**ctx.config["model"]),
                                device=dev)
            self.model.load_state_dict(self.weights)
            self.model.eval()
            m = self.model
            self.request = lambda book: (
                m.posterior(book[0]), m.viterbi_decode(*book))
        ctx.mark("program")
        with torch.inference_mode():
            for _ in range(tr["warmup_passes"]):
                for book in self.books:
                    self.request(book)
        sync(torch, dev)
        ctx.mark("warm-up")
        self.pick = np.random.default_rng(data.sub_seed(ctx.seed, "sample"))
        self.kept: List[tuple] = []

    def window(self, seconds: float) -> dict:
        torch = self.torch
        n_keep = self.ctx.traffic["checked_requests"]
        lat, issue = [], 0.0
        i = 0
        with torch.inference_mode():
            t0 = time.perf_counter()
            while True:
                book = i % len(self.books)
                a = time.perf_counter()
                q, z = self.request(self.books[book])
                b = time.perf_counter()
                sync(torch, self.dev)
                c = time.perf_counter()
                lat.append(c - a)
                issue += b - a
                # a reservoir sample of the window's requests
                if i < n_keep:
                    self.kept.append((book, q, z))
                else:
                    j = int(self.pick.integers(0, i + 1))
                    if j < n_keep:
                        self.kept[j] = (book, q, z)
                i += 1
                if c - t0 >= seconds:
                    break
        elapsed = c - t0
        return {"metrics": {"score_steps_per_s": i * self.steps / elapsed,
                            "score_p95_ms": 1e3 * float(
                                np.percentile(lat, 95))},
                "units": {"request": i}, "attempted": i, "failed": 0,
                "seconds": elapsed, "flops": i * self.request_flops(),
                "host": {"issue_s": issue}}

    def request_flops(self) -> int:
        """The FLOPs a request needs: the posterior's encoder over the
        whole padded T, the evidence over the valid steps and the scan."""
        d, A = self.d, self.ctx.traffic["assets"]
        T = int(self.books[0][0].shape[-1])
        return (counts.encode_work(d, A, A * T)[0]
                + counts.evidence_work(d, A, self.steps)[0]
                + counts.viterbi_work(d, A, self.steps)[0])

    def slice(self, span) -> dict:
        """`slice_requests` more requests, each phase in a host span."""
        torch = self.torch
        n = self.ctx.traffic["slice_requests"]
        with torch.inference_mode():
            for i in range(n):
                with span("issue"):
                    self.request(self.books[i % len(self.books)])
                with span("sync"):
                    sync(torch, self.dev)
        T = int(self.books[0][0].shape[-1])
        return {"requests": n, "assets": self.ctx.traffic["assets"],
                "padded_steps": self.ctx.traffic["assets"] * T,
                "steps": self.steps}

    def drop_program(self) -> None:
        self.request = None
        self.model = None
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """q_gap, the largest |q - q_ref| of the kept requests, and
        path_gap, the most log-probability a kept path gives away against
        the reference's best path (nats, a row)."""
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        q_gap = path_gap = 0.0
        refs = {}
        with torch.no_grad():
            for book, q, z in self.kept:
                if book not in refs:
                    refs[book] = _reference_request(
                        torch, self.weights, self.books[book],
                        precision.BY_NAME[self.ctx.rules["reference"]],
                        best=True)
                q_ref, best, hmm = refs[book]
                q_gap = max(q_gap, float((q.float() - q_ref).abs().max()))
                lens = self.books[book][2]
                got = torch.cat([ref_hmm.path_score(
                    *[t[r] if t.dim() > 1 else t for t in hmm],
                    z[r], lens[r]) for r in _blocks(len(lens))])
                path_gap = max(path_gap, float((best - got).max()))
        return {"q_gap": q_gap, "path_gap": path_gap}


def _blocks(n: int):
    return [slice(i, min(n, i + REF_ROWS)) for i in range(0, n, REF_ROWS)]


def _reference_request(torch, weights, book, rnd, best: bool = False):
    """The reference's answer to a request, row block by row block: (q,
    path), every product's operands and the scan's running scores in the
    rounding `rnd`; with best, (q, the best path score of each row, the
    HMM's inputs) instead, the products in `rnd` and the scan in
    float64."""
    x, u, lens = book
    qs, paths, bests, hmms = [], [], [], []
    with torch.no_grad():
        for r in _blocks(x.shape[0]):
            qs.append(ref.posterior(weights, x[r], rnd))
            log_pi, log_A, log_obs = ref.evidence(weights, x[r], u[r],
                                                  lens[r], rnd)
            if best:
                bests.append(ref_hmm.best_score(log_pi, log_A, log_obs,
                                                lens[r]))
                hmms.append((log_A, log_obs))
            else:
                paths.append(ref_hmm.best_path(log_pi, log_A, log_obs,
                                               lens[r], rnd))
    q = torch.cat(qs)
    if not best:
        return q, torch.cat(paths)
    return q, torch.cat(bests), (log_pi, torch.cat([h[0] for h in hmms]),
                                 torch.cat([h[1] for h in hmms]))
