"""The serving model behind the port's HTTP server.

Counterpart of vqvaehmm_tpu/serve/app.py (InferenceModel,
load_portfolio_head, get_model) with the same request contract:

* `/infer` takes x as [C][T] floats and returns mu, logvar and
  regime_probs; `mode` "smoothed", "filtered" or "viterbi" (with u as
  [U][T]) returns exact-HMM regime probabilities or the MAP path.
* A request is right-padded to the next length of the bucket ladder
  (requests past its top are padded to their own T) and its outputs are
  sliced back; `valid_to` = T keeps them equal to the unpadded result.
* A wrong shape, a non-finite input or a non-finite output is a client
  error (ValueError, which the server answers with 400).
* A configured checkpoint that is missing is served with random weights
  and a warning, or refused when VQHMM_REQUIRE_CHECKPOINT is set.

On a CUDA device the mean-field forward, the evidence of the three exact
modes and the Viterbi recursion run in the port's CUDA kernels; the
smoothed and filtered modes then run the plain HMM recursions of
ops/hmm.py on that evidence.  There is no CPU fallback: device="cuda"
on a machine without CUDA raises.  Micro-batching, /stream, hot reload
and the VQ family are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import os
import sys
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)
MAX_BODY = 64 * 1024 * 1024
MODES = ("mean_field", "smoothed", "filtered", "viterbi")


def _require_finite_input(arr: np.ndarray, name: str) -> None:
    """NaN/Inf inputs are a client error, rejected before any compute."""
    if not np.isfinite(arr).all():
        raise ValueError(f"{name} contains non-finite values")


def require_finite_output(*arrays) -> None:
    """Finite but absurd inputs (e.g. 1e38) can overflow the forward to
    inf/NaN; that is the client's input, so it is a 400, not a 500."""
    for a in arrays:
        if not np.isfinite(a).all():
            raise ValueError(
                "model produced non-finite outputs for this input "
                "(input magnitude out of range?)")


class InferenceModel:
    """A loaded VAEHMM on one device, answering infer/predict requests."""

    def __init__(self, config_path: str = "inference_config.json",
                 device="cuda"):
        from ..core.config import load_config
        from ..data.checkpoint import (load_params_npz, load_state_dict_file,
                                       params_from_numpy, validate_params_for)
        from ..models.vae_hmm import VAEHMM

        self.device = resolve_device(device)
        self.cfg = load_config(config_path)
        if self.cfg.model.family != "vae":
            raise NotImplementedError(
                f"model family {self.cfg.model.family!r} is not ported yet "
                "(ROADMAP.md, queue 1)")
        ckpt = self.cfg.checkpoint_path or ""
        npz = ckpt if ckpt.endswith(".npz") else ckpt + ".npz"
        if ckpt and os.path.exists(npz):
            state = params_from_numpy(load_params_npz(npz))
        elif ckpt.endswith((".pt", ".pth")) and os.path.exists(ckpt):
            state = load_state_dict_file(ckpt)
        else:
            state = None
            if ckpt:
                msg = (f"checkpoint_path {ckpt!r} is configured but no "
                       "checkpoint was found; serving UNTRAINED "
                       "random-init weights")
                if os.environ.get("VQHMM_REQUIRE_CHECKPOINT",
                                  "") not in ("", "0"):
                    raise FileNotFoundError(msg)
                print(f"WARNING: {msg} (set VQHMM_REQUIRE_CHECKPOINT=1 to "
                      "fail instead)", file=sys.stderr, flush=True)
        self.model = VAEHMM(self.cfg.model, device=self.device,
                            generator=torch.Generator().manual_seed(0))
        if state is not None:
            validate_params_for(self.model, state,
                                what=f"checkpoint {ckpt!r}")
            self.model.load_state_dict(state)
        self.model.eval()
        self.checkpoint_loaded = state is not None
        self._head = None
        self.bind_metrics()

    def bind_metrics(self) -> None:
        from ..ops.fused_decode import fused_evidence
        from ..ops.fused_infer import fused_forward
        from ..ops.fused_viterbi import viterbi_fused
        from .metrics import METRICS

        for name, fn in (("fused_infer", fused_forward),
                         ("viterbi", viterbi_fused),
                         ("fused_evidence", fused_evidence)):
            METRICS.register_gauge(
                f"vqhmm_kernel_launches_{name}",
                lambda fn=fn: float(fn.launches),
                f"Launches of the {name} CUDA kernel in this process.")
        METRICS.register_gauge(
            "vqhmm_checkpoint_loaded",
            lambda: 1.0 if self.checkpoint_loaded else 0.0,
            "1 iff serving weights came from a checkpoint "
            "(0 = random init).")

    def _padded(self, x: List[List[float]]):
        with np.errstate(over="ignore"):  # f32 overflow is a handled 400
            arr = np.asarray(x, np.float32)
        C = self.cfg.model.input_dim
        if arr.ndim != 2 or arr.shape[0] != C:
            raise ValueError(f"x must be [C={C}][T] floats, got shape "
                             f"{arr.shape}")
        _require_finite_input(arr, "x")
        T = arr.shape[1]
        pad_to = next((b for b in DEFAULT_BUCKETS if b >= T), T)
        padded = np.zeros((1, C, pad_to), np.float32)
        padded[0, :, :T] = arr
        return padded, T

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def infer(self, x: List[List[float]],
              u: Optional[List[List[float]]] = None,
              mode: str = "mean_field"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of "
                             f"{MODES}")
        padded, T = self._padded(x)
        with torch.inference_mode():
            mu, logvar, q = self.model.infer_forward(
                self._tensor(padded), valid_to=T)
            mu_r, lv_r, q_r = (a[0, :, :T].cpu().numpy()
                               for a in (mu, logvar, q))
        require_finite_output(mu_r, lv_r, q_r)
        out = {"mu": mu_r.tolist(), "logvar": lv_r.tolist(),
               "regime_probs": q_r.tolist()}
        if mode == "mean_field":
            return out
        if u is None:
            raise ValueError(f"mode={mode!r} requires field 'u'")
        u_arr = np.asarray(u, np.float32)
        U = self.cfg.model.u_dim
        if u_arr.ndim != 2 or u_arr.shape[0] != U:
            raise ValueError(f"u must be [U={U}][T], got {u_arr.shape}")
        if u_arr.shape[1] != T:
            raise ValueError("u and x time lengths must match")
        _require_finite_input(u_arr, "u")
        up = np.zeros((1, U, padded.shape[2]), np.float32)
        up[0, :, :T] = u_arr
        xp, upt = self._tensor(padded), self._tensor(up)
        lengths = torch.tensor([T], dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            if mode == "viterbi":
                states = self.model.viterbi_decode(xp, upt, lengths)
                out["states"] = states[0, :T].cpu().numpy().tolist()
                out["mode"] = mode
                return out
            fn = self.model.smoothed_posterior if mode == "smoothed" \
                else self.model.filtered_posterior
            g_r = fn(xp, upt, lengths)[0, :, :T].cpu().numpy()
        require_finite_output(g_r)
        out["regime_probs"] = g_r.tolist()
        out["mode"] = mode
        return out

    def predict(self, x: List[List[float]]):
        """Portfolio weights from the regime posterior at the last step."""
        padded, T = self._padded(x)
        head = self._get_head()
        with torch.inference_mode():
            _, _, q = self.model.infer_forward(self._tensor(padded),
                                               valid_to=T)
            w_r = head(q[:, :, :T])[0].cpu().numpy()
            q_r = q[0, :, T - 1].cpu().numpy()
        require_finite_output(w_r, q_r)
        return {"weights": w_r.tolist(), "regime_probs": q_r.tolist()}

    def _get_head(self):
        # one assignment of a finished head: two threads racing the first
        # /predict both build an identical head, and the last one wins
        if self._head is None:
            self._head = load_portfolio_head(self.cfg, self.device)
        return self._head


def load_portfolio_head(cfg, device="cuda"):
    """The configured RegimePortfolioOptimizer, with its `.npz` checkpoint
    loaded when one is configured and present, else random-init (seed 0)
    with a warning if a path was configured."""
    from ..data.checkpoint import (load_params_npz, params_from_numpy,
                                   validate_params_for)
    from ..models.portfolio import HeadConfig, RegimePortfolioOptimizer

    head = RegimePortfolioOptimizer(
        HeadConfig(K=cfg.model.K, n_assets=cfg.portfolio.n_assets,
                   hidden_dim=cfg.portfolio.hidden_dim),
        device=resolve_device(device),
        generator=torch.Generator().manual_seed(0))
    path = str(cfg.head_checkpoint_path or "")
    if path.endswith((".pt", ".pth")):
        raise NotImplementedError(
            f"head checkpoint {path!r}: reference .pt heads are not ported "
            "yet (ROADMAP.md, queue 1); export the head as .npz")
    npz = path if path.endswith(".npz") else path + ".npz"
    if path and os.path.exists(npz):
        state = params_from_numpy(load_params_npz(npz))
        validate_params_for(head, state, what=f"head checkpoint {path!r}")
        head.load_state_dict(state)
    elif path:
        print(f"WARNING: head_checkpoint_path {path!r} is configured but "
              "no checkpoint was found; /predict serves a random-init "
              "head", file=sys.stderr, flush=True)
    return head.eval()


@lru_cache(maxsize=None)
def get_model(config_path: str = "inference_config.json", device="cuda"):
    """The process-wide model for one (config, device), built on first
    use."""
    return InferenceModel(config_path, device=device)
