"""Serving surface of the true-VQ family (model.family: vqvae).

Counterpart of vqvaehmm_tpu/serve/vq.py: binds a trained VQStack archive
(train/vq_pipeline.py) to the /infer and /predict routes the VAE family
serves (serve/app.py::get_model dispatches on the config's model.family).
The response carries what the VQ stack offers: the discrete code index of
each time step, and exact regime posteriors from the categorical-emission
HMM over those codes.

Contract:

    POST /infer {"x": [[C rows of T floats]], "mode"?: "smoothed" |
                 "filtered" | "viterbi"}
      -> {"codes": [T ints], "regime_probs": [[K rows of T floats]],
          "mode": ...}                      (viterbi: "states" instead)
    POST /predict {"x": ...} -> {"weights": [...], "regime_probs": [...]}

`u` is accepted and ignored (the VQ prior is the code-HMM itself).

A request computes its codes once (the JAX surface encodes a second time
inside its jitted marginal, with the same answer).  On a CUDA device that
is one launch of the nearest-code kernel (ops/vq.py) a request, and one
of the Viterbi kernel (ops/fused_viterbi.py) more for mode "viterbi"; the
smoothed and filtered modes run the plain recursions of ops/hmm.py on the
codes' evidence.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import hmm as hmm_ops
from .app import (DEFAULT_BUCKETS, _require_finite_input,
                  load_portfolio_head, require_finite_output)


class VQInferenceModel:
    """A loaded VQStack on one device, answering infer/predict requests
    (the VQ twin of app.InferenceModel)."""

    is_batching = False  # the VQ family is served solo

    def __init__(self, config_path: str = "inference_config.json",
                 device="cuda"):
        from ..core.config import load_config
        from ..models.hmm import CategoricalEmission, HiddenMarkovModel
        from ..train.vq_pipeline import VQStack, make_vq_model

        self.device = resolve_device(device)
        self.cfg = load_config(config_path)
        ckpt = self.cfg.checkpoint_path or ""
        npz = ckpt if ckpt.endswith(".npz") else ckpt + ".npz"
        loaded = bool(ckpt) and os.path.exists(npz)
        if loaded:
            self.stack = VQStack.load(npz, device=self.device)
            vcfg = self.stack.model.cfg
            if vcfg.input_dim != self.cfg.model.input_dim:
                raise ValueError(
                    f"archive {npz!r} expects input_dim={vcfg.input_dim} "
                    f"but the config serves {self.cfg.model.input_dim}")
            if self.stack.hmm.K != self.cfg.model.K:
                raise ValueError(
                    f"archive {npz!r} carries a K={self.stack.hmm.K} "
                    f"regime HMM but the config serves K="
                    f"{self.cfg.model.K}")
            if vcfg.num_codes != self.cfg.vq.num_codes:
                raise ValueError(
                    f"archive {npz!r} holds a {vcfg.num_codes}-code "
                    f"codebook but the config declares vq.num_codes="
                    f"{self.cfg.vq.num_codes}: clients sizing code "
                    "histograms from the config would disagree with "
                    "what is served")
            if vcfg.latent_dim != self.cfg.vq.latent_dim:
                raise ValueError(
                    f"archive {npz!r} uses latent_dim={vcfg.latent_dim} "
                    f"but the config declares vq.latent_dim="
                    f"{self.cfg.vq.latent_dim}")
        else:
            # the VAE surface's demo behaviour: random-init VQ parameters
            # and a uniform code-HMM, with a loud warning (or a failure
            # under VQHMM_REQUIRE_CHECKPOINT=1)
            if ckpt:
                msg = (f"checkpoint_path {ckpt!r} is configured but no "
                       "VQ archive was found; serving UNTRAINED "
                       "random-init weights")
                if os.environ.get("VQHMM_REQUIRE_CHECKPOINT",
                                  "") not in ("", "0"):
                    raise FileNotFoundError(msg)
                print(f"WARNING: {msg} (set VQHMM_REQUIRE_CHECKPOINT=1 "
                      "to fail instead)", file=sys.stderr, flush=True)
            model = make_vq_model(self.cfg, device=self.device,
                                  generator=torch.Generator().manual_seed(0))
            K, V = self.cfg.model.K, self.cfg.vq.num_codes
            hmm = HiddenMarkovModel(
                np.full(K, 1.0 / K), np.full((K, K), 1.0 / K),
                CategoricalEmission(torch.zeros((K, V),
                                                device=self.device)))
            self.stack = VQStack(model.eval(), hmm, [])
        self.checkpoint_loaded = loaded
        self._head = None
        self.bind_metrics()

    def bind_metrics(self) -> None:
        from ..ops.fused_viterbi import viterbi_fused
        from ..ops.vq import vq_nearest
        from .metrics import METRICS

        for name, fn in (("vq_nearest", vq_nearest),
                         ("viterbi", viterbi_fused)):
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
            raise ValueError(
                f"x must be [C={C}][T] floats, got shape {arr.shape}")
        _require_finite_input(arr, "x")
        T = arr.shape[1]
        pad_to = next((b for b in DEFAULT_BUCKETS if b >= T), T)
        padded = np.zeros((1, C, pad_to), np.float32)
        padded[0, :, :T] = arr
        return torch.from_numpy(padded).to(self.device), T

    def _codes_and_evidence(self, x):
        """(codes (1, Tp), log_obs (1, Tp, K), lengths (1,), T) of one
        request."""
        xp, T = self._padded(x)
        codes = self.stack.codes(xp)
        lengths = torch.tensor([T], dtype=torch.int32, device=self.device)
        return codes, self.stack.log_obs(codes), lengths, T

    def infer(self, x: List[List[float]],
              u: Optional[List[List[float]]] = None,
              mode: str = "smoothed"):
        """Codes and the regime posterior.  mode: 'smoothed' (default, all
        data) | 'filtered' (causal) | 'viterbi' (the MAP path, as
        "states").  'mean_field' maps to 'smoothed', so clients of the VAE
        family can switch stacks without editing request bodies."""
        if mode == "mean_field":
            mode = "smoothed"
        if mode not in ("smoothed", "filtered", "viterbi"):
            raise ValueError(f"unknown mode {mode!r}")
        hmm = self.stack.hmm
        with torch.inference_mode():
            codes, log_obs, lengths, T = self._codes_and_evidence(x)
            out = {"codes": codes[0, :T].cpu().numpy().tolist(),
                   "mode": mode}
            if mode == "viterbi":
                from ..ops.fused_viterbi import viterbi_fused

                states = viterbi_fused(hmm.log_pi, hmm.log_A, log_obs,
                                       lengths).states
                out["states"] = states[0, :T].cpu().numpy().tolist()
                return out
            fn = (hmm_ops.posterior_marginals if mode == "smoothed"
                  else hmm_ops.filtered_marginals)
            g = fn(hmm.log_pi, hmm.log_A, log_obs, lengths)[0, :T]
            g = g.cpu().numpy()                              # (T, K)
        require_finite_output(g)
        out["regime_probs"] = g.T.tolist()       # (K, T) like the VAE's
        return out

    def predict(self, x: List[List[float]]):
        """Portfolio weights from the smoothed regime posterior through
        the configured head (the VAE surface's loader)."""
        hmm = self.stack.hmm
        if self._head is None:
            self._head = load_portfolio_head(self.cfg, self.device)
        with torch.inference_mode():
            _, log_obs, lengths, T = self._codes_and_evidence(x)
            g = hmm_ops.posterior_marginals(hmm.log_pi, hmm.log_A, log_obs,
                                            lengths)[:, :T]  # (1, T, K)
            w_r = self._head(g.transpose(1, 2))[0].cpu().numpy()
            q_r = g[0, T - 1].cpu().numpy()
        require_finite_output(w_r, q_r)
        return {"weights": w_r.tolist(), "regime_probs": q_r.tolist()}

    def stream(self, *args, **kwargs):
        raise ValueError(
            "streaming requires model.family=vae (the vqvae family has "
            "no incremental filter surface)")
