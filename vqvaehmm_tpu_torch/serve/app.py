"""The serving model behind the port's HTTP surfaces.

Counterpart of vqvaehmm_tpu/serve/app.py (InferenceModel,
load_portfolio_head, ModelHandle, get_model, reload_gate, create_app) with
the same request contract:

* `/infer` takes x as [C][T] floats and returns mu, logvar and
  regime_probs; `mode` "smoothed", "filtered" or "viterbi" (with u as
  [U][T]) returns exact-HMM regime probabilities or the MAP path.
* `/predict` returns portfolio weights from the configured head: the
  port's `.npz` or a reference `.pt` head of either family.
* `/stream` feeds one frame of a named session (models/online.py).
* A request is right-padded to the next length of the bucket ladder
  (requests past its top are padded to their own T) and its outputs are
  sliced back; `valid_to` = T keeps them equal to the unpadded result.
* A wrong shape, a non-finite input or a non-finite output is a client
  error (ValueError, which the servers answer with 400).
* A configured checkpoint that is missing is served with random weights
  and a warning, or refused when VQHMM_REQUIRE_CHECKPOINT is set.

On a CUDA device the mean-field forward (solo or micro-batched,
serve/batching.py), the evidence of the three exact modes and of every
streamed frame, and the Viterbi recursion run in the port's CUDA kernels;
the smoothed and filtered modes then run the plain HMM recursions of
ops/hmm.py on that evidence.  There is no CPU fallback: device="cuda" on a
machine without CUDA raises.  Every surface holds the ModelHandle of
`get_model`, whose `reload()` swaps in freshly loaded weights.
"""

# No `from __future__ import annotations`: FastAPI resolves string
# annotations against the module's globals, and create_app's request
# models are its locals.

import hmac
import os
import sys
import threading
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from ..core.device import canonical_device, resolve_device

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)
# the request-body bound of every surface (the FastAPI middleware checks
# the declared Content-Length, since uvicorn imposes none)
MAX_BODY = 64 * 1024 * 1024
MODES = ("mean_field", "smoothed", "filtered", "viterbi")
# serve/batching.py clamps max_batch to the top of this ladder; the port
# pads no batch to its rungs (kernel A's rows do not depend on the batch)
BATCH_LADDER = (1, 2, 4, 8, 16, 32)


def declared_body_too_large(content_length) -> bool:
    """True iff a Content-Length header declares a body beyond MAX_BODY."""
    return bool(content_length) and str(content_length).isdigit() \
        and int(content_length) > MAX_BODY


def _require_finite_input(arr: np.ndarray, name: str) -> None:
    """NaN/Inf inputs are a client error, rejected before any compute (a
    non-finite frame would poison a stream's filter state for good)."""
    if not np.isfinite(arr).all():
        raise ValueError(f"{name} contains non-finite values")


# utils/profiling.py's counters, each a /metrics gauge vqhmm_<name>
COUNT_GAUGES = (
    ("host_syncs", "Blocking host waits on the device in this process."),
    ("plans_made", "Kernel launch plans made (plan cache misses) in this "
                   "process."),
    ("packs_made", "Kernel weight packs made (pack cache misses) in this "
                   "process."),
    ("dropped_spans", "Host spans dropped from the full span buffer in "
                      "this process."),
)


def bind_count_gauges() -> None:
    """Register COUNT_GAUGES beside the launch gauges."""
    from ..utils.profiling import counts
    from .metrics import METRICS

    for name, help_ in COUNT_GAUGES:
        METRICS.register_gauge(
            f"vqhmm_{name}", lambda name=name: float(getattr(counts, name)),
            help_)


def require_finite_output(*arrays) -> None:
    """Finite but absurd inputs (e.g. 1e38) can overflow the forward to
    inf/NaN; that is the client's input, so it is a 400, not a 500.
    Checked a request at a time, so one row never fails its batch-mates."""
    for a in arrays:
        if not np.isfinite(a).all():
            raise ValueError(
                "model produced non-finite outputs for this input "
                "(input magnitude out of range?)")


class InferenceModel:
    """A loaded VAEHMM on one device, answering infer, predict and stream
    requests."""

    is_batching = False  # the surfaces' check (it survives ModelHandle)

    def __init__(self, config_path: str = "inference_config.json",
                 device="cuda"):
        from ..core.config import load_config
        from ..data.checkpoint import (load_params_npz, load_state_dict_file,
                                       params_from_numpy, validate_params_for)
        from ..models.online import StreamManager
        from ..models.vae_hmm import VAEHMM

        self.device = resolve_device(device)
        self.cfg = load_config(config_path)
        if self.cfg.model.family != "vae":
            raise ValueError(
                f"InferenceModel serves model.family='vae', not "
                f"{self.cfg.model.family!r}; get_model picks the family's "
                "serving model")
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
        # made here, not at first use: two first /stream requests racing a
        # lazy init could each build a manager and drop one's sessions
        self._streams = StreamManager(self.model)
        self.bind_metrics()

    def bind_metrics(self) -> None:
        """Point the /metrics gauges at this model.  Registering replaces,
        so a reloaded model leaves no stale gauge; a failed reload calls
        this on the model still serving (ModelHandle.reload)."""
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
        bind_count_gauges()
        METRICS.register_gauge(
            "vqhmm_stream_sessions", self._streams.n_sessions,
            "Live streaming sessions in this worker process.")
        METRICS.register_gauge(
            "vqhmm_checkpoint_loaded",
            lambda: 1.0 if self.checkpoint_loaded else 0.0,
            "1 iff serving weights came from a checkpoint "
            "(0 = random init).")

    def _padded(self, x: List[List[float]]):
        """(1, C, pad_to) float32 and T of one request's x."""
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

    def _forward(self, batch: np.ndarray, lengths: np.ndarray):
        """(mu, logvar, q) as numpy for a (B, C, pad_to) batch whose row i
        is bounded at lengths[i]: one kernel-A launch on a CUDA device.
        The solo path and every micro-batched dispatch come through here.
        Grad mode is thread-local and on in every server thread, so this
        enters inference mode itself."""
        with torch.inference_mode():
            mu, logvar, q = self.model.infer_forward(
                self._tensor(batch), valid_to=self._tensor(lengths))
            return mu.cpu().numpy(), logvar.cpu().numpy(), q.cpu().numpy()

    def infer(self, x: List[List[float]],
              u: Optional[List[List[float]]] = None,
              mode: str = "mean_field"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of "
                             f"{MODES}")
        padded, T = self._padded(x)
        mu, logvar, q = self._forward(padded, np.array([T], np.int32))
        mu_r, lv_r, q_r = mu[0, :, :T], logvar[0, :, :T], q[0, :, :T]
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

    def stream(self, session: str, x_t=None, u_t=None,
               finish: bool = False, state=None, carry_state: bool = False):
        """One frame of a streaming filtered-posterior session
        (models/online.py): settled columns (a lag of two frames) and a
        provisional peek at the newest frame; finish=True flushes the tail
        and closes the session.  carry_state=True returns the filter's
        state, and a client that posts it back (`state`) resumes on any
        worker; `new_session` flags a fresh filter (e.g. an expired id)."""
        if not isinstance(session, str) or not session:
            raise ValueError("field 'session' (non-empty string) required")
        if x_t is None and not finish:
            raise ValueError("field 'x_t' required (or finish=true)")
        if x_t is not None:
            x_arr = np.asarray(x_t, np.float32)
            if x_arr.shape != (self.cfg.model.input_dim,):
                raise ValueError(
                    f"x_t must be [C={self.cfg.model.input_dim}] floats, "
                    f"got shape {x_arr.shape}")
            u_arr = np.asarray(u_t, np.float32) if u_t is not None else None
            if u_arr is None or u_arr.shape != (self.cfg.model.u_dim,):
                raise ValueError(
                    f"u_t must be [U={self.cfg.model.u_dim}] floats")
            # before the filter update: one non-finite frame would poison
            # the session's forward recursion for good
            _require_finite_input(x_arr, "x_t")
            _require_finite_input(u_arr, "u_t")
        else:
            x_arr = u_arr = None
        if state is not None and not isinstance(state, dict):
            raise ValueError("field 'state' must be an exported "
                             "session-state object")
        return self._streams.update(session, x_arr, u_arr, finish=finish,
                                    state=state,
                                    carry_state=bool(carry_state))

    def _get_head(self):
        # one assignment of a finished head: two threads racing the first
        # /predict both build an identical head, and the last one wins
        if self._head is None:
            self._head = load_portfolio_head(self.cfg, self.device)
        return self._head


def load_portfolio_head(cfg, device="cuda"):
    """The configured portfolio head in eval() mode on `device`: a
    reference `.pt` head (family from its state_dict's naming, widths from
    its weights, K held to the model's), or a RegimePortfolioOptimizer
    with its `.npz` loaded, or random-init (seed 0) with a warning if a
    path was configured but not found.  Shared by both serving families."""
    from ..data.checkpoint import (load_head_file, load_params_npz,
                                   params_from_numpy, validate_params_for)
    from ..models.portfolio import HeadConfig, RegimePortfolioOptimizer

    device = resolve_device(device)
    path = str(cfg.head_checkpoint_path or "")
    if path.endswith((".pt", ".pth")) and os.path.exists(path):
        return load_head_file(path, K=cfg.model.K, device=device)
    head = RegimePortfolioOptimizer(
        HeadConfig(K=cfg.model.K, n_assets=cfg.portfolio.n_assets,
                   hidden_dim=cfg.portfolio.hidden_dim),
        device=device, generator=torch.Generator().manual_seed(0))
    # the path verbatim or with the implicit .npz suffix
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


def _env_batch_opts():
    """Micro-batching options from the VQHMM_* environment knobs, or
    None when VQHMM_BATCH is unset."""
    if os.environ.get("VQHMM_BATCH", "") in ("", "0"):
        return None
    lengths = os.environ.get("VQHMM_WARMUP_LENGTHS", "200")
    max_queue = os.environ.get("VQHMM_MAX_QUEUE", "")
    return {"max_batch": int(os.environ.get("VQHMM_MAX_BATCH", "16")),
            "max_wait_ms": float(os.environ.get("VQHMM_MAX_WAIT_MS", "2")),
            "max_queue": int(max_queue) if max_queue else None,
            "pipeline_depth": int(os.environ.get("VQHMM_PIPELINE_DEPTH",
                                                 "2")),
            "warmup_lengths": tuple(int(v) for v in lengths.split(","))
            if lengths else ()}


def _warn_vq_solo() -> None:
    print("WARNING: micro-batching is a vae-family feature; serving the "
          "vqvae family solo", file=sys.stderr, flush=True)


def _build_model(config_path: str, batch_opts: Optional[dict] = None,
                 device="cuda"):
    """One fully initialised serving model on `device`: InferenceModel,
    micro-batched and warmed where batch_opts (from
    ModelHandle.configure_batching) or else the VQHMM_* knobs ask for it,
    or serve/vq.py's VQInferenceModel for a `model.family: vqvae` config."""
    from ..core.config import load_config

    opts = batch_opts if batch_opts is not None else _env_batch_opts()
    if load_config(config_path).model.family == "vqvae":
        from .vq import VQInferenceModel

        if opts:
            _warn_vq_solo()
        return VQInferenceModel(config_path, device=device)
    model = InferenceModel(config_path, device=device)
    if opts:
        from .batching import BatchingModel

        model = BatchingModel(model, max_batch=opts["max_batch"],
                              max_wait_ms=opts["max_wait_ms"],
                              max_queue=opts.get("max_queue"),
                              pipeline_depth=opts.get("pipeline_depth", 2))
        if opts["warmup_lengths"]:
            model.warmup(opts["warmup_lengths"])
    return model


class ModelHandle:
    """The stable handle every serving surface holds; `reload()` swaps in
    freshly loaded weights without a restart.

    reload() re-reads the config, builds and validates a whole new model
    (the start-up checks; with batching a new warmed micro-batcher) on the
    same device beside the old one, then swaps the reference: in-flight
    requests finish on the old model, later ones see the new one, and a
    failed build leaves the old model serving.  The old model, its packed
    weights (kept weakly by ops/fused_encoder.py) and its drained batcher
    are then garbage.  Streaming sessions are local to a model and do not
    survive a reload; clients with carry_state=true resume exactly."""

    def __init__(self, config_path: str, device="cuda"):
        self._config_path = config_path
        self._device = device
        self._reload_lock = threading.Lock()
        self._batch_opts: Optional[dict] = None  # configure_batching
        self._inner = _build_model(config_path, device=device)

    def __getattr__(self, name):
        # looked up a call at a time, so a swapped inner serves at once
        if name == "_inner":  # a handle whose build raised
            raise AttributeError(name)
        return getattr(self._inner, name)

    def infer(self, *args, **kwargs):
        """The inner model's infer.  A request that reached a batcher a
        reload was closing, and so was never computed, is sent to the
        model swapped in: no request fails for a reload."""
        from .batching import DispatcherClosed

        while True:
            inner = self._inner
            try:
                return inner.infer(*args, **kwargs)
            except DispatcherClosed:
                if self._inner is inner:
                    raise

    def configure_batching(self, max_batch: int = 16,
                           max_wait_ms: float = 2.0,
                           warmup_lengths=(200,),
                           max_queue: Optional[int] = None,
                           pipeline_depth: int = 2) -> None:
        """Micro-batch this handle now and after every reload (the
        programmatic twin of VQHMM_BATCH, used by httpd.serve(batch=True)).
        A live batcher takes the new settings in place (pipeline_depth
        from its next rebuild); a closed one is rebuilt."""
        from .batching import BatchingModel

        if self._inner.cfg.model.family == "vqvae":
            _warn_vq_solo()
            return
        with self._reload_lock:
            self._batch_opts = {"max_batch": max_batch,
                                "max_wait_ms": max_wait_ms,
                                "max_queue": max_queue,
                                "pipeline_depth": pipeline_depth,
                                "warmup_lengths": tuple(warmup_lengths
                                                        or ())}
            inner = self._inner
            if inner.is_batching and inner.stopped:
                inner = inner._inner  # unwrap a dispatcher a teardown closed
            if inner.is_batching:
                inner.reconfigure(max_batch=max_batch,
                                  max_wait_ms=max_wait_ms,
                                  max_queue=max_queue)
            else:
                inner = BatchingModel(inner, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms,
                                      max_queue=max_queue,
                                      pipeline_depth=pipeline_depth)
            self._inner = inner
            if self._batch_opts["warmup_lengths"]:
                inner.warmup(self._batch_opts["warmup_lengths"])

    def reload(self) -> dict:
        """Build and validate a new model from the re-read config and swap
        it in; raises without swapping if the build fails.  Concurrent
        reloads serialize."""
        with self._reload_lock:
            try:
                new = _build_model(self._config_path, self._batch_opts,
                                   device=self._device)
            except Exception:
                # the failed candidate may have re-bound the /metrics
                # gauges during its construction: bind them back
                self._inner.bind_metrics()
                raise
            old, self._inner = self._inner, new
        if old.is_batching:
            # retire the old dispatcher after its queued requests finish
            old.close(drain=True)
        return {"reloaded": True,
                "checkpoint_loaded": bool(new.checkpoint_loaded),
                "batching": bool(new.is_batching)}


def reload_gate(token: Optional[str]):
    """The /admin/reload gate of every surface: None if the request may
    proceed, else an (http_status, payload) denial.  The route exists
    only when VQHMM_ENABLE_RELOAD is set, and VQHMM_RELOAD_TOKEN further
    requires a matching X-Reload-Token header."""
    if os.environ.get("VQHMM_ENABLE_RELOAD", "") in ("", "0"):
        return 404, {"detail": "not found"}
    want = os.environ.get("VQHMM_RELOAD_TOKEN", "")
    if want and not hmac.compare_digest(str(token or ""), want):
        return 403, {"detail": "bad reload token"}
    return None


@lru_cache(maxsize=None)
def _handle(config_path: str, device: str) -> ModelHandle:
    return ModelHandle(config_path, device=device)


def get_model(config_path: str = "inference_config.json", device="cuda"):
    """The process-wide ModelHandle for one (config, device), built on
    first use and shared by every serving surface.  Every spelling of a
    device ("cuda", "cuda:0", torch.device("cuda"), the default; "cpu",
    "cpu:0") is the same handle (core/device.py::canonical_device), so a
    reload through one reaches them all.  VQHMM_BATCH=1 makes it
    micro-batch (VQHMM_MAX_BATCH, VQHMM_MAX_WAIT_MS, VQHMM_MAX_QUEUE,
    VQHMM_PIPELINE_DEPTH and VQHMM_WARMUP_LENGTHS tune it);
    `handle.reload()` (POST /admin/reload with VQHMM_ENABLE_RELOAD=1)
    swaps in new weights.  A `model.family: vqvae` config is served by
    serve/vq.py's VQInferenceModel.  `get_model.cache_clear()` forgets
    every handle."""
    return _handle(config_path, str(canonical_device(device)))


get_model.cache_clear = _handle.cache_clear


def default_config_path() -> str:
    """The serving config a factory called without one reads: the
    VQHMM_INFERENCE_CONFIG variable, as the JAX package's module-level
    apps read it, else inference_config.json."""
    return os.environ.get("VQHMM_INFERENCE_CONFIG", "inference_config.json")


def create_app(config_path: Optional[str] = None, device="cuda"):
    """The FastAPI app (fastapi is imported here, so the package never
    needs it); config_path None is default_config_path()."""
    config_path = config_path or default_config_path()
    import time as _time

    from fastapi import FastAPI, HTTPException, Request, Response
    from pydantic import BaseModel

    from .batching import ServerBusy
    from .metrics import CONTENT_TYPE as _METRICS_CT
    from .metrics import METRICS

    app = FastAPI(title="vqvaehmm-tpu-torch inference")

    def model():
        return get_model(config_path, device)

    class InferRequest(BaseModel):
        x: List[List[float]]
        u: Optional[List[List[float]]] = None
        mode: str = "mean_field"

    class StreamRequest(BaseModel):
        session: str
        x_t: Optional[List[float]] = None
        u_t: Optional[List[float]] = None
        finish: bool = False
        state: Optional[dict] = None
        carry_state: bool = False

    @app.middleware("http")
    async def _observe(request, call_next):
        # every route but the scrape itself is recorded
        if request.url.path == "/metrics":
            return await call_next(request)
        t0 = _time.perf_counter()
        if declared_body_too_large(request.headers.get("content-length")):
            resp = Response(content='{"detail": "request body too large"}',
                            status_code=413, media_type="application/json")
        else:
            resp = await call_next(request)
        METRICS.observe_request(request.url.path, resp.status_code,
                                _time.perf_counter() - t0)
        return resp

    @app.get("/metrics")
    def metrics():
        return Response(content=METRICS.render(), media_type=_METRICS_CT)

    @app.get("/health")
    def health():
        return {"status": "ok"}

    @app.post("/infer")
    def infer(req: InferRequest):
        try:
            return model().infer(req.x, u=req.u, mode=req.mode)
        except ValueError as e:
            raise HTTPException(status_code=400, detail=str(e))
        except ServerBusy as e:  # shed load; clients back off
            raise HTTPException(status_code=503, detail=str(e),
                                headers={"Retry-After": "1"})
        except Exception as e:  # noqa: BLE001 (the reference's 500)
            raise HTTPException(status_code=500, detail=str(e))

    @app.post("/predict")
    def predict(req: InferRequest):
        try:
            return model().predict(req.x)
        except ValueError as e:
            raise HTTPException(status_code=400, detail=str(e))
        except Exception as e:  # noqa: BLE001
            raise HTTPException(status_code=500, detail=str(e))

    @app.post("/admin/reload")
    def admin_reload(request: Request):
        denied = reload_gate(request.headers.get("x-reload-token"))
        if denied:
            raise HTTPException(status_code=denied[0],
                                detail=denied[1]["detail"])
        try:
            return model().reload()
        except Exception as e:  # noqa: BLE001 (the old model serves on)
            raise HTTPException(status_code=500,
                                detail=f"reload failed: {e}")

    @app.post("/stream")
    def stream(req: StreamRequest):
        # sessions are local to a worker process; carry_state=true lets a
        # client move between workers
        try:
            return model().stream(
                req.session, x_t=req.x_t, u_t=req.u_t, finish=req.finish,
                state=req.state, carry_state=req.carry_state)
        except ValueError as e:
            raise HTTPException(status_code=400, detail=str(e))
        except Exception as e:  # noqa: BLE001
            raise HTTPException(status_code=500, detail=str(e))

    if os.environ.get("VQHMM_BATCH", "") not in ("", "0"):
        # build and warm at worker boot, before traffic; a config that
        # cannot be built yet is left to the first request to report
        try:
            model()
        except Exception:  # noqa: BLE001
            pass

    return app

