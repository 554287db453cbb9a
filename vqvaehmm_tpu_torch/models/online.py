"""Streaming (online) exact HMM filtering: feed observations one frame at a
time and get the filtered regime posterior incrementally.

Counterpart of vqvaehmm_tpu/models/online.py, with the same semantics and
the same JSON state format.  OnlineFilter carries the HMM forward state
across updates and does O(1) work a frame: the evidence of one 5-wide
encoder window and one log-space forward step.  The encoder is two stacked
k=3 SAME convolutions (receptive radius 2), so the evidence at time t
depends on x[t-2..t+2]: `update` emits the filtered posterior for t = n-3
on the n-th frame, each column equal to that column of
`VAEHMM.filtered_posterior` over the whole stream; `peek` gives a
provisional estimate for the newest frame (no right context, what the
batch path reports at the sequence end), and `finish` flushes the last
two frames with end-of-sequence semantics.

On a CUDA device a step is one launch of kernel 11
(ops/fused_decode.py::fused_evidence) on the (1, C, 5) window, bounded at
the step's valid_to, then one forward step and a softmax on the device,
written with the ops of ops/hmm.py::forward and filtered_marginals in
their order.  On the CPU the evidence is kernel 11's plain version.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_decode import fused_evidence

W = 5  # window width: the encoder's receptive field (2 convs, radius 2)


def make_step_fn(model):
    """One evidence-and-forward step for OnlineFilter, made once a model
    and shared by its sessions.

    step(xwin (1, C, W), u_t (U,), col, valid_to, alpha_prev (K,),
    is_first) -> (alpha (K,), q (K,)) as float32 numpy arrays."""
    U = model.cfg.u_dim

    def step(xwin: np.ndarray, u_t: np.ndarray, col: int, valid_to: int,
             alpha_prev: np.ndarray, is_first: bool):
        # grad mode is thread-local and on in every server thread; the
        # evidence kernel refuses to run under autograd
        with torch.inference_mode():
            dev = model.device
            uwin = np.zeros((1, U, xwin.shape[2]), np.float32)
            uwin[0, :, col] = u_t  # the prior is pointwise in u
            lengths = torch.tensor([valid_to], dtype=torch.int32,
                                   device=dev)
            log_pi, log_A, log_obs = fused_evidence(
                model, torch.from_numpy(xwin).to(dev),
                torch.from_numpy(uwin).to(dev), lengths)
            obs = log_obs[:, col]                              # (1, K)
            if is_first:
                alpha = log_pi[None, :] + obs
            else:
                prev = torch.from_numpy(alpha_prev).to(dev)[None, :]
                alpha = torch.logsumexp(
                    prev[:, :, None] + log_A[:, col], dim=1) + obs
            q = torch.softmax(alpha, dim=-1)
            return alpha[0].cpu().numpy(), q[0].cpu().numpy()

    return step


class OnlineFilter:
    """Incremental filtered regime posterior over a live stream.

        f = OnlineFilter(model)
        for x_t, u_t in stream:               # x_t (C,), u_t (U,)
            for t, q in f.update(x_t, u_t):   # settled columns (lag 2)
                ...
        for t, q in f.finish():               # the last two columns
            ...
    """

    W = W

    def __init__(self, model, step_fn=None):
        self.model = model
        cfg = model.cfg
        self.K, self.C, self.U = cfg.K, cfg.input_dim, cfg.u_dim
        # frames no future settle or peek reads are pruned: _x[0] holds
        # global frame index _base
        self._x: List[np.ndarray] = []
        self._u: List[np.ndarray] = []
        self._base = 0
        self._n = 0                    # frames received
        self._next = 0                 # next frame index to settle
        self._alpha = np.zeros(self.K, np.float32)
        self._finished = False
        self._step = step_fn if step_fn is not None else make_step_fn(model)

    def update(self, x_t, u_t) -> List[Tuple[int, np.ndarray]]:
        """Feed one frame; return the newly settled (t, q (K,)) columns
        (none for the first two frames, one a call afterwards)."""
        if self._finished:
            raise RuntimeError("finish() already called; reset() to reuse")
        self._x.append(np.asarray(x_t, np.float32).reshape(self.C))
        self._u.append(np.asarray(u_t, np.float32).reshape(self.U))
        self._n += 1
        out = []
        while self._next <= self._n - 3:
            out.append(self._settle(self._next, limit=self._n))
        self._prune()
        return out

    def _prune(self):
        """Drop frames no future settle or peek can read (the window's
        left edge is _next - 2): memory stays O(1) over a stream."""
        keep_from = max(0, self._next - 2)
        if keep_from > self._base:
            drop = keep_from - self._base
            del self._x[:drop]
            del self._u[:drop]
            self._base = keep_from

    def finish(self) -> List[Tuple[int, np.ndarray]]:
        """End of stream: settle the remaining (up to two) frames with
        end-of-sequence padding semantics."""
        if self._finished:
            return []
        self._finished = True
        out = []
        while self._next < self._n:
            out.append(self._settle(self._next, limit=self._n))
        return out

    def peek(self) -> Optional[np.ndarray]:
        """Provisional filtered posterior (K,) of the newest frame, as if
        the stream ended now.  Does not advance the filter."""
        if self._n == 0:
            return None
        alpha = self._alpha
        q = torch.softmax(torch.from_numpy(alpha), dim=-1).numpy()
        for s in range(self._next, self._n):
            alpha, q = self._run_step(s, limit=self._n, alpha=alpha)
        return q

    def reset(self):
        self._x, self._u = [], []
        self._base = 0
        self._n = 0
        self._next = 0
        self._alpha = np.zeros(self.K, np.float32)
        self._finished = False

    @property
    def n_frames(self) -> int:
        return self._n

    # -- session migration ---------------------------------------------

    def state_dict(self) -> dict:
        """The complete filter state as JSON-serializable values, in the
        JAX package's format: a state exported by either package's server
        continues in the other's."""
        return {"x": [v.tolist() for v in self._x],
                "u": [v.tolist() for v in self._u],
                "base": self._base,
                "n": self._n,
                "next": self._next,
                "alpha": self._alpha.tolist(),
                "finished": self._finished}

    def load_state(self, state: dict) -> None:
        self._x = [np.asarray(v, np.float32) for v in state["x"]]
        self._u = [np.asarray(v, np.float32) for v in state["u"]]
        self._base = int(state["base"])
        self._n = int(state["n"])
        self._next = int(state["next"])
        self._alpha = np.asarray(state["alpha"], np.float32)
        self._finished = bool(state["finished"])

    # ------------------------------------------------------------------

    def _run_step(self, s: int, limit: int, alpha):
        """One evidence-and-forward step for frame s (no state writes).

        The window covers globals [w0, w0 + W); frames >= limit are zero
        and the encoder is bounded at valid_to = limit - w0, the batch
        path's zero padding and max(lengths) bound.  Frames past the
        buffer but < limit never reach column s (receptive radius 2, and
        s <= n - 3 there), so zero-filling them is exact."""
        w0 = max(0, s - 2)
        xwin = np.zeros((1, self.C, W), np.float32)
        for g in range(max(w0, self._base), min(limit, self._n, w0 + W)):
            xwin[0, :, g - w0] = self._x[g - self._base]
        return self._step(xwin, self._u[s - self._base], s - w0,
                          min(limit - w0, W), alpha, s == 0)

    def _settle(self, s: int, limit: int) -> Tuple[int, np.ndarray]:
        self._alpha, q = self._run_step(s, limit, self._alpha)
        self._next = s + 1
        return s, q


class SessionConflict(ValueError):
    """A session was replaced or removed (export, finish, carried-state
    replacement) while this call waited on its lock.  A ValueError, so the
    HTTP layers answer it with 400; callers can catch it to retry or
    re-route."""


class StreamManager:
    """Named OnlineFilter sessions for the serving layer (POST /stream).

    Sessions share one step function and expire after ttl_seconds without
    traffic, so abandoned streams cannot pin slots or memory."""

    def __init__(self, model, max_sessions: int = 256,
                 ttl_seconds: float = 3600.0):
        self.model = model
        self.max_sessions = max_sessions
        self.ttl_seconds = ttl_seconds
        self._sessions: Dict[str, OnlineFilter] = {}
        self._touched: Dict[str, float] = {}
        self._step_fn = make_step_fn(model)
        # the global lock guards only the session tables; a filter's
        # compute runs under its own session's lock, so streams never
        # queue behind one another's device step
        self._lock = threading.Lock()
        self._session_locks: Dict[str, threading.Lock] = {}

    def warmup(self) -> None:
        """One step of the shared step function on a zero frame."""
        f = OnlineFilter(self.model, step_fn=self._step_fn)
        f.update(np.zeros(f.C, np.float32), np.zeros(f.U, np.float32))
        f.peek()

    def n_sessions(self) -> int:
        """Live (unexpired) sessions: the /metrics gauge."""
        with self._lock:
            self._expire(time.monotonic())
            return len(self._sessions)

    def export_session(self, session: str) -> dict:
        """Serialize and remove a session (hand-off to another worker).

        The per-session lock is taken first, then the session deregistered
        under the global lock: popping first would race an update that
        already looked the session up (update re-checks registration after
        taking its lock, so no frame is lost whichever side wins)."""
        with self._lock:
            f = self._sessions.get(session)
            lock = self._session_locks.get(session)
            if f is None:
                raise ValueError(f"no open session {session!r}")
        with lock:
            with self._lock:
                if self._sessions.get(session) is not f:
                    # replaced or removed while we waited: a snapshot of f
                    # would be stale beside a newer live filter
                    raise SessionConflict(
                        f"session {session!r} was replaced or closed "
                        "during export; if it was replaced, retry - if "
                        "it was finished, there is nothing to export")
                self._sessions.pop(session, None)
                self._touched.pop(session, None)
                self._session_locks.pop(session, None)
            return f.state_dict()

    def import_session(self, session: str, state: dict) -> None:
        """Adopt a session exported elsewhere; it continues bit for bit.
        Replacing a live session reuses its lock (the replacement waits for
        an in-flight update) and does not count against max_sessions."""
        with self._lock:
            if session not in self._sessions \
                    and len(self._sessions) >= self.max_sessions:
                raise ValueError("too many open stream sessions")
            f = OnlineFilter(self.model, step_fn=self._step_fn)
            f.load_state(state)
            self._sessions[session] = f
            self._session_locks.setdefault(session, threading.Lock())
            self._touched[session] = time.monotonic()

    def _expire(self, now: float) -> None:
        stale = [k for k, t in self._touched.items()
                 if now - t > self.ttl_seconds]
        for k in stale:
            del self._sessions[k]
            del self._touched[k]
            self._session_locks.pop(k, None)

    def update(self, session: str, x_t, u_t, finish: bool = False,
               state: Optional[dict] = None,
               carry_state: bool = False) -> dict:
        """Feed one frame to a named session.

        With carry_state=True the response holds the whole filter state; a
        client that sends it back (`state=...`) may reach any worker.  A
        carried state always replaces the worker's local filter of that id
        (the local copy is stale whenever the client went through another
        worker in between).  `new_session` says whether this request
        started a fresh filter, so a client sees an expired session."""
        while True:
            with self._lock:
                now = time.monotonic()
                self._expire(now)
                f = self._sessions.get(session)
                new_session = f is None
                resumed = False
                if state is not None:
                    if f is None \
                            and len(self._sessions) >= self.max_sessions:
                        raise ValueError("too many open stream sessions")
                    f = OnlineFilter(self.model, step_fn=self._step_fn)
                    f.load_state(state)
                    resumed = True
                    new_session = False
                    self._sessions[session] = f
                    # an existing lock is reused, so the replacement waits
                    # for an in-flight update on the old filter
                    self._session_locks.setdefault(session,
                                                   threading.Lock())
                elif f is None:
                    if len(self._sessions) >= self.max_sessions:
                        raise ValueError("too many open stream sessions")
                    f = OnlineFilter(self.model, step_fn=self._step_fn)
                    self._sessions[session] = f
                    self._session_locks[session] = threading.Lock()
                self._touched[session] = now
                slock = self._session_locks[session]

            with slock:
                with self._lock:
                    if self._sessions.get(session) is not f:
                        if (not new_session and state is None
                                and session not in self._sessions):
                            # exported or finished while we waited: a retry
                            # would resurrect the id as an empty ghost
                            raise SessionConflict(
                                f"session {session!r} was exported or "
                                "finished while this update waited; "
                                "re-send the frame to the session's new "
                                "home (or attach carried state)")
                        continue  # replaced: retry on the current tables
                return self._update_locked(f, session, x_t, u_t, finish,
                                           carry_state, new_session,
                                           resumed)

    def _update_locked(self, f, session, x_t, u_t, finish, carry_state,
                       new_session, resumed) -> dict:
        """update() once the per-session lock is held and the session is
        confirmed registered."""
        settled = f.update(x_t, u_t) if x_t is not None else []
        out = {"settled": [{"t": t, "regime_probs": q.tolist()}
                           for t, q in settled],
               "new_session": new_session and not resumed,
               "resumed": resumed}
        if finish:
            out["settled"] += [{"t": t, "regime_probs": q.tolist()}
                               for t, q in f.finish()]
            with self._lock:
                # never deregister a newer filter registered under this id
                # while we computed
                if self._sessions.get(session) is f:
                    self._sessions.pop(session, None)
                    self._touched.pop(session, None)
                    self._session_locks.pop(session, None)
        else:
            peek = f.peek()
            out["peek"] = peek.tolist() if peek is not None else None
            out["t_peek"] = f.n_frames - 1
            if carry_state:
                out["state"] = f.state_dict()
        return out
