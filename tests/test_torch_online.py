"""The port's streaming filter (vqvaehmm_tpu_torch.models.online) on the
CPU, case by case after tests/test_online.py: streamed columns equal the
port's batch filtered posterior, and the port's filter and carried state
match the JAX package's."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.torch_port import (free_port, model_pair, post_json,
                              write_serving_config)


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = model_pair(seed=0)
    rng = np.random.default_rng(0)
    T = 23
    x = rng.normal(size=(5, T)).astype(np.float32)
    u = rng.normal(size=(4, T)).astype(np.float32)
    return tm, x, u, (jm, params)


def _batch_filtered(model, x, u, T=None):
    T = x.shape[1] if T is None else T
    with torch.inference_mode():
        q = model.filtered_posterior(torch.from_numpy(x[None, :, :T]),
                                     torch.from_numpy(u[None, :, :T]),
                                     torch.tensor([T], dtype=torch.int32))
    return q[0].numpy()  # (K, T)


def _stream(f, x, u, T=None):
    T = x.shape[1] if T is None else T
    got = {}
    for t in range(T):
        got.update(dict(f.update(x[:, t], u[:, t])))
    got.update(dict(f.finish()))
    return got


def test_stream_matches_batch_filtered(setup):
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import OnlineFilter

    T = x.shape[1]
    batch = _batch_filtered(model, x, u)
    f = OnlineFilter(model)
    got = {}
    for t in range(T):
        for s, q in f.update(x[:, t], u[:, t]):
            got[s] = q
        # settled frames lag the stream by exactly 2
        assert max(got) == t - 2 if t >= 2 else not got
    for s, q in f.finish():
        got[s] = q
    assert sorted(got) == list(range(T))
    for s in range(T):
        np.testing.assert_allclose(got[s], batch[:, s], rtol=0, atol=1e-5,
                                   err_msg=f"column {s}")


def test_peek_matches_truncated_batch(setup):
    """peek after n frames equals the last column of the batch filtered
    posterior over exactly those n frames."""
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import OnlineFilter

    f = OnlineFilter(model)
    for n in range(1, 9):
        f.update(x[:, n - 1], u[:, n - 1])
        ref = _batch_filtered(model, x, u, T=n)[:, n - 1]
        np.testing.assert_allclose(f.peek(), ref, rtol=0, atol=1e-5,
                                   err_msg=f"n={n}")


def test_short_streams_and_reset(setup):
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import OnlineFilter

    for T in (1, 2, 3):
        f = OnlineFilter(model)
        got = _stream(f, x, u, T)
        batch = _batch_filtered(model, x, u, T=T)
        assert sorted(got) == list(range(T))
        for s in range(T):
            np.testing.assert_allclose(got[s], batch[:, s], rtol=0,
                                       atol=1e-5)
        with pytest.raises(RuntimeError):
            f.update(x[:, 0], u[:, 0])
        f.reset()
        f.update(x[:, 0], u[:, 0])  # reusable after reset


def test_stream_manager_sessions(setup):
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import StreamManager

    mgr = StreamManager(model)
    for t in range(6):  # two interleaved sessions stay independent
        a = mgr.update("a", x[:, t], u[:, t])
        b = mgr.update("b", x[:, 5 - t], u[:, 5 - t])
        assert "peek" in a and "peek" in b
    out_a = mgr.update("a", x[:, 6], u[:, 6], finish=True)
    assert [d["t"] for d in out_a["settled"]] == [4, 5, 6]
    assert "a" not in mgr._sessions and "b" in mgr._sessions


def test_http_stream_endpoint(tmp_path):
    """/stream over a real socket; the settled columns equal the batch
    filtered posterior, and the sessions gauge counts the open session."""
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.httpd import (ThreadingHTTPServer,
                                                _make_handler)
    from vqvaehmm_tpu_torch.serve.metrics import METRICS

    model = InferenceModel(write_serving_config(tmp_path, seed=3),
                           device="cpu")
    port = free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(model))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        rng = np.random.default_rng(3)
        T = 9
        x = rng.normal(size=(5, T)).astype(np.float32)
        u = rng.normal(size=(4, T)).astype(np.float32)
        got = {}
        for t in range(T):
            status, out, _ = post_json(
                f"http://127.0.0.1:{port}/stream",
                {"session": "s1", "x_t": x[:, t].tolist(),
                 "u_t": u[:, t].tolist(), "finish": t == T - 1})
            assert status == 200
            for d in out["settled"]:
                got[d["t"]] = np.array(d["regime_probs"])
            if t < T - 1:
                assert out["t_peek"] == t and len(out["peek"]) == 3
            if t == 1:
                assert "vqhmm_stream_sessions 1" in METRICS.render()
        batch = _batch_filtered(model.model, x, u)
        assert sorted(got) == list(range(T))
        for s_ in range(T):
            np.testing.assert_allclose(got[s_], batch[:, s_], rtol=0,
                                       atol=1e-5)
        status, out, _ = post_json(f"http://127.0.0.1:{port}/stream",
                                   {"session": "s2", "x_t": [1.0] * 4})
        assert status == 400 and "x_t" in out["detail"]
        status, _, _ = post_json(f"http://127.0.0.1:{port}/stream",
                                 {"session": "s2", "x_t": [1.0] * 5,
                                  "u_t": [float("nan")] * 4})
        assert status == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_frame_buffer_stays_bounded(setup):
    model, _, _, _ = setup
    from vqvaehmm_tpu_torch.models.online import OnlineFilter

    rng = np.random.default_rng(11)
    f = OnlineFilter(model)
    for _ in range(60):
        f.update(rng.normal(size=5), rng.normal(size=4))
    assert len(f._x) <= OnlineFilter.W + 2, len(f._x)
    assert f.n_frames == 60


def test_sessions_share_one_step_fn_and_expire(setup):
    model, _, _, _ = setup
    from vqvaehmm_tpu_torch.models.online import StreamManager

    rng = np.random.default_rng(13)
    mgr = StreamManager(model, ttl_seconds=300.0)
    mgr.update("a", rng.normal(size=5), rng.normal(size=4))
    mgr.update("b", rng.normal(size=5), rng.normal(size=4))
    assert mgr._sessions["a"]._step is mgr._sessions["b"]._step \
        is mgr._step_fn

    short = StreamManager(model, ttl_seconds=0.05)
    short.update("a", rng.normal(size=5), rng.normal(size=4))
    time.sleep(0.1)
    short.update("c", rng.normal(size=5), rng.normal(size=4))
    assert "a" not in short._sessions and "c" in short._sessions
    assert short.n_sessions() == 1


def test_session_export_import_continues_identically(setup):
    """A session exported from one manager and imported into another
    continues with the settled outputs of an uninterrupted stream."""
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import OnlineFilter, StreamManager

    T = x.shape[1]
    got_ref = _stream(OnlineFilter(model), x, u)
    a = StreamManager(model)
    for t in range(9):
        a.update("s", x[:, t], u[:, t])
    blob = json.loads(json.dumps(a.export_session("s")))  # JSON transport
    assert "s" not in a._sessions
    b = StreamManager(model)
    b.import_session("s", blob)
    got = {}
    for t in range(9, T):
        out = b.update("s", x[:, t], u[:, t], finish=t == T - 1)
        for d in out["settled"]:
            got[d["t"]] = np.array(d["regime_probs"])
    for s_ in got:
        np.testing.assert_array_equal(got[s_], got_ref[s_],
                                      err_msg=f"column {s_}")
    assert max(got) == T - 1


def test_client_carried_state_across_workers(setup):
    """A client that echoes its carried state while alternating between
    two managers gets the settled columns of a single-manager run."""
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import StreamManager

    T = x.shape[1]
    solo = StreamManager(model)
    ref_rows = []
    for t in range(T):
        ref_rows += solo.update("s", x[:, t], u[:, t],
                                finish=(t == T - 1))["settled"]
    workers = [StreamManager(model), StreamManager(model)]
    rows, carried = [], None
    for t in range(T):
        out = workers[t % 2].update("s", x[:, t], u[:, t],
                                    finish=(t == T - 1), state=carried,
                                    carry_state=True)
        rows += out["settled"]
        carried = out.get("state")
        if t > 0:
            assert out["resumed"] is True and out["new_session"] is False
    assert [r["t"] for r in rows] == [r["t"] for r in ref_rows]
    for a, b in zip(rows, ref_rows):
        np.testing.assert_array_equal(a["regime_probs"], b["regime_probs"])

    # a stale local session must not shadow the newer carried state
    wA, wB = StreamManager(model), StreamManager(model)
    o1 = wA.update("r", x[:, 0], u[:, 0], carry_state=True)
    o2 = wB.update("r", x[:, 1], u[:, 1], state=o1["state"],
                   carry_state=True)
    o3 = wA.update("r", x[:, 2], u[:, 2], state=o2["state"],
                   carry_state=True)
    assert o3["resumed"] is True and o3["t_peek"] == 2


def test_replacement_serializes_and_stale_finish_is_isolated(setup):
    """Replacing a session reuses its lock, and a finish computed on a
    filter replaced meanwhile does not deregister the newer one."""
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import StreamManager

    w = StreamManager(model)
    o1 = w.update("s", x[:, 0], u[:, 0], carry_state=True)
    lock_before = w._session_locks["s"]
    w.update("s", x[:, 1], u[:, 1], state=o1["state"], carry_state=True)
    assert w._session_locks["s"] is lock_before

    stale = w._sessions["s"]
    w.update("s", x[:, 2], u[:, 2], state=o1["state"], carry_state=True)
    newer = w._sessions["s"]
    assert newer is not stale
    w._update_locked(stale, "s", x[:, 3], u[:, 3], finish=True,
                     carry_state=False, new_session=False, resumed=False)
    assert w._sessions.get("s") is newer
    w.update("s", None, None, finish=True)
    assert "s" not in w._sessions and "s" not in w._session_locks


def test_new_session_flag(setup):
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import StreamManager

    m = StreamManager(model, ttl_seconds=0.0)  # instant expiry
    out1 = m.update("a", x[:, 0], u[:, 0])
    assert out1["new_session"] is True and out1["resumed"] is False
    time.sleep(0.01)
    assert m.update("a", x[:, 1], u[:, 1])["new_session"] is True
    o = StreamManager(model).update("b", x[:, 0], u[:, 0], carry_state=True)
    assert o["new_session"] is True
    o2 = StreamManager(model).update("b", x[:, 1], u[:, 1],
                                     state=o["state"])
    assert o2["new_session"] is False and o2["resumed"] is True
    assert o2["t_peek"] == 1


def test_sessions_do_not_serialize_behind_one_lock(setup):
    """With one session's lock held, another session's update completes."""
    model, x, u, _ = setup
    from vqvaehmm_tpu_torch.models.online import StreamManager

    m = StreamManager(model)
    m.update("a", x[:, 0], u[:, 0])
    m.update("b", x[:, 0], u[:, 0])
    with m._session_locks["a"]:
        done = threading.Event()
        result = {}

        def drive_b():
            result["out"] = m.update("b", x[:, 1], u[:, 1])
            done.set()

        th = threading.Thread(target=drive_b)
        th.start()
        ok = done.wait(timeout=30.0)
        th.join(timeout=5.0)
    assert ok, "session b blocked behind session a's lock"
    assert result["out"]["t_peek"] == 1


def test_export_race_raises_instead_of_stale_snapshot(setup):
    """A session replaced while export_session waits on its lock makes the
    export raise, not hand out a stale snapshot."""
    from vqvaehmm_tpu_torch.models.online import OnlineFilter, StreamManager

    model, x, u, _ = setup
    mgr = StreamManager(model)
    mgr.update("s", x[:, 0], u[:, 0])
    f2 = OnlineFilter(model, step_fn=mgr._step_fn)

    class ReplacedWhileWaiting:
        def __init__(self):
            self._inner = threading.Lock()

        def __enter__(self):
            with mgr._lock:
                mgr._sessions["s"] = f2
            return self._inner.__enter__()

        def __exit__(self, *exc):
            return self._inner.__exit__(*exc)

    mgr._session_locks["s"] = ReplacedWhileWaiting()
    with pytest.raises(ValueError, match="replaced or closed"):
        mgr.export_session("s")
    assert mgr._sessions["s"] is f2


def test_update_losing_to_export_raises_not_ghost(setup):
    """An update that loses its session to a concurrent export raises
    SessionConflict instead of resurrecting an empty filter."""
    from vqvaehmm_tpu_torch.models.online import SessionConflict, StreamManager

    model, x, u, _ = setup
    mgr = StreamManager(model)
    mgr.update("s", x[:, 0], u[:, 0])

    class ExportsWhileWaiting:
        def __init__(self, inner):
            self._inner = inner
            self.armed = True

        def __enter__(self):
            if self.armed:
                self.armed = False
                mgr.export_session("s")
            return self._inner.__enter__()

        def __exit__(self, *exc):
            return self._inner.__exit__(*exc)

    mgr._session_locks["s"] = ExportsWhileWaiting(mgr._session_locks["s"])
    with pytest.raises(SessionConflict, match="exported or finished"):
        mgr.update("s", x[:, 1], u[:, 1])
    assert "s" not in mgr._sessions


def test_import_session_replacement_semantics(setup):
    from vqvaehmm_tpu_torch.models.online import StreamManager

    model, x, u, _ = setup
    mgr = StreamManager(model, max_sessions=1)
    mgr.update("s", x[:, 0], u[:, 0])
    lock_before = mgr._session_locks["s"]
    blob = mgr._sessions["s"].state_dict()
    mgr.import_session("s", blob)  # at the cap: a replacement
    assert mgr._session_locks["s"] is lock_before
    with pytest.raises(ValueError, match="too many"):
        mgr.import_session("t", blob)


def test_online_filter_matches_jax(setup):
    """The port's filter against the JAX package's on one stream: every
    settled column and peek within 1e-5, and the same state format."""
    from vqvaehmm_tpu.models.online import OnlineFilter as JaxFilter
    from vqvaehmm_tpu_torch.models.online import OnlineFilter

    model, x, u, (jm, params) = setup
    f, jf = OnlineFilter(model), JaxFilter(jm, params)
    for t in range(x.shape[1]):
        got, want = f.update(x[:, t], u[:, t]), jf.update(x[:, t], u[:, t])
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
        if t % 5 == 0:
            np.testing.assert_allclose(f.peek(), np.asarray(jf.peek()),
                                       rtol=0, atol=1e-5)
    assert set(f.state_dict()) == set(jf.state_dict())
    for (s, a), (s2, b) in zip(f.finish(), jf.finish()):
        assert s == s2
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_state_exported_by_jax_continues_in_port(setup):
    """A session state exported by the JAX package's StreamManager, sent
    as JSON, continues in the port's within 1e-5 of the JAX stream."""
    from vqvaehmm_tpu.models.online import StreamManager as JaxManager
    from vqvaehmm_tpu_torch.models.online import StreamManager

    model, x, u, (jm, params) = setup
    T = x.shape[1]
    jmgr = JaxManager(jm, params)
    for t in range(11):
        jmgr.update("s", x[:, t], u[:, t])
    blob = json.loads(json.dumps(jmgr.export_session("s")))
    jmgr.import_session("s", blob)
    mgr = StreamManager(model)
    mgr.import_session("s", blob)
    for t in range(11, T):
        got = mgr.update("s", x[:, t], u[:, t], finish=t == T - 1)
        want = jmgr.update("s", x[:, t], u[:, t], finish=t == T - 1)
        assert [d["t"] for d in got["settled"]] \
            == [d["t"] for d in want["settled"]]
        for a, b in zip(got["settled"], want["settled"]):
            np.testing.assert_allclose(a["regime_probs"],
                                       b["regime_probs"], rtol=0,
                                       atol=1e-5)
        if "peek" in want:
            np.testing.assert_allclose(got["peek"], want["peek"], rtol=0,
                                       atol=1e-5)
