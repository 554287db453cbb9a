"""The port's micro-batcher (vqvaehmm_tpu_torch.serve.batching) on the CPU,
case by case after tests/test_batching.py, and held against the JAX
package's server on the same checkpoint.

torch's CPU convolutions round a row differently at some batch sizes
(oneDNN's, and the plain ones from B=16 on), so on the CPU a batched row
is held to the solo row within 1e-6.  On the card kernel A makes every
row bit-equal to the solo row (tests/test_torch_cuda.py)."""

import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.torch_port import free_port, post_json, write_serving_config

KEYS = ("mu", "logvar", "regime_probs")


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return write_serving_config(tmp_path_factory.mktemp("torch_batching"),
                                seed=5)


@pytest.fixture(scope="module")
def model(cfg_path):
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    return InferenceModel(cfg_path, device="cpu")


def _batcher(model, **kw):
    from vqvaehmm_tpu_torch.serve.batching import BatchingModel

    return BatchingModel(model, **kw)


def _equal(a, b, atol=1e-6):
    for key in KEYS:
        np.testing.assert_allclose(np.array(a[key]), np.array(b[key]),
                                   rtol=0, atol=atol, err_msg=key)


def test_batched_equals_solo(model):
    """A row served out of a coalesced batch equals the solo result."""
    # the linger ends when max_batch requests wait: one dispatch for sure
    b = _batcher(model, max_batch=4, max_wait_ms=5000.0)
    try:
        rng = np.random.default_rng(0)
        xs = [rng.normal(size=(5, T)).tolist() for T in (17, 23, 29, 31)]
        solo = [model.infer(x) for x in xs]
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            batched = list(ex.map(b.infer, xs))
        assert b.dispatches == 1
        for s, r in zip(solo, batched):
            _equal(s, r)
    finally:
        b.close()


def test_burst_coalesces_into_fewer_dispatches(model):
    b = _batcher(model, max_batch=16, max_wait_ms=5000.0)
    try:
        rng = np.random.default_rng(1)
        xs = [rng.normal(size=(5, 20 + i % 5)).tolist() for i in range(16)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
            results = list(ex.map(b.infer, xs))
        assert b.requests == 16
        assert b.dispatches == 1, (b.dispatches, b.requests)
        for x, r in zip(xs, results):
            _equal(r, model.infer(x))
    finally:
        b.close()


def _spy_forward(model, monkeypatch):
    """Record the shape of every batch model._forward gets."""
    seen = []
    orig = model._forward

    def spy(batch, lengths):
        seen.append(batch.shape)
        return orig(batch, lengths)

    monkeypatch.setattr(model, "_forward", spy)
    return seen


def test_mixed_buckets_group_separately(model, monkeypatch):
    """Requests of different padding buckets never share a dispatch and
    all get their own result."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(5, T)).tolist() for T in (10, 50, 12, 60)]
    solo = [model.infer(x) for x in xs]
    b = _batcher(model, max_batch=8, max_wait_ms=100.0)
    seen = _spy_forward(model, monkeypatch)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            out = list(ex.map(b.infer, xs))
        for s, r in zip(solo, out):
            _equal(s, r)
        assert {shape[2] for shape in seen} == {32, 64}
        assert b.dispatches == len(seen) >= 2
    finally:
        b.close()


def test_bad_request_raises_without_wedging(model):
    """A shape error reaches its caller; an overflowing row gets its own
    ValueError (a 400) while its batch-mates are served; the dispatcher
    keeps serving afterwards."""
    b = _batcher(model, max_batch=3, max_wait_ms=5000.0)
    try:
        with pytest.raises(ValueError):
            b.infer([[1.0, 2.0]])  # C=1, not 5
        good = np.random.default_rng(3).normal(size=(5, 15)).tolist()
        bad = [[-3e38] * 15] * 5  # finite, but the forward overflows

        def call(x):
            try:
                return b.infer(x)
            except ValueError as e:
                return e

        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
            res = list(ex.map(call, [good, bad, good]))
        assert isinstance(res[1], ValueError), res[1]
        assert "non-finite" in str(res[1])
        for r in (res[0], res[2]):
            assert np.array(r["regime_probs"]).shape == (3, 15)
        assert b.dispatches == 1
        b.reconfigure(max_batch=3, max_wait_ms=1.0)
        out = b.infer(good)
        assert np.array(out["regime_probs"]).shape == (3, 15)
    finally:
        b.close()


def test_failed_dispatch_fails_its_group_once(model, monkeypatch):
    """A forward that raises inside a dispatch reaches every caller of the
    group, and the group is not computed again another way."""
    b = _batcher(model, max_batch=4, max_wait_ms=5000.0)
    calls = []

    def broken(batch, lengths):
        calls.append(batch.shape[0])
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(model, "_forward", broken)
    try:
        x = np.zeros((5, 20)).tolist()

        def call(_):
            try:
                return b.infer(x)
            except RuntimeError as e:
                return e

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            res = list(ex.map(call, range(4)))
        assert all(isinstance(r, RuntimeError)
                   and "kernel launch failed" in str(r) for r in res), res
        assert calls == [4] and b.dispatches == 0, calls
    finally:
        b.close()


def test_non_mean_field_modes_pass_through(model):
    b = _batcher(model, max_batch=4, max_wait_ms=5.0)
    try:
        rng = np.random.default_rng(4)
        x = rng.normal(size=(5, 18)).tolist()
        u = rng.normal(size=(4, 18)).tolist()
        for mode in ("smoothed", "filtered", "viterbi"):
            out = b.infer(x, u=u, mode=mode)
            assert out == model.infer(x, u=u, mode=mode)
        assert b.requests == 0
        w = b.predict(x)
        np.testing.assert_allclose(np.array(w["weights"]).sum(), 1.0,
                                   atol=1e-5)
        out = b.stream("s", x_t=[0.0] * 5, u_t=[0.0] * 4)
        assert out["new_session"] is True
    finally:
        b.close()


def test_httpd_serves_with_batching(cfg_path):
    from vqvaehmm_tpu_torch.serve.app import InferenceModel, get_model
    from vqvaehmm_tpu_torch.serve.httpd import serve

    get_model.cache_clear()
    port = free_port()
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  batch=True, max_wait_ms=10.0, warmup_lengths=(),
                  device="cpu")
    try:
        x = np.random.default_rng(5).normal(size=(5, 21)).tolist()
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            results = list(ex.map(lambda _: post_json(
                f"http://127.0.0.1:{port}/infer", {"x": x}), range(8)))
        want = InferenceModel(cfg_path, device="cpu").infer(x)
        for status, out, _ in results:
            assert status == 200
            _equal(out, want)
        assert httpd.vqhmm_model.dispatches < 8
        # a burst past socketserver's backlog of 5 would wait out a 1 s
        # SYN retransmit
        assert httpd.request_queue_size >= 16
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.vqhmm_model.close()
        get_model.cache_clear()


def test_close_rejects_and_drains(model):
    """close() fails queued work (not hung) and rejects new requests."""
    b = _batcher(model, max_batch=4, max_wait_ms=2000.0)
    errors = []

    def queued():
        try:
            b.infer(np.zeros((5, 10)).tolist())
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=queued)
    t.start()
    for _ in range(1000):
        with b._lock:
            if b._queue:
                break
        time.sleep(0.001)
    b.close()
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(errors) == 1 and "shut down" in str(errors[0])
    with pytest.raises(RuntimeError, match="shut down"):
        b.infer(np.zeros((5, 10)).tolist())


def test_warmup_launches_each_bucket_at_one_and_max_batch(model,
                                                          monkeypatch):
    """No ladder padding: warmup runs B=1 and B=max_batch (10, no rung)
    in each bucket."""
    b = _batcher(model, max_batch=10, max_wait_ms=1.0)
    seen = _spy_forward(model, monkeypatch)
    try:
        b.warmup([20, 40], exact_modes=False)
        assert sorted(seen) == [(1, 5, 32), (1, 5, 64), (10, 5, 32),
                                (10, 5, 64)], seen
    finally:
        b.close()


def test_env_knob_batches_all_surfaces(cfg_path, monkeypatch):
    """VQHMM_BATCH=1 makes get_model's handle micro-batch."""
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.batching import BatchingModel

    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_WARMUP_LENGTHS", "")
    monkeypatch.setenv("VQHMM_MAX_BATCH", "4")
    get_model.cache_clear()
    m = get_model(cfg_path, "cpu")
    try:
        assert m.is_batching and isinstance(m._inner, BatchingModel)
        assert m._inner.max_batch == 4
        x = np.random.default_rng(7).normal(size=(5, 13)).tolist()
        assert np.array(m.infer(x)["regime_probs"]).shape == (3, 13)
        assert m.dispatches == 1
    finally:
        m.close()
        get_model.cache_clear()


def test_warmup_covers_solo_exact_and_stream_paths(model, monkeypatch):
    b = _batcher(model, max_batch=4, max_wait_ms=1.0)
    seen = _spy_forward(model, monkeypatch)
    counts = {"exact": 0, "step": 0}
    for name in ("smoothed_posterior", "filtered_posterior",
                 "viterbi_decode"):
        fn = getattr(model.model, name)

        def exact(*a, _fn=fn, **k):
            counts["exact"] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(model.model, name, exact)
    step = model._streams._step_fn

    def counted_step(*a):
        counts["step"] += 1
        return step(*a)

    monkeypatch.setattr(model._streams, "_step_fn", counted_step)
    try:
        b.warmup([20])
        assert sorted(seen) == [(1, 5, 32), (4, 5, 32)], seen
        assert counts == {"exact": 3, "step": 1}, counts
        b.warmup([20], exact_modes=False)
        assert counts == {"exact": 3, "step": 1}, counts
    finally:
        b.close()


def test_batching_model_is_true_drop_in(model):
    """Everything BatchingModel does not override is the wrapped model's
    (the gradio callback reads m.cfg, m.model, m.device)."""
    bm = _batcher(model)
    try:
        assert bm.cfg is model.cfg and bm.model is model.model
        assert bm.checkpoint_loaded == model.checkpoint_loaded
        with torch.inference_mode():
            q = bm.model.posterior(torch.zeros(1, 5, 32))
        assert q.shape == (1, 3, 32)
    finally:
        bm.close()


def test_infer_after_close_raises(model):
    bm = _batcher(model)
    bm.close()
    assert bm.stopped
    with pytest.raises(RuntimeError, match="shut down"):
        bm.infer([[0.0] * 32 for _ in range(5)])


def test_max_queue_sheds_load(model):
    from vqvaehmm_tpu_torch.serve.batching import ServerBusy

    x = [[0.0] * 16 for _ in range(5)]
    bm = _batcher(model, max_batch=8, max_wait_ms=500.0, max_queue=1)
    try:
        bm.infer(x)  # max_queue=1 admits solo requests
        t = threading.Thread(target=bm.infer, args=(x,))
        t.start()
        for _ in range(1000):  # until it is queued
            with bm._lock:
                if bm._queue:
                    break
            time.sleep(0.001)
        with pytest.raises(ServerBusy, match="queue full"):
            bm.infer(x)
        t.join(timeout=30)
        assert not t.is_alive()
        bm.infer(x)  # a drained queue admits requests again
    finally:
        bm.close()


def test_max_queue_maps_to_503_with_retry_after(cfg_path):
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.httpd import serve

    get_model.cache_clear()
    port = free_port()
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  batch=True, warmup_lengths=(), max_queue=0, device="cpu")
    try:
        status, body, headers = post_json(
            f"http://127.0.0.1:{port}/infer", {"x": [[0.0] * 16] * 5})
        assert status == 503 and "queue full" in body["detail"]
        assert headers.get("Retry-After") == "1"
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.vqhmm_model.close()
        get_model.cache_clear()


def test_high_rtt_startup_warning(model, monkeypatch, capsys):
    monkeypatch.setenv("VQHMM_RTT_WARN_MS", "0")
    b = _batcher(model, max_batch=4, max_wait_ms=1.0)
    try:
        assert "does not look co-located" in capsys.readouterr().err
    finally:
        b.close()
    monkeypatch.setenv("VQHMM_RTT_WARN_MS", "1000")
    b2 = _batcher(model, max_batch=4, max_wait_ms=1.0)
    try:
        assert "co-located" not in capsys.readouterr().err
    finally:
        b2.close()


def test_pipeline_depth_plumbed(model, monkeypatch):
    b = _batcher(model, max_batch=4, max_wait_ms=1.0, pipeline_depth=3)
    try:
        assert b._pool._max_workers == 3
    finally:
        b.close()
    from vqvaehmm_tpu_torch.serve.app import _env_batch_opts

    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_PIPELINE_DEPTH", "4")
    monkeypatch.setenv("VQHMM_MAX_QUEUE", "7")
    opts = _env_batch_opts()
    assert opts["pipeline_depth"] == 4 and opts["max_queue"] == 7


def test_batched_infer_matches_jax(cfg_path, model):
    """Rows of one coalesced dispatch against the JAX server's answers on
    the same checkpoint: q within 1e-5, mu and logvar within 1e-4."""
    from vqvaehmm_tpu.serve.app import InferenceModel as JaxModel

    jm = JaxModel(cfg_path)
    b = _batcher(model, max_batch=5, max_wait_ms=5000.0)
    try:
        rng = np.random.default_rng(9)
        xs = [rng.normal(size=(5, T)).tolist() for T in (7, 20, 32, 25, 3)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=5) as ex:
            got = list(ex.map(b.infer, xs))
        assert b.dispatches == 1
        for x, g in zip(xs, got):
            want = jm.infer(x)
            for key, tol in (("regime_probs", 1e-5), ("mu", 1e-4),
                             ("logvar", 1e-4)):
                np.testing.assert_allclose(np.array(g[key]),
                                           np.array(want[key]), rtol=0,
                                           atol=tol, err_msg=key)
    finally:
        b.close()
