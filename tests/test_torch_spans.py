"""The port's host spans and counters (vqvaehmm_tpu_torch/utils/profiling.py)
on the CPU: nothing recorded while off, what a profile or `recording()`
records, parents, roots and self times, the exact spans of an epoch and
of a scoring request, the counted sites (a device wait faked where the
CPU has none), the bounded buffer, `spans.jsonl` from
training.profile_dir, the rule by which the benchmark's
`sampler_wait_ms.train` reads the spans, and one test on the card (an epoch under a profile
of the card's activity alone, as the benchmark's slices run).  Runs
without JAX: `python -m pytest --noconftest tests/test_torch_spans.py`
on the card."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqvaehmm_tpu_torch.core.config import ModelConfig, apply_overrides
from vqvaehmm_tpu_torch.core.config import load_config
from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM
from vqvaehmm_tpu_torch.ops import _build, fused_encoder, fused_train
from vqvaehmm_tpu_torch.train import trainer
from vqvaehmm_tpu_torch.train.trainer import make_optimizer
from vqvaehmm_tpu_torch.utils import profiling
from vqvaehmm_tpu_torch.utils.profiling import (counts, recording, span,
                                                spans_between)

CFG = dict(input_dim=5, hidden_dim=8, hidden_dim2=4, K=3, u_dim=4,
           trans_hidden=8)

EPOCH_SPANS = [
    ("sampler.draw", None), ("sampler.sample", "sampler.draw"),
    ("sampler.check", "sampler.draw"), ("sampler.upload", "sampler.draw"),
    ("train.epoch", None), ("gather.launch", "train.epoch"),
] + 2 * [
    ("train.step", "train.epoch"), ("train.loss_grads", "train.step"),
    ("model.encode", "train.loss_grads"), ("train.clip", "train.step"),
    ("train.adam", "train.step"),
]
REQUEST_SPANS = [
    ("score.posterior", None), ("model.encode", "score.posterior"),
    ("score.viterbi_decode", None),
    ("model.evidence", "score.viterbi_decode"),
    ("model.encode", "model.evidence"),
    ("hmm.viterbi", "score.viterbi_decode"),
]


def _sampler(device="cpu"):
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(5, 60)).astype(np.float32) for _ in range(4)]
    us = [rng.normal(size=(4, 60)).astype(np.float32) for _ in range(4)]
    ds = RandomChunkDataset(xs, us, 10, 24, samples_per_epoch=8, seed=0)
    return DeviceEpochSampler(ds, device)


def _model(device="cpu"):
    torch.manual_seed(0)
    return VAEHMM(ModelConfig(**CFG), device=device)


def _epoch(device="cpu"):
    """One 2-batch epoch through make_epoch_step: its draw, then its
    steps; returns the mean loss."""
    sampler, model = _sampler(device), _model(device)
    step = sampler.make_epoch_step(model, make_optimizer(model, 1e-3, 1.0),
                                   fused=True)
    return step(*sampler.draw_epoch(4, 2), 1.0)


def _request():
    """One scoring request: posterior and viterbi_decode of a book."""
    model = _model().eval()
    g = torch.Generator().manual_seed(1)
    x, u = torch.randn(3, 5, 30, generator=g), torch.randn(3, 4, 30,
                                                           generator=g)
    lengths = torch.tensor([30, 20, 10], dtype=torch.int32)
    with torch.inference_mode():
        return model.posterior(x), model.viterbi_decode(x, u, lengths)


WORK = {"epoch": _epoch, "request": _request}


def _recorded(fn):
    """The spans fn records inside recording(), as (name, parent's name)."""
    with recording():
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
    got = spans_between(t0, t1)
    names = {s.index: s.name for s in got}
    return [(s.name, names.get(s.parent)) for s in got], got


@pytest.mark.parametrize("work", sorted(WORK))
def test_nothing_recorded_when_off(work):
    assert not torch._C._autograd._profiler_enabled()
    before = list(profiling._buffer)
    WORK[work]()
    assert list(profiling._buffer) == before
    # the off path is one shared object: nothing is made a call
    assert span("a") is span("b") is profiling._OFF
    assert profiling.host_sync("cpu") is profiling._OFF


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_spans_recorded_under_a_profile_or_recording(how):
    t0 = time.perf_counter()
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            _request()
    else:
        with recording():
            _request()
    got = spans_between(t0, time.perf_counter())
    assert [s.name for s in got] == [n for n, _ in REQUEST_SPANS]
    assert all(s.end >= s.start >= t0 for s in got)


def test_parents_roots_and_self_times():
    with recording():
        t0 = time.perf_counter()
        with span("a"):
            with span("b"):
                with span("c"):
                    time.sleep(0.002)
            time.sleep(0.002)
            with span("d"):
                pass
        with span("e"):
            pass
        t1 = time.perf_counter()
    a, b, c, d, e = spans_between(t0, t1)
    assert [s.name for s in (a, b, c, d, e)] == list("abcde")
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.index, b.index, a.index, None)
    assert {a.root, b.root, c.root, d.root} == {a.index}
    assert e.root == e.index != a.index
    assert a.self_s == pytest.approx(a.duration_s - b.duration_s
                                     - d.duration_s, abs=1e-12)
    assert b.self_s == pytest.approx(b.duration_s - c.duration_s, abs=1e-12)
    assert c.self_s == c.duration_s and a.self_s >= 0.0019


@pytest.mark.parametrize("work,want", [("epoch", EPOCH_SPANS),
                                       ("request", REQUEST_SPANS)])
def test_exact_spans(work, want):
    pairs, got = _recorded(WORK[work])
    assert pairs == want
    # each top-level span is its own root and its children's
    by_index = {s.index: s for s in got}
    for s in got:
        top = s
        while top.parent is not None:
            top = by_index[top.parent]
        assert s.root == top.index


def test_counters_only_rise_and_sampler_waits_counted(monkeypatch):
    """A faked device wait: each of an epoch's three uploads is a
    host.sync inside sampler.upload, counted."""
    monkeypatch.setattr(profiling, "waits_on", lambda device: True)
    before = {n: getattr(counts, n) for n in counts.NAMES}
    pairs, _ = _recorded(lambda: _sampler().draw_epoch(4, 2))
    assert counts.host_syncs - before["host_syncs"] == 3
    assert pairs[3:] == [("sampler.upload", "sampler.draw")] + 3 * [
        ("host.sync", "sampler.upload")]
    profiling.clear_spans()
    assert all(getattr(counts, n) >= v for n, v in before.items())


class _Stream:
    def synchronize(self):
        pass


def _fake_pack(monkeypatch):
    """KernelCache.weights on the CPU: the pack kernel and the stream's
    synchronise stubbed."""
    monkeypatch.setattr(fused_encoder, "_pack", lambda *a: torch.zeros(4))
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())


class _Mesh:
    """A world of one for shard_norm: all-reduces leave their tensor."""
    size = 1

    def all_reduce_(self, t, op=None):
        return t


@pytest.mark.parametrize("site,waits", [
    ("global_norms", 1), ("shard_norm", 2), ("kernel_cache_pack", 1)])
def test_host_sync_sites_counted(monkeypatch, site, waits):
    monkeypatch.setattr(profiling, "waits_on", lambda device: True)
    lengths = torch.tensor([[5, 7], [3, 9]], dtype=torch.int32)
    if site == "kernel_cache_pack":
        model = _model()
        _fake_pack(monkeypatch)
    before = counts.host_syncs
    pairs, _ = _recorded({
        "global_norms": lambda: fused_train.global_norms(lengths, 8),
        "shard_norm": lambda: trainer.shard_norm(_Mesh(), lengths[0], 8),
        "kernel_cache_pack": lambda: fused_encoder.KernelCache().weights(
            model, torch.device("cpu")),
    }[site])
    assert counts.host_syncs - before == waits
    assert [n for n, _ in pairs].count("host.sync") == waits


def test_packs_made_on_a_weight_change_only(monkeypatch):
    _fake_pack(monkeypatch)
    model, cache, cpu = _model(), fused_encoder.KernelCache(), \
        torch.device("cpu")
    before = counts.packs_made
    cache.weights(model, cpu)
    cache.weights(model, cpu)                   # kept: no pack
    assert counts.packs_made - before == 1
    with torch.no_grad():
        model.encoder.conv1.weight.add_(1.0)    # a new version
    pairs, _ = _recorded(lambda: cache.weights(model, cpu))
    assert counts.packs_made - before == 2
    assert pairs == [("cache.pack", None)]


class _Lib:
    """The library's size queries, answered from the wrappers' plans."""

    def __init__(self, cfg):
        self.cfg = cfg

    def vqhmm_fused_train_sizes(self, B, C, T, *rest):
        what = rest[-2]
        plan = fused_train.train_plan(self.cfg, B, T, 132)
        return [fused_train.param_count(self.cfg), plan.scratch_rows,
                plan.smem_fwd, plan.smem_bwd, plan.wg_tiles,
                plan.packed][what]


@pytest.mark.parametrize("cache", ["kernel_cache", "train_plans"])
def test_plans_made_on_a_new_shape_only(monkeypatch, cache):
    cfg = ModelConfig(**CFG)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "library", lambda: _Lib(cfg))
    monkeypatch.setattr(fused_train, "_plans", {})
    kc = fused_encoder.KernelCache()
    dims = fused_encoder.encoder_dims(cfg, prior=True)

    def plan(B, T):
        if cache == "kernel_cache":
            return kc.plan("decode", dims, B, T, torch.device("cpu"))
        return fused_train._checked_plan(_Lib(cfg), cfg, B, T, 132)

    before = counts.plans_made
    pairs, _ = _recorded(lambda: plan(8, 64))
    assert pairs == [("cache.plan", None)]
    plan(8, 64)
    assert counts.plans_made - before == 1
    plan(16, 64)
    assert counts.plans_made - before == 2


def test_full_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_BUFFER", 5)
    profiling.clear_spans()
    before = counts.dropped_spans
    with recording():
        t0 = time.perf_counter()
        for i in range(8):
            with span(f"s{i}"):
                pass
    assert counts.dropped_spans - before == 3
    assert [s.name for s in spans_between(t0, time.perf_counter())] == [
        f"s{i}" for i in range(3, 8)]
    profiling.clear_spans()


def test_sampler_wait_is_the_idle_clipped_to_the_draw():
    """portbench's `sampler_wait_ms.train` counts the device's idle time
    inside each `sampler.draw` span: a gap that closes after the draw
    counts only its part inside it, so the reading is at most the draw."""
    import types

    from portbench.harness import program_spans
    from portbench.harness.tracing import Slice

    with recording():
        t0 = time.perf_counter()
        with span("sampler.draw"):
            time.sleep(0.02)
        t1 = time.perf_counter()
    draw, = [s for s in spans_between(t0, t1) if s.name == "sampler.draw"]
    a, d = draw.start, draw.end - draw.start
    # busy until a quarter into the draw, from a half to three quarters,
    # and from 2 ms after it: idle inside it is half the draw, and the
    # last gap's middle lies inside it
    kernels = [("k", t0 - 0.01, a + d / 4), ("k", a + d / 2, a + 3 * d / 4),
               ("k", draw.end + 0.002, t1 + 0.01)]
    sl = Slice(kernels, [], t0 - 0.01, t1 + 0.02,
               {"lengths": [torch.zeros(4)]})
    ctx = types.SimpleNamespace(slice=sl)
    assert program_spans.idle_ms(ctx, "sampler.draw", "epoch") == \
        pytest.approx(1e3 * d / 2)
    assert program_spans.total_ms(ctx, "sampler.draw", "epoch") == \
        pytest.approx(1e3 * d)
    assert program_spans.idle_ms(ctx, "train.epoch", "epoch") is None

def test_threads_nest_their_own_spans_and_lose_no_count():
    """More threads than cores record nested spans and count at once,
    with a short switch interval: each span's parent is on its own
    thread, and neither the buffer nor a counter loses an update."""
    import sys
    import threading

    n_threads, n_spans = 16, 200
    profiling.clear_spans()
    before = counts.plans_made

    def work():
        for _ in range(n_spans):
            with span("outer"):
                with span("inner"):
                    counts.add("plans_made")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording():
            t0 = time.perf_counter()
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            t1 = time.perf_counter()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = spans_between(t0, t1)
    assert len(got) == 2 * n_threads * n_spans
    assert counts.plans_made - before == n_threads * n_spans
    by_index = {s.index: s for s in got}
    for s in got:
        if s.name == "inner":
            outer = by_index[s.parent]
            assert outer.name == "outer" and outer.thread == s.thread
            assert outer.start <= s.start <= s.end <= outer.end
        else:
            assert s.parent is None and s.root == s.index
    profiling.clear_spans()


def test_profile_dir_writes_spans(tmp_path):
    from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    xs, us, _ = synthetic_sequences(4, 120, 5, 4, 3, seed=0)
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "u.npy", us)
    cfg = {"model": CFG,
           "data": {"x_sequences_path": str(tmp_path / "x.npy"),
                    "u_sequences_path": str(tmp_path / "u.npy"),
                    "min_len": 16, "max_len": 48, "samples_per_epoch": 16},
           "training": {"epochs": 2, "lr": 1e-3, "batch_size": 8,
                        "checkpoint_dir": str(tmp_path / "ck"), "seed": 1}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    conf = apply_overrides(load_config(str(tmp_path / "cfg.json")),
                           [f"training.profile_dir={tmp_path / 'p'}"])
    TrainPipeline(conf, device="cpu").train(log_fn=None)
    lines = (tmp_path / "p" / "spans.jsonl").read_text().splitlines()
    got = [json.loads(line) for line in lines]
    names = [s["name"] for s in got]
    assert names.count("train.epoch") == 1
    assert names.count("train.step") == 2            # 16 samples of 8
    assert {"index", "start", "end", "parent", "root",
            "self_s"} <= set(got[0])


def test_counters_are_metrics_gauges():
    from vqvaehmm_tpu_torch.serve.app import bind_count_gauges
    from vqvaehmm_tpu_torch.serve.metrics import METRICS

    bind_count_gauges()
    counts.add("packs_made")
    text = METRICS.render()
    lines = text.splitlines()
    for name in counts.NAMES:
        assert f"vqhmm_{name} {getattr(counts, name)}" in lines


@pytest.mark.cuda
def test_card_only_profile_records_an_epoch():
    """The benchmark's slices profile the card's activity alone; the
    program's spans must record under such a profile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    _epoch(dev)                                 # build and warm
    torch.cuda.synchronize()
    before = counts.host_syncs
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch._C._autograd._profiler_enabled()
        _epoch(dev)
        torch.cuda.synchronize()
    names = [s.name for s in spans_between(t0, time.perf_counter())]
    assert names.count("sampler.draw") == 1 and names.count("train.epoch") \
        == 1 and names.count("train.step") == 2
    assert names.count("host.sync") == counts.host_syncs - before >= 3
