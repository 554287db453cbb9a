"""The frozen operation and byte counts, and the mfu and roofline
arithmetic, against counts made by hand."""

import types

import pytest
import torch

from portbench.harness import counts, tracing
from portbench.harness.core import Context
from portbench.reference.vaehmm import Dims

SMALL = Dims(C=2, U=1, H1=4, H2=3, K=2, HP=5)
PUBLISHED = Dims(C=5, U=4, H1=64, H2=32, K=3, HP=128)


def test_token_flops_by_hand():
    # enc 2 (3*2*4 + 3*4*3 + 3*2), prior 2 (1*5 + 5*4),
    # dec 2 (2*4 + 3*16 + 3*16 + 4*4)
    assert counts.token_flops(SMALL) == (132, 50, 240)
    assert counts.token_flops(PUBLISHED) == (14400, 3328, 50816)


def test_weight_bytes_by_hand():
    # encoder 28 + 39 + 8, prior 2 + 10 + 24, decoder 8 + 52 + 52 + 20
    assert counts.weight_bytes(SMALL, "encoder.") == 4 * 75
    assert counts.weight_bytes(SMALL, "prior.") == 4 * 36
    assert counts.weight_bytes(SMALL) == 4 * 243
    # the weights at two bytes (66 values), the biases at four (9)
    assert counts.weight_bytes(SMALL, "encoder.", bf16=True) == 132 + 36


@pytest.mark.parametrize("work, want", [
    (counts.train_work, (3 * 10 * 422, 4 * 10 * 3 + 12 + 2 * 972 + 4)),
    (counts.encode_work, (10 * 132, 4 * 10 * 4 + 12 + 300)),
    (counts.evidence_work, (10 * 206, 4 * 10 * 9 + 12 + 300 + 144)),
    (counts.viterbi_work, (7 * 10, 4 * 10 * 7 + 24 + 8)),
])
def test_kernel_work_by_hand(work, want):
    # three rows holding ten valid steps in all
    assert work(SMALL, 3, 10) == want


def test_gather_work_by_hand():
    # 4 windows of T = 6, 9 valid steps: triples, reads, writes
    assert counts.gather_work(SMALL, 6, 4, 9) == (0, 48 + 12 * (24 + 9))


def test_bound_takes_the_larger_side():
    assert counts.bound_s(67e12, 0.0, 67e12) == (1.0, "operations")
    assert counts.bound_s(0.0, 3.35e12, 67e12) == (1.0, "bytes")
    assert counts.bound_s(67e12, 6.7e12, 67e12) == (2.0, "bytes")


def _ctx(peak="fp32", **window):
    return Context(torch, torch.device("cpu"), 0, {}, {"peak": peak}, {},
                   {"route": []}, window=window)


def test_mfu_arithmetic(small):
    ctx = _ctx(flops=6.7e12, seconds=2.0)
    for name in ("train_mfu", "score_mfu"):
        assert small.reader(name).read(ctx) == pytest.approx(5.0)
    assert small.reader("train_mfu").read(
        _ctx("bf16", flops=989e12, seconds=1.0)) == pytest.approx(100.0)
    assert small.reader("train_mfu").read(_ctx()) is None


def test_roofline_arithmetic(small):
    # two steps of kernel C, 10 and 20 valid steps, 1 ms each on the device
    lengths = torch.tensor([[4, 6], [10, 10]])
    kernels = [("void ns::train_forward_kernel<64>(Dims)", 0.0, 1e-3),
               ("void ns::train_forward_kernel<64>(Dims)", 2e-3, 3e-3),
               ("adam", 3e-3, 4e-3)]
    sl = tracing.Slice(kernels, [], 0.0, 4e-3,
                       {"lengths": [lengths], "B": 2})
    model = {"input_dim": 2, "u_dim": 1, "hidden_dim": 4, "hidden_dim2": 3,
             "K": 2, "trans_hidden": 5}
    ctx = Context(torch, torch.device("cpu"), 0, {}, {"peak": "fp32",
                                                      "model": model}, {},
                  {"route": [{"counter": "ops.fused_train:fused_loss_and_"
                              "grads.launches",
                              "kernels": ["train_forward_kernel"]}]},
                  slice=sl)
    least = sum(counts.bound_s(*counts.train_work(SMALL, 2, s), 67e12)[0]
                for s in (10, 20))
    got = small.reader("fused_train_roofline").read(ctx)
    assert got == pytest.approx(100.0 * least / 2e-3)
    assert small.reader("device_idle.train").read(ctx) == pytest.approx(25.0)
    opt = small.reader("optimizer_ms.train").read(ctx)
    assert opt == pytest.approx(1e3 * 1e-3 / 2)


def test_slice_idle_gaps_name_the_host_span():
    sl = tracing.Slice([("k", 1.0, 2.0), ("k", 4.0, 5.0)],
                       [("pb:draw", 0.0, 1.0), ("pb:epoch", 2.0, 4.5)],
                       0.0, 6.0)
    assert sl.busy_s() == 2.0
    assert dict(sl.idle_gaps()) == {"pb:draw": 1.0, "pb:epoch": 2.0,
                                    "host:other": 1.0}
    assert tracing.short_name("void (anonymous namespace)::viterbi_kernel"
                              "<3>(float const*)") == "viterbi_kernel"
