"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip elsewhere.  The machine with the
card has no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.ops.fused_infer import (SMEM_LIMIT, fused_forward,
                                                fused_forward_reference)
from vqvaehmm_tpu_torch.ops.fused_viterbi import (viterbi_fused,
                                                  viterbi_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, seed=0, **kw):
    cfg = dict(input_dim=5, hidden_dim=16, K=3, hidden_dim2=8, u_dim=4,
               trans_hidden=8)
    cfg.update(kw)
    return VAEHMM(ModelConfig(**cfg), device=dev,
                  generator=torch.Generator().manual_seed(seed)).eval()


@pytest.mark.parametrize("B,T", [(1, 1), (3, 37), (5, 64), (2, 200)])
def test_fused_forward_matches_plain(cuda, B, T):
    model = _model(cuda, hidden_dim=64, hidden_dim2=32)
    rng = np.random.default_rng(B * 1000 + T)
    x = torch.from_numpy(rng.normal(size=(B, 5, T)).astype(np.float32)
                         ).to(cuda)
    lens = torch.from_numpy(rng.integers(1, T + 1, size=B)
                            .astype(np.int32)).to(cuda)
    before = fused_forward.launches
    with torch.inference_mode():
        for vt in (None, max(1, T - 3), lens):
            got = fused_forward(model, x, valid_to=vt)
            want = fused_forward_reference(model, x, valid_to=vt)
            for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-5)):
                torch.testing.assert_close(g, w, rtol=0, atol=tol)
    assert fused_forward.launches == before + 3


def test_fused_forward_rows_independent(cuda):
    model = _model(cuda, seed=1)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(6, 5, 130)).astype(np.float32)
                         ).to(cuda)
    vt = torch.tensor([130, 5, 64, 65, 1, 129], dtype=torch.int32,
                      device=cuda)
    with torch.inference_mode():
        batched = fused_forward(model, x, valid_to=vt)
        for i in range(6):
            solo = fused_forward(model, x[i:i + 1], valid_to=vt[i:i + 1])
            for g, s in zip(batched, solo):
                assert torch.equal(g[i:i + 1], s)


def test_fused_forward_shared_memory_bound(cuda):
    model = _model(cuda, hidden_dim=1024, hidden_dim2=8)
    x = torch.zeros((1, 5, 8), device=cuda)
    with pytest.raises(ValueError, match=str(SMEM_LIMIT)):
        fused_forward(model, x)


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("B,T", [(1, 1), (4, 129), (33, 300)])
def test_viterbi_matches_plain(cuda, K, B, T):
    rng = np.random.default_rng(K * 100 + T)
    log_pi = torch.log_softmax(torch.randn(K, generator=torch.Generator()
                                           .manual_seed(K)), 0).to(cuda)
    log_A = torch.from_numpy(np.log(rng.dirichlet(np.ones(K),
                                                  size=(B, T, K)))
                             .astype(np.float32)).to(cuda)
    log_obs = torch.from_numpy((2 * rng.normal(size=(B, T, K)))
                               .astype(np.float32)).to(cuda)
    lens = torch.from_numpy(rng.integers(1, T + 1, size=B)
                            .astype(np.int32)).to(cuda)
    for la in (log_A, log_A[0], log_A[0, 0]):
        for ln in (None, lens):
            got = viterbi_fused(log_pi, la, log_obs, ln)
            want = viterbi_reference(log_pi, la, log_obs, ln)
            assert torch.equal(got.states, want.states)
            torch.testing.assert_close(got.score, want.score, rtol=1e-6,
                                       atol=0)


def test_viterbi_rejects_large_K(cuda):
    K = 9
    with pytest.raises(ValueError, match="K"):
        viterbi_fused(torch.zeros(K, device=cuda),
                      torch.zeros((K, K), device=cuda),
                      torch.zeros((1, 4, K), device=cuda))


def test_model_paths_launch_kernels(cuda):
    model = _model(cuda, seed=2)
    x = torch.randn((2, 5, 50), device=cuda)
    u = torch.randn((2, 4, 50), device=cuda)
    lengths = torch.tensor([50, 31], device=cuda)
    a, b = fused_forward.launches, viterbi_fused.launches
    with torch.inference_mode():
        model.infer_forward(x, valid_to=lengths)
        states = model.viterbi_decode(x, u, lengths)
        plain = model.viterbi_decode(x, u, lengths, use_kernel=False)
    assert (fused_forward.launches, viterbi_fused.launches) == (a + 1, b + 1)
    assert torch.equal(states, plain)


def test_launch_counters_under_threads(cuda):
    """The launch counters are shared by the server's handler threads: no
    launch may be lost under contention."""
    model = _model(cuda, seed=3)
    x = torch.randn((1, 5, 40), device=cuda)
    log_pi = torch.log_softmax(torch.randn(3, device=cuda), 0)
    log_A = torch.log_softmax(torch.randn((3, 3), device=cuda), -1)
    log_obs = torch.randn((1, 40, 3), device=cuda)
    a, b = fused_forward.launches, viterbi_fused.launches

    def work():
        with torch.inference_mode():
            for _ in range(25):
                fused_forward(model, x)
                viterbi_fused(log_pi, log_A, log_obs)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert fused_forward.launches - a == 16 * 25
    assert viterbi_fused.launches - b == 16 * 25


def _train_inputs(dev, B, T, seed, C=5, U=4, short=None, btu=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(B, U, T)).astype(np.float32))
    if btu:
        u = u.transpose(1, 2).contiguous()
    lens = rng.integers(max(1, T // 3), T + 1, size=B).astype(np.int32)
    lens[0] = T
    if short is not None:
        lens = np.minimum(lens, short)
    return x.to(dev), u.to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("B,T,beta,short,btu", [
    (1, 1, 1.0, None, False), (3, 37, 0.7, None, False),
    (8, 200, 1.0, 150, False), (5, 64, 0.3, None, True)])
def test_fused_train_matches_plain(cuda, B, T, beta, short, btu):
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_grads, fused_loss_and_grads_reference)

    model = _model(cuda, seed=4, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128)
    x, u, lens = _train_inputs(cuda, B, T, B * 7 + T, short=short, btu=btu)
    before = fused_loss_and_grads.launches
    loss, grads = fused_loss_and_grads(model, x, u, lens, beta)
    want_loss, want = fused_loss_and_grads_reference(model, x, u, lens, beta)
    torch.cuda.synchronize()
    assert fused_loss_and_grads.launches == before + 1
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    # the same inputs give the same bits
    loss2, grads2 = fused_loss_and_grads(model, x, u, lens, beta)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)


def test_fused_elbo_backward_fills_grad(cuda):
    from vqvaehmm_tpu_torch.ops.fused_train import FusedELBO

    model = _model(cuda, seed=5)
    x, u, lens = _train_inputs(cuda, 4, 50, 9)
    params = [p for _, p in model.named_parameters()]
    loss = FusedELBO.apply(model, x, u, lens, 0.5, *params)
    loss.backward()
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    model.compute_loss(x, u, lens, 0.5).backward()
    for n, p in model.named_parameters():
        assert float((got[n] - p.grad).abs().max()) <= \
            1e-4 * float(p.grad.abs().max()), n


def test_fused_train_gate_refuses_large_K(cuda):
    from vqvaehmm_tpu_torch.ops.fused_train import (KMAX,
                                                    fused_loss_and_grads,
                                                    train_step_supported)

    model = _model(cuda, K=KMAX + 1)
    assert not train_step_supported(model.cfg, 2, 16)
    x, u, lens = _train_inputs(cuda, 2, 16, 1)
    with pytest.raises(ValueError, match="unsupported"):
        fused_loss_and_grads(model, x, u, lens, 1.0)


@pytest.mark.parametrize("B,T", [(1, 1), (16, 48), (64, 200)])
def test_gather_matches_plain(cuda, B, T):
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_windows,
                                               gather_windows_reference)

    rng = np.random.default_rng(B + T)
    lens = rng.integers(T, 3 * T + 1, size=6)
    xs = [rng.normal(size=(5, n)).astype(np.float32) for n in lens]
    us = [rng.normal(size=(4, n)).astype(np.float32) for n in lens]
    px, pu = (torch.from_numpy(a).to(cuda) for a in build_pools(xs, us))
    si = rng.integers(0, 6, size=B)
    ln = rng.integers(1, T + 1, size=B)
    ln[0] = T
    st = rng.integers(0, lens[si] - ln + 1)
    st[-1] = lens[si[-1]] - ln[-1]            # a window at the very end
    idx = [torch.from_numpy(a.astype(np.int32)).to(cuda)
           for a in (si, st, ln)]
    before = gather_windows.launches
    got = gather_windows(px, pu, *idx, T)
    want = gather_windows_reference(px, pu, *idx, T)
    torch.cuda.synchronize()
    assert gather_windows.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
