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
