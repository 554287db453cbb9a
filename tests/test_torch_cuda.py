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


# ---------------------------------------------------------------------------
# The bulk-scoring slice: encoder, evidence and one-kernel decode
# ---------------------------------------------------------------------------


def _path_scores(log_pi, log_A, log_obs, states, lengths):
    """log p(z, x) of each row's path over its valid steps."""
    s = states.long()
    B, T = s.shape
    rows = torch.arange(B, device=s.device)
    valid = torch.arange(T, device=s.device)[None, :] < lengths[:, None]
    score = log_pi[s[:, 0]] + log_obs[rows, 0, s[:, 0]] * valid[:, 0]
    for t in range(1, T):
        step = log_A[rows, t, s[:, t - 1], s[:, t]] + log_obs[rows, t, s[:, t]]
        score = score + torch.where(valid[:, t], step, torch.zeros_like(step))
    return score


@pytest.mark.parametrize("B,T", [(1, 1), (3, 37), (5, 64), (460, 20),
                                 (1, 2327)])
def test_fused_encode_matches_plain(cuda, B, T):
    from vqvaehmm_tpu_torch.ops.fused_encoder import (fused_encode,
                                                      fused_encode_reference)

    model = _model(cuda, hidden_dim=64, hidden_dim2=32)
    rng = np.random.default_rng(B * 1000 + T)
    x = torch.from_numpy(rng.normal(size=(B, 5, T)).astype(np.float32)
                         ).to(cuda)
    lens = torch.from_numpy(rng.integers(1, T + 1, size=B)
                            .astype(np.int32)).to(cuda)
    before = fused_encode.launches
    with torch.inference_mode():
        for vt in (None, max(1, T - 3), lens):
            got = fused_encode(model, x, valid_to=vt)
            want = fused_encode_reference(model, x, valid_to=vt)
            # float32 on both sides, different summation orders
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
            assert torch.equal(got, model.encode(x, valid_to=vt))
        assert torch.equal(model.posterior(x),
                           torch.softmax(fused_encode(model, x), dim=1))
    # per case: the wrapper and model.encode; then posterior and the wrapper
    assert fused_encode.launches == before + 8


def test_fused_encode_rows_independent(cuda):
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    model = _model(cuda, seed=1)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(6, 5, 130)).astype(np.float32)
                         ).to(cuda)
    vt = torch.tensor([130, 5, 64, 65, 1, 129], dtype=torch.int32,
                      device=cuda)
    with torch.inference_mode():
        batched = fused_encode(model, x, valid_to=vt)
        for i in range(6):
            solo = fused_encode(model, x[i:i + 1], valid_to=vt[i:i + 1])
            assert torch.equal(batched[i:i + 1], solo)


@pytest.mark.parametrize("B,T,btu,ragged", [
    (1, 1, False, False), (3, 37, False, True), (5, 64, True, True),
    (2, 200, True, False), (1, 2327, False, False)])
def test_fused_evidence_and_decode_match_plain(cuda, B, T, btu, ragged):
    from vqvaehmm_tpu_torch.ops.fused_decode import (
        fused_evidence, fused_evidence_reference, fused_viterbi_states,
        fused_viterbi_states_reference)

    model = _model(cuda, seed=6, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128)
    x, u, lens = _train_inputs(cuda, B, T, B * 11 + T, btu=btu)
    if not ragged:
        lens = None
    a, b = fused_evidence.launches, fused_viterbi_states.launches
    with torch.inference_mode():
        got = fused_evidence(model, x, u, lens)
        want = fused_evidence_reference(model, x, u, lens)
        for g, w, name in zip(got, want, ("log_pi", "log_A", "log_obs")):
            assert g.shape == w.shape and g.is_contiguous(), name
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=name)
        states = fused_viterbi_states(model, x, u, lens)
        plain = fused_viterbi_states_reference(model, x, u, lens)
        two_stage = viterbi_fused(*got, lens).states
    assert (fused_evidence.launches, fused_viterbi_states.launches) == \
        (a + 1, b + 1)
    assert states.dtype == torch.int32 and states.shape == (B, T)
    # the one-kernel decode computes the evidence kernel's bits
    assert torch.equal(states, two_stage)
    full = torch.full((B,), T, device=cuda) if lens is None else lens.long()
    if not torch.equal(states, plain):
        # a tie to float rounding: the path must score as the optimum, to
        # 1e-4 absolute or 32 float32 roundings of the score, the larger
        # (about 1e-2 at T=2327, well under one wrong state's cost)
        sg = _path_scores(*want, states, full).double()
        sw = _path_scores(*want, plain, full).double()
        tol = torch.clamp(32 * torch.finfo(torch.float32).eps * sw.abs(),
                          min=1e-4)
        assert bool(((sg - sw).abs() <= tol).all()), (sg, sw)
    # frozen tails past each length
    for i in range(B):
        L = int(full[i])
        assert bool((states[i, L:] == states[i, L - 1]).all())


def test_bulk_kernels_gates_raise(cuda):
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states,
                                                     supported)
    from vqvaehmm_tpu_torch.ops.fused_encoder import (encode_supported,
                                                      fused_encode)

    wide = _model(cuda, hidden_dim=2048, hidden_dim2=8)
    x = torch.zeros((1, 5, 8), device=cuda)
    u = torch.zeros((1, 4, 8), device=cuda)
    assert not encode_supported(wide.cfg, 1, 8)
    many = _model(cuda, K=9)
    assert not supported(many.cfg, 1, 8)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="unsupported"):
            fused_encode(wide, x)
        for fn in (fused_evidence, fused_viterbi_states):
            with pytest.raises(ValueError, match="unsupported"):
                fn(many, x, u)
        with pytest.raises(TypeError, match="float32"):
            fused_encode(_model(cuda), x.double())


def test_inference_kernels_refuse_autograd(cuda):
    """With grad mode on and weights that require grad, the paths that
    would hand back a detached tensor raise instead; they launch under
    no_grad, with frozen weights, and the plain version stays
    differentiable."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    model = _model(cuda, seed=3)
    x, u, lens = _train_inputs(cuda, 2, 40, 9)
    before = (fused_encode.launches, fused_evidence.launches)
    calls = (lambda: model.posterior(x), lambda: model.encode(x),
             lambda: fused_encode(model, x),
             lambda: fused_evidence(model, x, u, lens),
             lambda: model.smoothed_posterior(x, u, lens),
             lambda: model.filtered_posterior(x, u, lens),
             lambda: model.viterbi_decode(x, u, lens))
    for call in calls:
        with pytest.raises(RuntimeError, match="fused=False"):
            call()
    assert (fused_encode.launches, fused_evidence.launches) == before
    assert model.posterior(x, fused=False).requires_grad
    with torch.no_grad():
        for call in calls:
            call()
    for p in model.parameters():
        p.requires_grad_(False)
    for call in calls:
        call()
    with pytest.raises(RuntimeError, match="fused=False"):
        model.posterior(x.clone().requires_grad_(True))
    assert (fused_encode.launches, fused_evidence.launches) == \
        (before[0] + 6, before[1] + 8)


def test_bulk_kernels_refuse_cpu_tensors():
    """use_kernel=True on a CPU tensor raises: no CUDA kernel runs there and
    none gives way to its plain version."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    model = _model("cpu")
    x, u = torch.zeros((1, 5, 8)), torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_encode(model, x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        model.encode(x, fused=True)
    for fn in (fused_evidence, fused_viterbi_states):
        with pytest.raises(ValueError, match="CUDA"):
            fn(model, x, u, use_kernel=True)


def test_exact_modes_take_kernel_evidence(cuda):
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    model = _model(cuda, seed=2)
    x = torch.randn((2, 5, 50), device=cuda)
    u = torch.randn((2, 4, 50), device=cuda)
    lengths = torch.tensor([50, 31], device=cuda)
    n = fused_evidence.launches
    with torch.inference_mode():
        for fn in (model.smoothed_posterior, model.filtered_posterior):
            got = fn(x, u, lengths)
            want = fn(x, u, lengths, use_kernel=False)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        model.viterbi_decode(x, u, lengths)
    assert fused_evidence.launches == n + 3


def test_plain_versions_launch_no_kernel(cuda):
    """What the kernels are held against stays plain PyTorch on the card:
    no reference, and no differentiable path of the model, reaches a
    hand-written kernel."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (
        fused_evidence, fused_evidence_reference, fused_viterbi_states,
        fused_viterbi_states_reference)
    from vqvaehmm_tpu_torch.ops.fused_encoder import (fused_encode,
                                                      fused_encode_reference)
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_windows

    wrappers = (fused_forward, viterbi_fused, fused_encode, fused_evidence,
                fused_viterbi_states, fused_loss_and_grads, gather_windows)
    model = _model(cuda, seed=8)
    x, u, lens = _train_inputs(cuda, 3, 40, 5)
    before = [w.launches for w in wrappers]
    fused_forward_reference(model, x, valid_to=lens)
    fused_encode_reference(model, x, valid_to=lens)
    fused_evidence_reference(model, x, u, lens)
    fused_viterbi_states_reference(model, x, u, lens)
    model.compute_loss(x, u, lens, 0.5).backward()
    (mu, _), _ = model(x)
    assert mu.requires_grad
    for fn in (model.smoothed_posterior, model.filtered_posterior,
               model.viterbi_decode):
        fn(x, u, lens, use_kernel=False)
    model.posterior(x, fused=False)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before


def _near_tie(z, cb, got, want):
    """Every token whose two indices differ has the two codes' plain
    float64 scores within 32 float32 roundings of the score, or 1e-6."""
    bad = (got != want).reshape(-1)
    if not bad.any():
        return True
    zf = z.reshape(-1, z.shape[-1])[bad].double()
    s = zf @ cb.double().T - 0.5 * (cb.double() ** 2).sum(-1)
    a = s.gather(1, got.reshape(-1)[bad].long()[:, None])
    b = s.gather(1, want.reshape(-1)[bad].long()[:, None])
    tol = torch.clamp(32 * torch.finfo(torch.float32).eps * b.abs(),
                      min=1e-6)
    return bool(((a - b).abs() <= tol).all())


@pytest.mark.parametrize("B,T,D,M", [(1, 1, 16, 8), (3, 37, 16, 8),
                                     (64, 200, 16, 8), (2, 50, 5, 3),
                                     (4, 33, 64, 40), (1, 2327, 32, 64)])
def test_vq_nearest_matches_plain(cuda, B, T, D, M):
    from vqvaehmm_tpu_torch.ops.vq import vq_nearest, vq_nearest_reference

    rng = np.random.default_rng(B * 1000 + T + D)
    z = torch.from_numpy(rng.normal(size=(B, D, T)).astype(np.float32)
                         ).to(cuda)
    cb = torch.from_numpy((0.5 * rng.normal(size=(M, D))).astype(np.float32)
                          ).to(cuda)
    before = vq_nearest.launches
    zq, idx = vq_nearest(z, cb, channels_first=True)
    _, want = vq_nearest_reference(z, cb, channels_first=True)
    assert idx.dtype == torch.int32 and idx.shape == (B, T)
    assert _near_tie(z.transpose(1, 2), cb, idx, want)
    assert torch.equal(zq, cb[idx.long()].transpose(1, 2))
    flat = z.transpose(1, 2).contiguous()                    # (B, T, D)
    zq2, idx2 = vq_nearest(flat, cb)
    assert torch.equal(idx2, idx) and torch.equal(zq2, cb[idx.long()])
    assert vq_nearest.launches == before + 2


def test_vq_nearest_exact_tie_gate_and_model_path(cuda):
    from vqvaehmm_tpu_torch.models.vqvae_hmm import VQVAEConfig, VQVAEHMM
    from vqvaehmm_tpu_torch.ops.vq import vq_nearest

    rng = np.random.default_rng(11)
    z = torch.from_numpy(rng.normal(size=(500, 16)).astype(np.float32)
                         ).to(cuda)
    cb = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)
                          ).to(cuda)
    cb[5] = cb[2]                      # an exact tie: the lower index wins
    idx = vq_nearest(z, cb)[1]
    assert bool((idx == 2).any()) and not bool((idx == 5).any())
    with pytest.raises(ValueError, match="vq_supported"):
        vq_nearest(z.double(), cb.double())
    with pytest.raises(ValueError, match="use_kernel=False"):
        vq_nearest(torch.zeros((4, 65), device=cuda),
                   torch.zeros((3, 65), device=cuda))
    # the model's loss and codes go through the kernel, once each, and the
    # loss carries gradients to all 13 parameters
    model = VQVAEHMM(VQVAEConfig(), device=cuda,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn((4, 5, 60), device=cuda)
    lengths = torch.tensor([60, 20, 33, 47], device=cuda)
    n = vq_nearest.launches
    parts = model.compute_loss(x, lengths)
    parts.total.backward()
    codes = model.codes(x)
    assert vq_nearest.launches == n + 2
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    plain = model.compute_loss(x, lengths, use_kernel=False)
    assert vq_nearest.launches == n + 2
    torch.testing.assert_close(parts.total, plain.total, rtol=1e-5, atol=0)
    assert torch.equal(parts.counts, plain.counts)
    assert torch.equal(codes, model.codes(x, use_kernel=False))
