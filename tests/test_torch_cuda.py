"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip elsewhere.  The machine with the
card has no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX.
"""

import statistics
import sys
import threading

import numpy as np
import pytest
import torch

from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.ops.fused_infer import (SMEM_LIMIT, fused_forward,
                                                fused_forward_reference)
from vqvaehmm_tpu_torch.ops.fused_viterbi import (
    viterbi_fused, viterbi_reference, viterbi_segmented_reference)

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


@pytest.mark.parametrize("B,T", [(1, 1), (3, 37), (2, 130), (3, 200)])
def test_fused_forward_tile_widths_bit_equal(cuda, B, T):
    """Each output's summation order is fixed, so the kernel gives the same
    bits at each of its tile widths (the wrapper's own launch function;
    it does not count a launch)."""
    from vqvaehmm_tpu_torch.ops import fused_infer

    model = _model(cuda, seed=2, hidden_dim=64, hidden_dim2=32)
    rng = np.random.default_rng(B * 31 + T)
    x = torch.from_numpy(rng.normal(size=(B, 5, T)).astype(np.float32)
                         ).to(cuda)
    vt = torch.from_numpy(rng.integers(1, T + 1, size=B).astype(np.int32)
                          ).to(cuda)
    before = fused_forward.launches
    outs = []
    with torch.inference_mode():
        for tile in fused_infer.TILES:
            out = tuple(torch.empty((B, c, T), device=cuda) for c in (5, 5, 3))
            fused_infer._launch(model, x, vt, tile, out)
            outs.append(out)
        want = fused_forward_reference(model, x, valid_to=vt)
    torch.cuda.synchronize()
    assert fused_forward.launches == before
    for out in outs:
        for g, first, w, tol in zip(out, outs[0], want, (1e-4, 1e-4, 1e-5)):
            assert torch.equal(g, first)
            torch.testing.assert_close(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("widths", [
    dict(input_dim=40, hidden_dim=64, hidden_dim2=32),
    dict(input_dim=5, hidden_dim=8, hidden_dim2=8),
    dict(input_dim=7, hidden_dim=12, hidden_dim2=4, K=5)])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 37), (2, 200)])
def test_fused_forward_more_outputs_than_hidden_rows(cuda, widths, B, T):
    """2 * input_dim above every hidden width: the last layer's 2C rows of
    (mu, logvar) are the widest thing a block holds.  Every tile width
    against the plain version, and bit-equal to the others."""
    from vqvaehmm_tpu_torch.ops import fused_infer

    model = _model(cuda, seed=3, **widths)
    C, K = model.cfg.input_dim, model.cfg.K
    rng = np.random.default_rng(B * 17 + T + C)
    x = torch.from_numpy(rng.normal(size=(B, C, T)).astype(np.float32)
                         ).to(cuda)
    vt = torch.from_numpy(rng.integers(1, T + 1, size=B).astype(np.int32)
                          ).to(cuda)
    with torch.inference_mode():
        want = fused_forward_reference(model, x, valid_to=vt)
        outs = [fused_forward(model, x, valid_to=vt)]
        for tile in fused_infer.TILES:
            out = tuple(torch.empty((B, c, T), device=cuda) for c in (C, C, K))
            fused_infer._launch(model, x, vt, tile, out)
            outs.append(out)
    torch.cuda.synchronize()
    for out in outs:
        for g, first, w, tol in zip(out, outs[0], want, (1e-4, 1e-4, 1e-5)):
            assert torch.equal(g, first)
            torch.testing.assert_close(g, w, rtol=0, atol=tol)


def test_fused_forward_shared_memory_bound(cuda):
    model = _model(cuda, hidden_dim=1024, hidden_dim2=8)
    x = torch.zeros((1, 5, 8), device=cuda)
    # outside autograd: under it the default dispatch takes the plain path
    with torch.no_grad(), pytest.raises(ValueError, match=str(SMEM_LIMIT)):
        fused_forward(model, x)


def _assert_map_path(evidence, got, want, lengths):
    """got.score within 1e-4 absolute or 32 float32 roundings of
    want.score, and got.states equal to want.states or a path that scores
    within that tolerance of want's under the same evidence (a tie)."""
    log_pi, log_A, log_obs = evidence
    B, T, K = log_obs.shape
    log_A = log_A.expand(B, T, K, K)
    full = torch.full((B,), T, device=log_obs.device) if lengths is None \
        else lengths.long()
    tol = torch.clamp(32 * torch.finfo(torch.float32).eps
                      * want.score.double().abs(), min=1e-4)
    assert bool(((got.score.double() - want.score.double()).abs()
                 <= tol).all()), (got.score, want.score)
    if not torch.equal(got.states, want.states):
        sg = _path_scores(log_pi, log_A, log_obs, got.states, full).double()
        sw = _path_scores(log_pi, log_A, log_obs, want.states, full).double()
        assert bool(((sg - sw).abs() <= tol).all()), (sg, sw)


def _viterbi_case(dev, K, B, T):
    rng = np.random.default_rng(K * 100 + T)
    log_pi = torch.log_softmax(torch.randn(K, generator=torch.Generator()
                                           .manual_seed(K)), 0).to(dev)
    log_A = torch.from_numpy(np.log(rng.dirichlet(np.ones(K),
                                                  size=(B, T, K)))
                             .astype(np.float32)).to(dev)
    log_obs = torch.from_numpy((2 * rng.normal(size=(B, T, K)))
                               .astype(np.float32)).to(dev)
    lens = torch.from_numpy(rng.integers(1, T + 1, size=B)
                            .astype(np.int32)).to(dev)
    return log_pi, log_A, log_obs, lens


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("B,T", [(1, 1), (4, 129), (33, 300)])
def test_viterbi_matches_plain(cuda, K, B, T):
    """Kernel B runs the segmented scan: bit-equal to its plain version
    (viterbi_segmented_reference, on the CPU), and against the sequential
    decode the scores agree to float roundings and the states are equal
    or tie; a second call gives the same bits."""
    log_pi, log_A, log_obs, lens = _viterbi_case(cuda, K, B, T)
    for la in (log_A, log_A[0], log_A[0, 0]):
        for ln in (None, lens):
            got = viterbi_fused(log_pi, la, log_obs, ln)
            seg = viterbi_segmented_reference(
                log_pi.cpu(), la.cpu(), log_obs.cpu(),
                None if ln is None else ln.cpu())
            assert torch.equal(got.states.cpu(), seg.states)
            assert torch.equal(got.score.cpu(), seg.score)
            _assert_map_path((log_pi, la, log_obs), got,
                             viterbi_reference(log_pi, la, log_obs, ln), ln)
            again = viterbi_fused(log_pi, la, log_obs, ln)
            assert torch.equal(again.states, got.states)
            assert torch.equal(again.score, got.score)


@pytest.mark.parametrize("B,T,K", [(64, 200, 3), (460, 20, 3),
                                   (3, 2327, 3), (5, 300, 8)])
def test_viterbi_rows_independent(cuda, B, T, K):
    """A row of a batch is bit-equal to the row decoded alone: the
    segments and the fold are functions of T alone, whatever the plan puts
    in a block."""
    log_pi, log_A, log_obs, lens = _viterbi_case(cuda, K, B, T)
    batched = viterbi_fused(log_pi, log_A, log_obs, lens)
    for i in range(B) if B <= 8 else (0, 1, B // 2, B - 1):
        solo = viterbi_fused(log_pi, log_A[i:i + 1], log_obs[i:i + 1],
                             lens[i:i + 1])
        assert torch.equal(batched.states[i:i + 1], solo.states)
        assert torch.equal(batched.score[i:i + 1], solo.score)


@pytest.mark.parametrize("B,T,K", [(2, 1000, 8), (2, 2327, 8), (2, 2327, 3),
                                   (1, 1040, 3), (3, 4654, 3)])
def test_viterbi_rounds_and_fold_chunks(cuda, B, T, K):
    """The plan's rounds and the fold's two levels: a single chunk carried
    across two rounds (K = 8, T = 1000: 63 segments, 35 a round), chunks
    of 8 in rounds of 32 (K = 8, T = 2327) and in one round (K = 3), the
    smallest two-level fold (T = 1040: 65 segments) and two rounds of 208
    (T = 4654): bit-equal to the segmented reference."""
    log_pi, log_A, log_obs, lens = _viterbi_case(cuda, K, B, T)
    got = viterbi_fused(log_pi, log_A, log_obs, lens)
    seg = viterbi_segmented_reference(log_pi.cpu(), log_A.cpu(),
                                      log_obs.cpu(), lens.cpu())
    assert torch.equal(got.states.cpu(), seg.states)
    assert torch.equal(got.score.cpu(), seg.score)


def test_viterbi_refuses_a_plan_over_the_shared_memory_bound(cuda):
    """A sequence keeps 5 bytes of maps and end states a segment in shared
    memory: at K = 8 and T = 200000 the plan needs more than a block has,
    and the wrapper raises before a launch."""
    from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_plan

    K, T = 8, 200000
    assert viterbi_plan(1, T, K, True).smem > SMEM_LIMIT
    before = viterbi_fused.launches
    with pytest.raises(ValueError, match=str(SMEM_LIMIT)):
        viterbi_fused(torch.zeros(K, device=cuda),
                      torch.zeros((K, K), device=cuda),
                      torch.zeros((1, T, K), device=cuda))
    assert viterbi_fused.launches == before


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
        evidence = (*model.prior(u), model._hmm_evidence(x, lengths))
    assert (fused_forward.launches, viterbi_fused.launches) == (a + 1, b + 1)
    # the kernel's scan against the sequential decode: equal, or a tie
    if not torch.equal(states, plain):
        full = lengths.long()
        sg = _path_scores(*evidence, states, full).double()
        sw = _path_scores(*evidence, plain, full).double()
        tol = torch.clamp(32 * torch.finfo(torch.float32).eps * sw.abs(),
                          min=1e-4)
        assert bool(((sg - sw).abs() <= tol).all()), (sg, sw)


def test_launch_counters_under_threads(cuda):
    """The launch counters are shared by the server's handler threads: no
    launch may be lost under contention.  Kernels 8 and 11 of a model not
    yet packed: the threads race to its packed-weight cache and every one
    gets the bits of a call made alone."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    model = _model(cuda, seed=3)
    fresh = _model(cuda, seed=4)
    x = torch.randn((1, 5, 40), device=cuda)
    u = torch.randn((1, 4, 40), device=cuda)
    log_pi = torch.log_softmax(torch.randn(3, device=cuda), 0)
    log_A = torch.log_softmax(torch.randn((3, 3), device=cuda), -1)
    log_obs = torch.randn((1, 40, 3), device=cuda)
    a, b = fused_forward.launches, viterbi_fused.launches
    c, d = fused_encode.launches, fused_evidence.launches
    results = []

    def work():
        with torch.inference_mode():
            results.append((fused_encode(fresh, x),
                            fused_evidence(fresh, x, u)[1]))
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
    assert (fused_encode.launches - c, fused_evidence.launches - d) == \
        (16, 16)
    with torch.inference_mode():
        want = (fused_encode(fresh, x), fused_evidence(fresh, x, u)[1])
    assert len(results) == 16
    for got in results:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("B,T,widths", [
    # a last tile of one step at each tile width; whole tiles past valid_to
    (2, 17, {}), (20, 33, {}), (70, 129, {}),
    # layers of several weight slabs, (mu, logvar) the widest rows
    (2, 37, dict(input_dim=16, hidden_dim=256, hidden_dim2=128, K=8,
                 trans_hidden=256)),
    (3, 40, dict(input_dim=12, hidden_dim=16, hidden_dim2=8, K=2,
                 trans_hidden=20))])
def test_fused_train_tile_edges_and_widths(cuda, B, T, widths):
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_grads, fused_loss_and_grads_reference, train_plan)

    cfg = dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128)
    cfg.update(widths)
    model = _model(cuda, seed=6, **cfg)
    assert train_plan(model.cfg, B, T) is not None
    x, u, lens = _train_inputs(cuda, B, T, B + T, C=model.cfg.input_dim,
                               short=T - T // 4)
    loss, grads = fused_loss_and_grads(model, x, u, lens, 0.5)
    want_loss, want = fused_loss_and_grads_reference(model, x, u, lens, 0.5)
    torch.cuda.synchronize()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    loss2, grads2 = fused_loss_and_grads(model, x, u, lens, 0.5)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)


def test_fused_elbo_backward_fills_grad(cuda):
    from vqvaehmm_tpu_torch.ops.fused_train import FusedELBO

    model = _model(cuda, seed=5)
    x, u, lens = _train_inputs(cuda, 4, 50, 9)
    params = [p for _, p in model.named_parameters()]
    loss = FusedELBO.apply(model, x, u, lens, 0.5, None, *params)
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
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                               gather_windows,
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
    before = gather_epoch.launches
    got = gather_windows(px, pu, *idx, T)
    want = gather_windows_reference(px, pu, *idx, T)
    torch.cuda.synchronize()
    assert gather_epoch.launches == before + 1
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
    (2, 200, True, False), (1, 2327, False, False), (3, 1040, True, True)])
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
        again = fused_viterbi_states(model, x, u, lens)
    assert (fused_evidence.launches, fused_viterbi_states.launches) == \
        (a + 1, b + 2)
    assert states.dtype == torch.int32 and states.shape == (B, T)
    # the one-kernel decode computes the evidence kernel's bits and runs
    # the Viterbi kernel's scan: kernel 11 followed by kernel B, bit for
    # bit; a second call gives the same bits
    assert torch.equal(states, two_stage)
    assert torch.equal(again, states)
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


@pytest.mark.parametrize("B,T", [(8, 200), (6, 2327), (160, 20)])
def test_fused_decode_rows_independent(cuda, B, T):
    """A row of a batched one-kernel decode is bit-equal to the row decoded
    alone (no lengths: the encoder's bound max(lengths) is the batch's),
    however the plan spreads the tiles over the persistent blocks."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (decode_plan,
                                                     fused_viterbi_states)

    model = _model(cuda, seed=7, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128)
    x, u, _ = _train_inputs(cuda, B, T, B * 3 + T)
    with torch.inference_mode():
        batched = fused_viterbi_states(model, x, u)
        for i in (0, 1, B - 1):
            solo = fused_viterbi_states(model, x[i:i + 1], u[i:i + 1])
            assert torch.equal(batched[i:i + 1], solo)
    plan = decode_plan(model, B, T, cuda)
    assert plan.grid * plan.ntb >= B * -(-T // plan.tile)


def test_fused_decode_refuses_a_grid_it_cannot_keep_resident(cuda):
    """The decode keeps every tile of the batch in shared memory of
    resident blocks: past that the wrapper raises before a launch."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_viterbi_states

    model = _model(cuda, K=8)
    x = torch.zeros((256, 5, 2000), device=cuda)
    u = torch.zeros((256, 4, 2000), device=cuda)
    before = fused_viterbi_states.launches
    with torch.inference_mode():
        with pytest.raises(ValueError, match="resident"):
            fused_viterbi_states(model, x, u)
    assert fused_viterbi_states.launches == before


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


@pytest.mark.parametrize("widths", [
    dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128),
    dict(hidden_dim=8, hidden_dim2=32, K=5, trans_hidden=8),
    dict(hidden_dim=16, hidden_dim2=8, K=8, trans_hidden=256)])
@pytest.mark.parametrize("B,T,btu", [(1, 1, False), (3, 37, True),
                                     (2, 200, False), (1, 300, True)])
def test_encoder_and_evidence_tile_widths_bit_equal(cuda, widths, B, T, btu):
    """Kernels 8 and 11 at every tile width the plan can choose, and kernel
    11 split and not, give the same bits (each output's FMA chain is
    fixed), within 1e-5 of the plain versions: the published widths, H2
    above H1, and HP and K * K above both hidden widths.  The wrappers'
    own launch functions; they do not count a launch."""
    from vqvaehmm_tpu_torch.ops import fused_decode as fd
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe

    model = _model(cuda, seed=4, **widths)
    K = model.cfg.K
    x, u, lens = _train_inputs(cuda, B, T, B * 13 + T, btu=btu,
                               short=max(1, T - 3))
    counts = (fe.fused_encode.launches, fd.fused_evidence.launches)
    with torch.inference_mode():
        want_lg = fe.fused_encode_reference(model, x, valid_to=lens)
        want_ev = fd.fused_evidence_reference(model, x, u, lens)
        logits, evidence = [], []
        for tile in fe.TILES:
            out = torch.empty((B, K, T), device=cuda)
            fe._launch(model, x, lens.to(torch.int32), tile, out)
            logits.append(out)
            for split in (False, True):
                ev = (torch.empty((B, T, K), device=cuda),
                      torch.empty((B, T, K, K), device=cuda))
                fd._launch_evidence(model, x, u, lens, tile, split, ev)
                evidence.append(ev)
    torch.cuda.synchronize()
    assert (fe.fused_encode.launches, fd.fused_evidence.launches) == counts
    for out in logits:
        assert torch.equal(out, logits[0])
        torch.testing.assert_close(out, want_lg, rtol=0, atol=1e-5)
    for log_obs, log_A in evidence:
        assert torch.equal(log_obs, evidence[0][0])
        assert torch.equal(log_A, evidence[0][1])
        torch.testing.assert_close(log_A, want_ev[1], rtol=0, atol=1e-5)
        torch.testing.assert_close(log_obs, want_ev[2], rtol=0, atol=1e-5)


def test_fused_evidence_rows_independent(cuda):
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    model = _model(cuda, seed=5, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128)
    for B, T in ((6, 130), (160, 64)):      # split and not
        x, u, _ = _train_inputs(cuda, B, T, B + T)
        with torch.inference_mode():
            _, log_A, log_obs = fused_evidence(model, x, u)
            for i in (0, 1, B - 1):
                _, a, o = fused_evidence(model, x[i:i + 1], u[i:i + 1])
                assert torch.equal(log_A[i:i + 1], a)
                assert torch.equal(log_obs[i:i + 1], o)


def _inert_steps(lens, B, T, tile):
    """(B, T) bool: the steps of the tiles that start at or past their
    row's length (none without lengths)."""
    if lens is None:
        return torch.zeros((B, T), dtype=torch.bool)
    start = torch.arange(T, device=lens.device) // tile * tile
    return start[None, :] >= lens.long()[:, None]


@pytest.mark.parametrize("mode", ["float32", "bf16", "bf16_staged"])
@pytest.mark.parametrize("B,T", [(3, 37), (4, 200), (2, 2327)])
def test_fused_evidence_leaves_tiles_past_the_length_inert(cuda, mode, B,
                                                           T):
    """Kernel 11 with `inert`, in each of its three kernels (float32, the
    bfloat16-operand mode's first design and its staged one), split and
    not, at every tile width: each step of a tile that starts before its
    row's length is bit-equal to the launch without the flag, each step of
    a tile that starts at or past it holds exactly 0 and the identity;
    lengths None, all T, ragged with a row of length 1."""
    from vqvaehmm_tpu_torch.ops import fused_decode as fd
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe

    bf16 = mode != "float32"
    model = _model(cuda, seed=23, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128, **(DEFAULT if bf16 else {}))
    K = model.cfg.K
    x, u, lens = _train_inputs(cuda, B, T, B * 17 + T, btu=T == 200)
    lens[-1] = 1
    full = torch.full((B,), T, dtype=torch.int32, device=cuda)
    eye = torch.full((K, K), float("-inf"), device=cuda)
    eye.fill_diagonal_(0.0)
    counts = fd.fused_evidence.launches, fd.fused_evidence.inert_launches
    inert_seen = 0
    with torch.inference_mode():
        for tile in fe.TILES:
            for split in (False, True):
                for L in (None, full, lens):
                    outs = []
                    for inert in (False, True):
                        ev = (torch.empty((B, T, K), device=cuda),
                              torch.empty((B, T, K, K), device=cuda))
                        fd._launch_evidence(model, x, u, L, tile, split, ev,
                                            bf16=bf16,
                                            staged=mode == "bf16_staged",
                                            inert=inert)
                        outs.append(ev)
                    (obs, A), (iobs, iA) = outs
                    dead = _inert_steps(L, B, T, tile).to(cuda)
                    inert_seen += int(dead.sum())
                    assert torch.equal(iobs[~dead], obs[~dead])
                    assert torch.equal(iA[~dead], A[~dead])
                    assert bool((iobs[dead] == 0).all())
                    assert torch.equal(iA[dead], eye.expand_as(iA[dead]))
    torch.cuda.synchronize()
    assert inert_seen > 0
    assert (fd.fused_evidence.launches,
            fd.fused_evidence.inert_launches) == counts


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_inert_tiles_only_for_the_viterbi_decode(cuda, precision):
    """VAEHMM.viterbi_decode asks kernel 11 for the inert tiles, once a
    call with lengths, and its states are bit-equal to kernel B on the
    whole evidence; smoothed_posterior, filtered_posterior and a /stream
    step (models/online.py) never ask, and keep the whole evidence."""
    from vqvaehmm_tpu_torch.models.online import OnlineFilter
    from vqvaehmm_tpu_torch.ops import fused_decode as fd

    model = _model(cuda, seed=24, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128, matmul_precision=precision)
    B, T = 6, 1040
    x, u, lens = _train_inputs(cuda, B, T, 31)
    lens[1:] = torch.tensor([1, 33, 64, 65, 500], dtype=torch.int32)
    fe = fd.fused_evidence
    with torch.inference_mode():
        a, i = fe.launches, fe.inert_launches
        states = model.viterbi_decode(x, u, lens)
        assert (fe.launches, fe.inert_launches) == (a + 1, i + 1)
        whole = fd.fused_evidence(model, x, u, lens)
        assert torch.equal(states, viterbi_fused(*whole, lens).states)
        i = fe.inert_launches
        assert torch.equal(model.viterbi_decode(x, u),
                           viterbi_fused(*fd.fused_evidence(model, x, u))
                           .states)
        model.smoothed_posterior(x, u, lens)
        model.filtered_posterior(x, u, lens)
        f = OnlineFilter(model)
        rng = np.random.default_rng(5)
        for _ in range(6):
            f.update(rng.normal(size=5), rng.normal(size=4))
        f.finish()
    assert fe.inert_launches == i


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_packed_weights_follow_in_place_updates(cuda, precision):
    """The packed weights are kept a model, a kernel family and a mode,
    and keyed on the parameters' versions: after an in-place update, and
    after load_state_dict, the kernels (8, 11 and A, in the float32 mode
    and in the bfloat16-operand mode) answer with the new weights,
    bit-equal to a fresh model; kernel A's weights are packed once a
    version, not once a call."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_encoder import kernel_cache

    P = dict(matmul_precision=precision)
    model = _model(cuda, seed=6, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128, **P)
    x, u, lens = _train_inputs(cuda, 3, 50, 11)
    with torch.inference_mode():
        before = model.encode(x, valid_to=lens)
        ev_before = fused_evidence(model, x, u, lens)
        a_before = fused_forward(model, x, valid_to=lens)
        packed = kernel_cache(model).weights(model, x.device, "infer",
                                             precision != "highest")[0]
        fused_forward(model, x, valid_to=lens)
        assert kernel_cache(model).weights(
            model, x.device, "infer", precision != "highest")[0] is packed
    assert packed.dtype == (torch.float32 if precision == "highest"
                            else torch.bfloat16)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    other = _model(cuda, seed=7, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128, **P)
    for update in ("in place", "load_state_dict"):
        if update == "load_state_dict":
            model.load_state_dict(other.state_dict())
        fresh = _model(cuda, seed=8, hidden_dim=64, hidden_dim2=32,
                       trans_hidden=128, **P)
        fresh.load_state_dict(model.state_dict())
        with torch.inference_mode():
            got = model.encode(x, valid_to=lens)
            ev = fused_evidence(model, x, u, lens)
            a = fused_forward(model, x, valid_to=lens)
            assert torch.equal(got, fresh.encode(x, valid_to=lens)), update
            for g, w in zip(ev, fused_evidence(fresh, x, u, lens)):
                assert torch.equal(g, w), update
            for g, w in zip(a, fused_forward(fresh, x, valid_to=lens)):
                assert torch.equal(g, w), update
        assert not torch.equal(got, before)
        assert not torch.equal(ev[1], ev_before[1])
        assert not torch.equal(a[0], a_before[0])
    # a model made under inference_mode keeps no versions: its weights are
    # packed every call, so an update in place is seen too
    widths = dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128, **P)
    with torch.inference_mode():
        frozen = _model(cuda, seed=9, **widths)
        first = frozen.encode(x, valid_to=lens)
        for p in frozen.parameters():
            p.mul_(2.0)
        second = frozen.encode(x, valid_to=lens)
        ev_second = fused_evidence(frozen, x, u, lens)
    fresh = _model(cuda, seed=9, **widths)
    with torch.no_grad():
        for p in fresh.parameters():
            p.mul_(2.0)
    with torch.inference_mode():
        assert torch.equal(second, fresh.encode(x, valid_to=lens))
        for g, w in zip(ev_second, fused_evidence(fresh, x, u, lens)):
            assert torch.equal(g, w)
    assert not torch.equal(first, second)


def test_encoder_gates_refuse_layers_wider_than_a_weight_buffer(cuda):
    """A k=3 layer of more than WBUF / 3 outputs, or a prior layer of more
    than WBUF: the gates raise, and the C launcher refuses such widths and
    a tile the plan cannot choose by itself."""
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    x = torch.zeros((1, 5, 8), device=cuda)
    u = torch.zeros((1, 4, 8), device=cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="unsupported"):
            fe.fused_encode(_model(cuda, hidden_dim=8, hidden_dim2=2052), x)
        with pytest.raises(ValueError, match="unsupported"):
            fused_evidence(_model(cuda, trans_hidden=6148), x, u)
        model = _model(cuda)
        out = torch.empty((1, 3, 8), device=cuda)
        vt = torch.full((1,), 8, dtype=torch.int32, device=cuda)
        with pytest.raises(RuntimeError, match="CUDA error"):
            fe._launch(model, x, vt, 48, out)


def _autograd_entries(model, u, lens, bf16):
    """(name, default call, plain call) of the six entry points through
    the inference kernels, each reduced to a float tensor: the plain
    version is the wrappers' plain route in the model's mode (posterior:
    fused_encode(use_kernel=False), not encode(fused=False), which keeps
    the model's own products); the decodes' states through the decoder."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_viterbi_states
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    def decoded(states):
        onehot = torch.nn.functional.one_hot(states.long(), 3)
        return model.decode(onehot.transpose(1, 2).float())[0]

    return (
        ("posterior", lambda x: model.posterior(x),
         lambda x: torch.softmax(fused_encode(model, x, use_kernel=False),
                                 dim=1)),
        ("infer_forward",
         lambda x: torch.cat(model.infer_forward(x, valid_to=lens), 1),
         lambda x: torch.cat(model.infer_forward(x, valid_to=lens,
                                                 use_kernel=False), 1)),
        ("smoothed_posterior", lambda x: model.smoothed_posterior(x, u, lens),
         lambda x: model.smoothed_posterior(x, u, lens, use_kernel=False)),
        ("filtered_posterior", lambda x: model.filtered_posterior(x, u, lens),
         lambda x: model.filtered_posterior(x, u, lens, use_kernel=False)),
        ("viterbi_decode",
         lambda x: decoded(model.viterbi_decode(x, u, lens)) + 0 * x.sum(),
         lambda x: decoded(model.viterbi_decode(x, u, lens,
                                                use_kernel=False))
         + 0 * x.sum()),
        ("fused_viterbi_states",
         lambda x: decoded(fused_viterbi_states(model, x, u, lens))
         + 0 * x.sum(),
         lambda x: decoded(fused_viterbi_states(model, x, u, lens,
                                                use_kernel=False))
         + 0 * x.sum()))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_inference_kernels_refuse_autograd(cuda, precision):
    """The kernels carry no gradient, so the routing steps aside as JAX's
    auto-dispatch does: under autograd (grad mode on, weights or x
    requiring grad) the default call of each of the six entry points
    takes the differentiable plain version, in the model's mode, and its
    gradients (x's and every weight's) equal the plain version's bit for
    bit (cuDNN held to its deterministic algorithms for the float32
    convolutions' backward), launching none of kernels A, 8, 11 and 10;
    under no_grad and inference_mode they launch; use_kernel=True
    (fused=True) under autograd raises for A, 8, 11 and 10, so nothing
    hands back a detached tensor."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    counted = (fused_forward, fused_encode, fused_evidence,
               fused_viterbi_states)
    model = _model(cuda, seed=3, matmul_precision=precision)
    bf16 = precision != "highest"
    x, u, lens = _train_inputs(cuda, 2, 40, 9)
    w = torch.randn((2, 13, 40), generator=torch.Generator().manual_seed(4))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, default, plain in _autograd_entries(model, u, lens, bf16):
            grads = []
            for call in (default, plain):
                model.zero_grad(set_to_none=True)
                xx = x.clone().requires_grad_(True)
                before = [c.launches for c in counted]
                out = call(xx)
                assert [c.launches for c in counted] == before, name
                assert out.requires_grad, name
                (out * w[:, :out.shape[1]].to(cuda)).sum().backward()
                grads.append([xx.grad] + [p.grad for p in
                                          model.parameters()])
            for g, p in zip(*grads):
                assert (g is None) == (p is None), name
                assert g is None or torch.equal(g, p), name
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # outside autograd every entry point launches its kernels
    for mode in (torch.no_grad, torch.inference_mode):
        before = [c.launches for c in counted]
        with mode():
            for _, default, _ in _autograd_entries(model, u, lens, bf16):
                default(x)
        got = [c.launches - b for c, b in zip(counted, before)]
        assert got == [1, 1, 3, 1], (mode, got)
    # a forced kernel under autograd raises, through x alone too
    forced = (lambda xx: fused_forward(model, xx, use_kernel=True),
              lambda xx: model.infer_forward(xx, use_kernel=True),
              lambda xx: model.posterior(xx, fused=True),
              lambda xx: model.encode(xx, fused=True),
              lambda xx: fused_encode(model, xx, use_kernel=True),
              lambda xx: fused_evidence(model, xx, u, lens, use_kernel=True),
              lambda xx: model.smoothed_posterior(xx, u, lens,
                                                  use_kernel=True),
              lambda xx: fused_viterbi_states(model, xx, u, lens,
                                              use_kernel=True))
    before = [c.launches for c in counted]
    for call in forced:
        with pytest.raises(RuntimeError, match="no gradient"):
            call(x)
    for p in model.parameters():
        p.requires_grad_(False)
    for call in forced:
        with pytest.raises(RuntimeError, match="no gradient"):
            call(x.clone().requires_grad_(True))
    assert [c.launches for c in counted] == before
    # frozen weights and x: nothing for autograd to record, the kernels run
    q = model.posterior(x)
    assert not q.requires_grad and fused_encode.launches == before[1] + 1


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
    hand-written kernel; nor do the plain versions of the inference
    kernels' bfloat16-operand mode (a default-precision model's wrappers
    with use_kernel=False, and the references with bf16_operands=True)."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (
        fused_evidence, fused_evidence_reference, fused_viterbi_states,
        fused_viterbi_states_reference)
    from vqvaehmm_tpu_torch.ops.fused_encoder import (fused_encode,
                                                      fused_encode_reference)
    from vqvaehmm_tpu_torch.models.vqvae_hmm import VQVAEConfig, VQVAEHMM
    from vqvaehmm_tpu_torch.ops import vq
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                               gather_epoch_reference)

    # gather_epoch counts kernel D's launches, gather_windows' included
    wrappers = (fused_forward, viterbi_fused, fused_encode, fused_evidence,
                fused_viterbi_states, fused_loss_and_grads, gather_epoch,
                vq.vq_nearest, vq.quantize_st_fused_forward,
                vq.quantize_st_fused_backward)
    model = _model(cuda, seed=8)
    x, u, lens = _train_inputs(cuda, 3, 40, 5)
    vqm = VQVAEHMM(VQVAEConfig(), device=cuda,
                   generator=torch.Generator().manual_seed(8))
    rng = np.random.default_rng(8)
    px, pu = (torch.from_numpy(a).to(cuda) for a in build_pools(
        [rng.normal(size=(5, 60)).astype(np.float32)] * 2,
        [rng.normal(size=(4, 60)).astype(np.float32)] * 2))
    trip = [torch.full((2, 3), v, dtype=torch.int32, device=cuda)
            for v in (1, 5, 30)]
    before = [w.launches for w in wrappers]
    gather_epoch_reference(px, pu, *trip, 40)
    vqm.compute_loss(x, lens, use_kernel=False).total.backward()
    z = vqm.encode(x).detach()
    fwd = vq.quantize_st_forward_reference(z, vqm.codebook, 0.25, None, True)
    vq.quantize_st_backward_reference(torch.ones_like(z), fwd[2], fwd[3], z,
                                      vqm.codebook, fwd[1], None, fwd[4],
                                      0.25, True)
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
    m16 = _model(cuda, seed=8, matmul_precision="default")
    with torch.inference_mode():
        fused_forward(m16, x, valid_to=lens, use_kernel=False)
        fused_forward_reference(m16, x, valid_to=lens, bf16_operands=True)
        fused_encode(m16, x, valid_to=lens, use_kernel=False)
        fused_encode_reference(m16, x, valid_to=lens, bf16_operands=True)
        fused_evidence(m16, x, u, lens, use_kernel=False)
        fused_evidence_reference(m16, x, u, lens, bf16_operands=True)
        fused_viterbi_states(m16, x, u, lens, use_kernel=False)
        fused_viterbi_states_reference(m16, x, u, lens, bf16_operands=True)
        for fn in (m16.smoothed_posterior, m16.filtered_posterior,
                   m16.viterbi_decode):
            fn(x, u, lens, use_kernel=False)
        m16.infer_forward(x, valid_to=lens, use_kernel=False)
        m16.posterior(x, fused=False)
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
    # the model's loss goes through the quantizer's two kernels and its
    # codes through kernel 9, once each, and the loss carries gradients to
    # all 13 parameters
    from vqvaehmm_tpu_torch.ops.vq import (quantize_st_fused_backward,
                                           quantize_st_fused_forward)

    model = VQVAEHMM(VQVAEConfig(), device=cuda,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn((4, 5, 60), device=cuda)
    lengths = torch.tensor([60, 20, 33, 47], device=cuda)
    counters = (vq_nearest, quantize_st_fused_forward,
                quantize_st_fused_backward)
    n = [c.launches for c in counters]
    parts = model.compute_loss(x, lengths)
    parts.total.backward()
    codes = model.codes(x)
    assert [c.launches - k for c, k in zip(counters, n)] == [1, 1, 1]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    plain = model.compute_loss(x, lengths, use_kernel=False)
    assert [c.launches - k for c, k in zip(counters, n)] == [1, 1, 1]
    torch.testing.assert_close(parts.total, plain.total, rtol=1e-5, atol=0)
    assert torch.equal(parts.counts, plain.counts)
    assert torch.equal(codes, model.codes(x, use_kernel=False))


# ---------------------------------------------------------------------------
# The straight-through quantizer (kernel 9 redesigned) and the epoch gather
# (kernel D redesigned)


def _quantize_inputs(dev, B, T, D, M, masked, seed):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(B, D, T)).astype(np.float32)
                         ).to(dev)
    cb = torch.from_numpy((0.5 * rng.normal(size=(M, D))).astype(np.float32)
                          ).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, D, T)).astype(np.float32)
                         ).to(dev)
    mask = None
    if masked:
        lens = rng.integers(0, T + 1, size=B)
        lens[0] = T
        mask = torch.from_numpy(np.arange(T)[None, :] < lens[:, None]).to(dev)
    return z, cb, g, mask


# dcodebook sums each code's tokens in another order than the plain
# version's one-hot product: within 1e-5 of the sum of the terms' absolute
# values (float32, a few thousand terms a code); the losses within 1e-5
# relative (a sum of N * D squares)
@pytest.mark.parametrize("B,T,D,M", [(64, 200, 16, 8), (3, 37, 5, 3),
                                     (4, 33, 64, 40), (1, 2327, 16, 8),
                                     (2, 301, 5, 40), (7, 129, 64, 3),
                                     (5, 77, 16, 40), (1, 1, 16, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_quantize_fused_matches_plain(cuda, B, T, D, M, masked):
    from vqvaehmm_tpu_torch.ops import vq

    z, cb, g, mask = _quantize_inputs(cuda, B, T, D, M, masked, B + T + D)
    gc, gk = (torch.tensor(v, device=cuda) for v in (0.7, 1.3))
    for cf in (True, False):
        zin = z if cf else z.transpose(1, 2).contiguous()
        gin = g if cf else g.transpose(1, 2)            # strided cotangent
        fwd = vq.quantize_st_fused_forward(zin, cb, 0.25, mask, cf)
        ref = vq.quantize_st_forward_reference(zin, cb, 0.25, mask, cf)
        zst, idx = fwd[0], fwd[1]
        assert idx.dtype == torch.int32 and idx.shape == (B, T)
        assert _near_tie(z.transpose(1, 2), cb, idx, ref[1])
        same = (idx == ref[1]).unsqueeze(1 if cf else -1).expand_as(zst)
        assert torch.equal(zst[same], ref[0][same])
        rows = cb[idx.long()]
        zq = rows.transpose(1, 2) if cf else rows
        assert torch.equal(zst, zin + (zq - zin))
        assert torch.equal(fwd[4], ref[4])                    # denom
        for got, want in zip(fwd[2:4], ref[2:4]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        bwd = vq.quantize_st_fused_backward(gin, gc, gk, zin, cb, idx, mask,
                                            fwd[4], 0.25, cf)
        want = vq.quantize_st_backward_reference(gin, gc, gk, zin, cb, idx,
                                                 mask, fwd[4], 0.25, cf)
        assert torch.equal(bwd[0], want[0])
        v = (zin.transpose(1, 2) if cf else zin) - rows
        if mask is not None:
            v = v * mask[..., None]
        onehot = torch.nn.functional.one_hot(idx.reshape(-1).long(), M).float()
        scale = onehot.T @ v.reshape(-1, D).abs() * (2 * 1.3 / fwd[4]).abs()
        assert bool(((bwd[1] - want[1]).abs() <= 1e-5 * scale + 1e-30).all())
        again = (vq.quantize_st_fused_forward(zin, cb, 0.25, mask, cf),
                 vq.quantize_st_fused_backward(gin, gc, gk, zin, cb, idx,
                                               mask, fwd[4], 0.25, cf))
        for a, b in zip(fwd + bwd, again[0] + again[1]):
            assert torch.equal(a, b)


def test_quantize_st_two_launches_and_autograd(cuda):
    """On a CUDA tensor quantize_st is one forward and one backward launch
    and no nearest-code launch; its gradients match the plain autograd
    path's; all-masked batches clamp the denominator to 1; a codebook of
    two equal rows picks the lower."""
    from vqvaehmm_tpu_torch.ops import vq

    z, cb, g, mask = _quantize_inputs(cuda, 8, 200, 16, 8, True, 3)
    cb[5] = cb[2]
    counters = (vq.vq_nearest, vq.quantize_st_fused_forward,
                vq.quantize_st_fused_backward)
    for m in (mask, torch.zeros_like(mask), None):
        res = []
        for use in (None, False):
            tz = z.clone().requires_grad_()
            tc = cb.clone().requires_grad_()
            n = [c.launches for c in counters]
            r = vq.quantize_st(tz, tc, 0.25, use_kernel=use, mask=m,
                               channels_first=True)
            ((r.quantized * g).sum() + 0.7 * r.commitment_loss
             + 1.3 * r.codebook_loss).backward()
            torch.cuda.synchronize()
            assert [c.launches - k for c, k in zip(counters, n)] == (
                [0, 1, 1] if use is None else [0, 0, 0])
            res.append((r.indices, r.quantized.detach(), tz.grad, tc.grad,
                        r.commitment_loss.detach(),
                        r.codebook_loss.detach()))
        assert not bool((res[0][0] == 5).any())
        assert torch.equal(res[0][0], res[1][0])
        assert torch.equal(res[0][1], res[1][1])
        for got, want in zip(res[0][2:], res[1][2:]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="use_kernel=False"):
        vq.quantize_st(z.double(), cb.double(), channels_first=True)
    with pytest.raises(ValueError, match="use_kernel=False"):
        vq.quantize_st(torch.zeros((2, 65, 4), device=cuda),
                       torch.zeros((3, 65), device=cuda), channels_first=True)


GUARD = 4096        # sentinel elements on each side of a guarded output


def _guarded(n, dtype, dev):
    """(buffer, view): n elements inside GUARD sentinels on each side
    (NaN, or -7 for int32)."""
    fill = -7 if dtype == torch.int32 else float("nan")
    buf = torch.full((n + 2 * GUARD,), fill, dtype=dtype, device=dev)
    return buf, buf[GUARD:GUARD + n]


def _guards_intact(buf):
    edges = torch.cat([buf[:GUARD], buf[-GUARD:]])
    if edges.dtype == torch.int32:
        return bool((edges == -7).all())
    return bool(torch.isnan(edges).all())


@pytest.mark.parametrize("B,T,D,M", [(3, 37, 5, 3), (4, 33, 64, 40),
                                     (5, 77, 16, 40), (64, 200, 16, 8)])
def test_quantize_kernels_write_only_their_outputs(cuda, B, T, D, M):
    """The quantizer's kernels, called through their C entry points on
    outputs and scratch set inside sentinels, leave every sentinel as it
    was and give the wrappers' results bit for bit."""
    from vqvaehmm_tpu_torch.ops import _build, vq

    z, cb, g, mask = _quantize_inputs(cuda, B, T, D, M, True, B + D)
    gc, gk = (torch.tensor([v], device=cuda) for v in (0.7, 1.3))
    lib = _build.library()
    fb, bb = (lib.vqhmm_vq_quantize_sizes(B, T, M, D, w) for w in (0, 1))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    zs, ms = (D * T, T, 1), (T, 1)
    counter = vq._counter(cuda).data_ptr()
    f32, i32 = torch.float32, torch.int32
    zst, idx, fpart, commit, cbl = (
        _guarded(n, t, cuda) for n, t in ((B * D * T, f32), (B * T, i32),
                                          (2 * fb + 1, f32), (1, f32),
                                          (1, f32)))
    _build.check(lib.vqhmm_vq_quantize_forward(
        z.data_ptr(), *zs, mask.data_ptr(), 1, *ms, cb.data_ptr(), 0.25,
        zst[1].data_ptr(), idx[1].data_ptr(), fpart[1].data_ptr(),
        commit[1].data_ptr(), cbl[1].data_ptr(), counter, B, T, M, D,
        stream), "guarded forward")
    dz, dcb, bpart = (_guarded(n, f32, cuda)
                      for n in (B * D * T, M * D, bb * M * D))
    _build.check(lib.vqhmm_vq_quantize_backward(
        g.data_ptr(), *zs, gc.data_ptr(), gk.data_ptr(), z.data_ptr(), *zs,
        mask.data_ptr(), 1, *ms, cb.data_ptr(), idx[1].data_ptr(),
        fpart[1][2 * fb:].data_ptr(), 0.5, dz[1].data_ptr(),
        dcb[1].data_ptr(), bpart[1].data_ptr(), counter, B, T, M, D,
        stream), "guarded backward")
    torch.cuda.synchronize()
    for buf, _ in (zst, idx, fpart, commit, cbl, dz, dcb, bpart):
        assert _guards_intact(buf)
    fwd = vq.quantize_st_fused_forward(z, cb, 0.25, mask, True)
    bwd = vq.quantize_st_fused_backward(g, gc[0], gk[0], z, cb, fwd[1], mask,
                                        fwd[4], 0.25, True)
    for got, want in zip((zst, idx, commit, cbl, dz, dcb),
                         fwd[:4] + bwd):
        assert torch.equal(got[1], want.reshape(-1))


def test_gather_kernel_writes_only_its_outputs(cuda):
    """Kernel D on outputs set inside sentinels, with a triple out of
    range among the windows: every sentinel stays, and the windows equal
    the plain version's (the bad window zeros)."""
    from vqvaehmm_tpu_torch.ops import _build
    from vqvaehmm_tpu_torch.ops.gather import (build_pools,
                                               gather_epoch_reference)

    rng = np.random.default_rng(11)
    S, B, T, C, U = 3, 16, 48, 5, 4
    lens = rng.integers(T, 3 * T + 1, size=6)
    xs = [rng.normal(size=(C, n)).astype(np.float32) for n in lens]
    us = [rng.normal(size=(U, n)).astype(np.float32) for n in lens]
    px, pu = (torch.from_numpy(a).to(cuda) for a in build_pools(xs, us))
    si = rng.integers(0, 6, size=(S, B))
    ln = rng.integers(1, T + 1, size=(S, B))
    st = rng.integers(0, lens[si] - ln + 1)
    si[1, 3] = 6                                   # no such sequence
    trip = [torch.from_numpy(a.astype(np.int32)).to(cuda)
            for a in (si, st, ln)]
    x, u = (_guarded(S * B * n * T, torch.float32, cuda) for n in (C, U))
    _build.check(_build.library().vqhmm_gather(
        px.data_ptr(), pu.data_ptr(), *(a.data_ptr() for a in trip),
        x[1].data_ptr(), u[1].data_ptr(), 6, C, U, px.shape[2], S * B, T,
        torch.cuda.current_stream(cuda).cuda_stream), "guarded gather")
    torch.cuda.synchronize()
    assert _guards_intact(x[0]) and _guards_intact(u[0])
    trip[0][1, 3] = 0
    want = gather_epoch_reference(px, pu, *trip, T)
    for got, w in zip((x[1], u[1]), want):
        w[1, 3] = 0
        assert torch.equal(got, w.reshape(-1))


def test_vq_training_repeats_on_the_card(cuda):
    """Two VQ training runs from one seed through the fused quantizer give
    the same losses and parameters, bit for bit."""
    from vqvaehmm_tpu_torch.models.vqvae_hmm import VQVAEConfig, VQVAEHMM

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(16, 5, 120)).astype(np.float32)
                         ).to(cuda)
    lens = torch.from_numpy(rng.integers(30, 121, size=16).astype(np.int32)
                            ).to(cuda)
    runs = []
    for _ in range(2):
        model = VQVAEHMM(VQVAEConfig(), device=cuda,
                         generator=torch.Generator().manual_seed(1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        losses = []
        for _ in range(5):
            opt.zero_grad()
            parts = model.compute_loss(x, lens)
            parts.total.backward()
            opt.step()
            losses.append(parts.total.detach())
        runs.append((torch.stack(losses), [p.detach().clone()
                                           for p in model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("S,B,T", [(15, 64, 200), (1, 1, 1), (3, 16, 48)])
def test_gather_epoch_matches_plain(cuda, S, B, T, monkeypatch):
    from vqvaehmm_tpu_torch.ops import gather
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                               gather_epoch_chunks,
                                               gather_epoch_reference)

    rng = np.random.default_rng(S + B + T)
    lens = rng.integers(T, 3 * T + 1, size=6)
    xs = [rng.normal(size=(5, n)).astype(np.float32) for n in lens]
    us = [rng.normal(size=(4, n)).astype(np.float32) for n in lens]
    px, pu = (torch.from_numpy(a).to(cuda) for a in build_pools(xs, us))
    si = rng.integers(0, 6, size=(S, B))
    ln = rng.integers(1, T + 1, size=(S, B))
    ln[0, 0] = T
    st = rng.integers(0, lens[si] - ln + 1)
    st[-1, -1] = lens[si[-1, -1]] - ln[-1, -1]    # a window at the very end
    idx = [torch.from_numpy(a.astype(np.int32)).to(cuda)
           for a in (si, st, ln)]
    before = gather_epoch.launches
    got = gather_epoch(px, pu, *idx, T)
    want = gather_epoch_reference(px, pu, *idx, T)
    torch.cuda.synchronize()
    assert gather_epoch.launches == before + 1
    assert got[0].shape == (S, B, 5, T) and got[1].shape == (S, B, 4, T)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    monkeypatch.setattr(gather, "EPOCH_CHUNK_BYTES", 4 * B * 9 * T)
    chunks = list(gather_epoch_chunks(px, pu, *idx, T))  # a batch a chunk
    assert gather_epoch.launches == before + 1 + S
    assert torch.equal(torch.cat([c[1] for c in chunks]), got[0])
    assert torch.equal(torch.cat([c[2] for c in chunks]), got[1])


def test_device_epoch_and_epoch_step_gather_once(cuda, monkeypatch):
    """DeviceEpochSampler.epoch is one launch of kernel D; make_epoch_step
    one a chunk, and its losses and parameters equal, bit for bit, those of
    the same steps with a gather a step."""
    from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
    from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
    from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
    from vqvaehmm_tpu_torch.ops import gather
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.train.trainer import make_optimizer, train_step

    xs, us, _ = synthetic_sequences(6, 150, 5, 4, 3, seed=2)
    ds = RandomChunkDataset(xs, us, min_len=20, max_len=64,
                            samples_per_epoch=64, seed=0)
    sampler = DeviceEpochSampler(ds, cuda)
    n = gather_epoch.launches
    x, u, ln = sampler.epoch(16)
    assert gather_epoch.launches == n + 1 and x.shape == (4, 16, 5, 64)
    trip = sampler.draw_epoch(16)
    runs = []
    default = gather.EPOCH_CHUNK_BYTES
    for chunk in (None, 4 * 16 * 9 * 64 * 2, "step"):
        monkeypatch.setattr(gather, "EPOCH_CHUNK_BYTES",
                            chunk if isinstance(chunk, int) else default)
        model = _model(cuda, seed=6)
        opt = make_optimizer(model, 1e-3, 1.0)
        n = gather_epoch.launches
        if chunk == "step":
            losses = [train_step(model, opt, *sampler.gather(
                *(a[i] for a in trip)), trip[2][i], 0.5, True)
                for i in range(4)]
            loss = torch.zeros((), device=cuda)
            for l_ in losses:
                loss = loss + l_
            loss = loss / 4
        else:
            loss = sampler.make_epoch_step(model, opt, fused=True)(*trip,
                                                                   0.5)
        torch.cuda.synchronize()
        assert gather_epoch.launches - n == {None: 1, "step": 4}.get(chunk,
                                                                     2)
        runs.append((loss, [p.detach().clone() for p in model.parameters()]))
    for other in runs[1:]:
        assert torch.equal(other[0], runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(other[1], runs[0][1]))


def _serving_config(tmp_path, dev, seed=0, name="cfg.json", **widths):
    """A serving config whose `.npz` checkpoint holds a seeded model's
    weights (the port's own writer: this file imports nothing of JAX)."""
    import json

    from vqvaehmm_tpu_torch.data.checkpoint import save_params_npz

    model = _model(dev, seed=seed, **widths)
    ckpt = tmp_path / f"{name}.npz"
    save_params_npz(str(ckpt), model.state_dict())
    cfg = {"model": {**dict(input_dim=5, hidden_dim=16, K=3, hidden_dim2=8,
                            u_dim=4, trans_hidden=8), **widths},
           "checkpoint_path": str(ckpt)}
    (tmp_path / name).write_text(json.dumps(cfg))
    return str(tmp_path / name)


def test_batched_dispatch_bit_equal_to_solo(cuda, tmp_path):
    """Groups of 1-16 requests with mixed lengths in one bucket: each
    group is one kernel-A launch and each row is bit-equal to the same
    request served solo."""
    import concurrent.futures

    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.batching import BatchingModel

    m = InferenceModel(_serving_config(tmp_path, cuda, seed=7,
                                       hidden_dim=64, hidden_dim2=32),
                       device=cuda)
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(5, int(T))).tolist()
          for T in rng.integers(65, 129, size=16)]
    solo = [m.infer(x) for x in xs]
    b = BatchingModel(m, max_batch=1, max_wait_ms=10000.0)
    try:
        for n in range(1, 17):
            # the linger ends when max_batch requests wait
            b.reconfigure(max_batch=n, max_wait_ms=10000.0)
            before = (fused_forward.launches, b.dispatches)
            with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
                got = list(ex.map(b.infer, xs[:n]))
            assert (fused_forward.launches - before[0],
                    b.dispatches - before[1]) == (1, 1)
            for g, s in zip(got, solo):
                assert g == s
    finally:
        b.close()


def test_stream_step_evidence_matches_plain(cuda, tmp_path):
    """Every step of a 12-frame stream, finish included, from a thread
    with grad mode on: kernel 11's evidence on the step's window against
    its plain version on the same inputs (log_obs and log_A within 1e-5,
    float32 in another summation order), and the settled columns within
    1e-5 of the card's batch filtered posterior."""
    from vqvaehmm_tpu_torch.models import online
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_evidence_reference)
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    m = InferenceModel(_serving_config(tmp_path, cuda, seed=8), device=cuda)
    seen = []

    def checked(model, x, u, lengths):
        got = fused_evidence(model, x, u, lengths)
        want = fused_evidence_reference(model, x, u, lengths)
        seen.append((x.shape[2], int(lengths[0])))
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        return got

    rng = np.random.default_rng(12)
    T = 12
    x = rng.normal(size=(5, T)).astype(np.float32)
    u = rng.normal(size=(4, T)).astype(np.float32)
    got, errors = {}, []
    real = online.fused_evidence
    online.fused_evidence = checked
    n0 = fused_evidence.launches

    def drive():
        try:
            assert torch.is_grad_enabled()
            for t in range(T):
                out = m.stream("s", x_t=x[:, t].tolist(),
                               u_t=u[:, t].tolist(), finish=t == T - 1)
                got.update({d["t"]: d["regime_probs"]
                            for d in out["settled"]})
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    try:
        th = threading.Thread(target=drive)
        th.start()
        th.join(timeout=120)
    finally:
        online.fused_evidence = real
    assert not th.is_alive() and not errors, errors
    # 10 settled steps; peeks of 1 step after frame 1 and 2 after frames
    # 2-11; 2 steps at finish
    assert fused_evidence.launches - n0 == len(seen) == 10 + 21 + 2
    assert {vt for _, vt in seen} == {1, 2, 3, 4, 5}
    with torch.inference_mode():
        batch = m.model.filtered_posterior(
            torch.from_numpy(x)[None].to(cuda),
            torch.from_numpy(u)[None].to(cuda),
            torch.tensor([T], device=cuda))[0].cpu().numpy()
    assert sorted(got) == list(range(T))
    for t in range(T):
        np.testing.assert_allclose(got[t], batch[:, t], rtol=0, atol=1e-5)


def test_failed_kernel_in_dispatch_fails_its_group(cuda, tmp_path,
                                                   monkeypatch):
    """A kernel-A launch that fails inside a dispatch reaches every caller
    of the group as an error; nothing of the group is computed by the
    plain version."""
    import concurrent.futures

    from vqvaehmm_tpu_torch.ops import fused_infer
    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.batching import BatchingModel

    m = InferenceModel(_serving_config(tmp_path, cuda, seed=9), device=cuda)
    b = BatchingModel(m, max_batch=4, max_wait_ms=10000.0)
    plain = []

    def broken(*a, **k):
        raise RuntimeError("CUDA error: launch failed (injected)")

    def counted(*a, **k):
        plain.append(1)
        return real_plain(*a, **k)

    real_plain = fused_infer.fused_forward_reference
    monkeypatch.setattr(fused_infer, "_launch", broken)
    monkeypatch.setattr(fused_infer, "fused_forward_reference", counted)

    def call(T):
        try:
            return b.infer(np.ones((5, T)).tolist())
        except RuntimeError as e:
            return e

    try:
        n0 = fused_forward.launches
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            res = list(ex.map(call, (20, 25, 30, 32)))
        assert all(isinstance(r, RuntimeError) and "injected" in str(r)
                   for r in res), res
        assert plain == [] and b.dispatches == 0
        assert fused_forward.launches == n0
    finally:
        b.close()


def test_reloads_free_the_old_models(cuda, tmp_path):
    """Five reloads of a micro-batched handle, each with its model warmed
    and streamed: after gc the card holds what it held after the first."""
    import gc

    from vqvaehmm_tpu_torch.serve.app import ModelHandle

    cfg = _serving_config(tmp_path, cuda, seed=10, hidden_dim=64,
                          hidden_dim2=32)
    h = ModelHandle(cfg, device=cuda)
    h.configure_batching(max_batch=8, max_wait_ms=1.0,
                         warmup_lengths=(37, 200))
    rng = np.random.default_rng(13)

    def use():
        h.infer(rng.normal(size=(5, 150)).tolist())
        h.stream("s", x_t=[0.5] * 5, u_t=[0.1] * 4)
        h.infer(rng.normal(size=(5, 40)).tolist(), u=np.zeros((4, 40))
                .tolist(), mode="viterbi")

    try:
        use()
        h.reload()
        use()
        gc.collect()
        torch.cuda.synchronize()
        first = torch.cuda.memory_allocated()
        for _ in range(4):
            h.reload()
            use()
        gc.collect()
        torch.cuda.synchronize()
        assert abs(torch.cuda.memory_allocated() - first) <= 1 << 20
    finally:
        h.close()


def test_get_model_cuda_spellings_share_one_handle(cuda, tmp_path):
    from vqvaehmm_tpu_torch.serve.app import get_model

    cfg = _serving_config(tmp_path, cuda, seed=11)
    get_model.cache_clear()
    try:
        h = get_model(cfg)
        for args, kw in (((cfg, "cuda"), {}), ((cfg,), {"device": "cuda"}),
                         ((cfg, "cuda:0"), {}),
                         ((cfg, torch.device("cuda")), {}),
                         ((cfg, torch.device("cuda", 0)), {})):
            assert get_model(*args, **kw) is h, (args, kw)
        assert get_model(cfg, "cpu") is not h
    finally:
        get_model.cache_clear()


# -- the recipe's downstream stages: head training and Monte Carlo -------


class _FixedPosterior:
    """A VAE stand-in whose posterior is a given list of q, one a batch in
    order: the card's and the CPU's head training then start from the
    same posteriors, so only the head's arithmetic differs."""

    def __init__(self, qs, device):
        self.device = torch.device(device)
        self._qs = iter(qs)

    def posterior(self, x):
        return next(self._qs).to(x.device)


def _head_case(dev, n=3, B=16, T=100, seed=0):
    from vqvaehmm_tpu_torch.models.portfolio import (
        HeadConfig, ImprovedPortfolioOptimizer)

    rng = np.random.default_rng(seed)
    batches = [(rng.normal(size=(B, 5, T)).astype(np.float32),
                rng.normal(size=(B, 4, T)).astype(np.float32),
                np.full(B, T, np.int32)) for _ in range(n)]
    rets = [rng.normal(5e-4, 0.01, size=(B, 20, 10)).astype(np.float32)
            for _ in range(n)]
    head = ImprovedPortfolioOptimizer(
        HeadConfig(K=3, n_assets=10, hidden_dim=64), device=dev,
        generator=torch.Generator().manual_seed(7))
    return batches, rets, head


def test_head_training_on_the_card_matches_the_cpu(cuda):
    """train_portfolio_fused at the recipe's width, 20 epochs: the card's
    history within 1e-4 relative of the CPU's from the card's posteriors,
    and a second card run bit-equal."""
    from vqvaehmm_tpu_torch.train.heads import (frozen_posteriors,
                                                train_portfolio_fused)

    vae = _model(cuda, seed=3, hidden_dim=64, hidden_dim2=32)
    batches, rets, _ = _head_case(cuda)
    qs = frozen_posteriors(vae, batches)
    runs = {}
    for name, dev in (("cuda", cuda), ("cuda again", cuda), ("cpu", "cpu")):
        _, _, head = _head_case(dev)
        runs[name] = train_portfolio_fused(
            head, _FixedPosterior(qs, dev), batches, rets, num_epochs=20,
            lr=1e-3)
    np.testing.assert_allclose(runs["cuda"].history, runs["cpu"].history,
                               rtol=1e-4, atol=0)
    assert runs["cuda"].history == runs["cuda again"].history
    for k, v in runs["cuda"].params.items():
        assert torch.equal(v, runs["cuda again"].params[k]), k
        torch.testing.assert_close(v.cpu(), runs["cpu"].params[k], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("trainer", ["train_portfolio",
                                     "train_portfolio_fused",
                                     "train_portfolio_optimizer",
                                     "train_delta_hedger"])
def test_head_trainers_launch_the_encoder_once_a_batch(cuda, trainer):
    """Kernel 8 computes each batch's frozen posterior once, before the
    epochs: 3 batches and 4 epochs are 3 launches."""
    import vqvaehmm_tpu_torch.train.heads as heads
    from vqvaehmm_tpu_torch.models.hedging import RegimeDeltaHedger
    from vqvaehmm_tpu_torch.models.portfolio import HeadConfig
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    vae = _model(cuda, seed=4, hidden_dim=64, hidden_dim2=32)
    batches, rets, head = _head_case(cuda, T=40)
    kw = {} if trainer == "train_portfolio_fused" else {"log_fn": None}
    if trainer == "train_delta_hedger":
        head = RegimeDeltaHedger(HeadConfig(K=3, n_assets=5, hidden_dim=16),
                                 device=cuda)
        rets = [np.full((16, 39, 5), 0.01, np.float32) for _ in batches]
    before = fused_encode.launches
    res = getattr(heads, trainer)(head, vae, batches, rets, num_epochs=4,
                                  **kw)
    assert fused_encode.launches - before == len(batches)
    assert len(res.history) == 4 and np.isfinite(res.history).all()


def test_simulate_paths_on_the_card_matches_the_cpu(cuda):
    from vqvaehmm_tpu_torch.backtest.montecarlo import (monte_carlo_draws,
                                                        simulate_paths)

    rng = np.random.default_rng(5)
    K, A = 3, 10
    weights = torch.softmax(torch.from_numpy(
        rng.normal(size=(K, A)).astype(np.float32)), dim=-1)
    means = torch.from_numpy(rng.normal(3e-4, 1e-3, size=(K, A))
                             .astype(np.float32))
    chols = torch.from_numpy(np.linalg.cholesky(
        np.stack([np.cov(rng.normal(0, 0.01, size=(A, 60))) +
                  1e-8 * np.eye(A) for _ in range(K)])).astype(np.float32))
    draws = monte_carlo_draws(torch.Generator().manual_seed(0), K, A, 1000,
                              252)
    kw = dict(rebalance_every=5, switch_prob=0.3)
    cpu = simulate_paths(weights, means, chols, **draws, **kw)
    card = [simulate_paths(weights.to(cuda), means, chols, **draws, **kw)
            for _ in range(2)]
    assert card[0]["final_values"].is_cuda
    torch.testing.assert_close(card[0]["final_values"].cpu(),
                               cpu["final_values"], rtol=1e-4, atol=0)
    for key in ("final_values", "daily_returns"):
        assert torch.equal(card[0][key], card[1][key]), key


def _ensemble_dataset(seed=0):
    from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
    from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences

    xs, us, _ = synthetic_sequences(6, 150, 5, 4, 3, seed=2)
    return RandomChunkDataset(xs, us, min_len=20, max_len=64,
                              samples_per_epoch=64, seed=seed)


@pytest.mark.parametrize("device_data", [True, False])
def test_ensemble_members_bit_equal_to_solo_runs(cuda, device_data):
    """train_ensemble on the card: kernel C once a member a step, kernel D
    once an epoch on the device pipeline (none on the host's), and member
    i bit-equal, history and parameters, to train_model from the same
    initial state over the same epochs."""
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads
    from vqvaehmm_tpu_torch.ops.gather import gather_epoch
    from vqvaehmm_tpu_torch.train.ensemble import (init_ensemble_state,
                                                   train_ensemble)
    from vqvaehmm_tpu_torch.train.trainer import train_model

    template = _model(cuda, hidden_dim=64, hidden_dim2=32)
    seeds = [0, 1, 2]
    c0, d0 = fused_loss_and_grads.launches, gather_epoch.launches
    states, hist, best = train_ensemble(
        template, _ensemble_dataset(), seeds, num_epochs=3, batch_size=16,
        gradient_clip=1.0, device_data=device_data, device=cuda,
        log_fn=None)
    torch.cuda.synchronize()
    assert fused_loss_and_grads.launches - c0 == 3 * 3 * 4
    assert gather_epoch.launches - d0 == (3 if device_data else 0)
    assert best == int(np.argmin(hist[:, -1]))
    for i, seed in enumerate(seeds):
        solo = init_ensemble_state(template, [seed], 1e-3, 1.0, cuda)[0]
        state, solo_hist = train_model(
            solo.model, _ensemble_dataset(), num_epochs=3, batch_size=16,
            state=solo, device_data=device_data, device=cuda, log_fn=None)
        assert hist[i].tolist() == [np.float32(h) for h in solo_hist]
        for a, b in zip(states[i].model.state_dict().values(),
                        state.model.state_dict().values()):
            assert torch.equal(a, b), i


def test_prefetch_on_a_side_stream(cuda):
    """prefetch_epochs copies each epoch to the card on a side stream: the
    epochs equal the synchronous stream, arrive on the card, and work
    queued on the default stream right after reads them whole."""
    from vqvaehmm_tpu_torch.data.dataset import epoch_arrays
    from vqvaehmm_tpu_torch.data.prefetch import prefetch_epochs

    ref = _ensemble_dataset()
    sums = []
    for xs, us, lens in prefetch_epochs(_ensemble_dataset(), 16, 4,
                                        device=cuda):
        assert xs.is_cuda and lens.dtype == torch.int32
        sums.append((xs.sum(), us.sum(), lens.sum()))
        want = epoch_arrays(ref, 16)
        for g, w in zip((xs, us, lens), want):
            assert np.array_equal(g.cpu().numpy(), w)
    assert len(sums) == 4
    assert all(torch.isfinite(sx) and torch.isfinite(su) and sl > 0
               for sx, su, sl in sums)


def test_gmm_stack_on_the_card_matches_the_cpu(cuda):
    """train_improved_system on the card and on the CPU from the same
    seeded inits: responsibilities within 1e-4, labels equal, the
    likelihood within 1e-5 relative; the head stage from the card's
    detector within 1e-5 relative of the CPU's."""
    from vqvaehmm_tpu_torch.models.gmm import prepare_regime_features
    from vqvaehmm_tpu_torch.train.gmm_pipeline import (
        load_improved_system, train_improved_system)

    rng = np.random.default_rng(0)
    returns = rng.normal(5e-4, 0.01, size=(800, 6)).astype(np.float32)
    kw = dict(hidden_dim=16, num_epochs=30, log_fn=None)
    card = train_improved_system(returns, device=cuda, **kw)
    cpu = train_improved_system(returns, device="cpu", **kw)
    feats = prepare_regime_features(returns)
    np.testing.assert_allclose(card.detector.gmm.lls_, cpu.detector.gmm.lls_,
                               rtol=1e-5)
    np.testing.assert_allclose(card.detector.predict_proba(feats),
                               cpu.detector.predict_proba(feats), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(card.detector.predict_regime(feats),
                                  cpu.detector.predict_regime(feats))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        card.save(d + "/s.npz")
        det = load_improved_system(d + "/s.npz", device="cpu").detector
    head = train_improved_system(returns, device="cpu", detector=det, **kw)
    np.testing.assert_allclose(card.history, head.history, rtol=1e-5)


# ---------------------------------------------------------------------------
# the bfloat16 throughput configuration: kernel C's bfloat16-operand mode,
# and a bfloat16 model served on the plain path
# ---------------------------------------------------------------------------

BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")


@pytest.mark.parametrize("B,T,beta,short,widths", [
    (64, 200, 1.0, None, {}), (8, 200, 0.5, 150, {}),
    # a last tile of one step at each tile width (16, 32, 64)
    (2, 17, 0.5, 13, {}), (20, 33, 0.5, 25, {}), (70, 129, 0.5, 97, {}),
    (1, 1, 1.0, None, {}),
    # hidden 16/8 with K=2 and trans_hidden 20, (mu, logvar) the widest
    (3, 40, 0.5, 30, dict(input_dim=12, hidden_dim=16, hidden_dim2=8, K=2,
                          trans_hidden=20)),
    # H2 > H1, K=16, and C, 2C and HP that are not multiples of 16, on
    # enough sequences that one activation rounded to the other bfloat16
    # does not weigh 5e-4 of a gradient (chip_smoke.py BF16_WIDTH_CASES)
    (32, 50, 0.5, 40, dict(input_dim=7, hidden_dim=24, hidden_dim2=40, K=16,
                           trans_hidden=36))])
def test_fused_train_bf16_matches_plain(cuda, B, T, beta, short, widths):
    """Kernel C's bfloat16 mode (the tensor-core kernels) against its
    plain version (compute_loss(bf16_operands=True) and autograd) at the
    float32 mode's tile edges and widths: loss within BF16_LOSS_TOL
    relative, gradients within BF16_GRAD_TOL of each leaf's largest entry
    (a float32 sum in another order can move an activation across a
    bfloat16 rounding boundary, by 2^-8 of it); at the published widths
    and (64, 200) or (8, 200) the float32 mode's gradients at least 10x
    that away; the same bits on a second call."""
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_grads, fused_loss_and_grads_reference)

    widths = {**dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128),
              **widths}
    m16 = _model(cuda, seed=4, **widths, **BF16)
    m32 = _model(cuda, seed=4, **widths)
    x, u, lens = _train_inputs(cuda, B, T, B * 7 + T, C=m16.cfg.input_dim,
                               short=short)
    before = (fused_loss_and_grads.launches,
              fused_loss_and_grads.bf16_launches)
    loss, grads = fused_loss_and_grads(m16, x, u, lens, beta)
    want_loss, want = fused_loss_and_grads_reference(m16, x, u, lens, beta)
    _, g32 = fused_loss_and_grads(m32, x, u, lens, beta)
    torch.cuda.synchronize()
    assert (fused_loss_and_grads.launches - before[0],
            fused_loss_and_grads.bf16_launches - before[1]) == (2, 1)
    assert abs(float(loss) - float(want_loss)) \
        <= BF16_LOSS_TOL * abs(float(want_loss))
    gap32 = 0.0
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((grads[name] - w).abs().max())
        assert err <= BF16_GRAD_TOL * scale, (name, err)
        if scale > 0:
            gap32 = max(gap32, float((g32[name] - grads[name]).abs().max())
                        / scale)
    if T == 200:
        assert gap32 >= 10 * BF16_GRAD_TOL
    loss2, grads2 = fused_loss_and_grads(m16, x, u, lens, beta)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)


@pytest.mark.parametrize("B,T,short,widths", [
    (2, 37, 28, dict(input_dim=16, hidden_dim=256, hidden_dim2=128, K=8,
                     trans_hidden=256)),
    (4, 50, 40, dict(input_dim=7, hidden_dim=24, hidden_dim2=40, K=16,
                     trans_hidden=36))])
def test_fused_train_bf16_short_batches_within_float32_orders(
        cuda, B, T, short, widths):
    """Short batches where one activation that a float32 order of the sums
    rounds to the other bfloat16 moves a gradient by about BF16_GRAD_TOL
    of its leaf's largest entry or more (the probe's widths on 2 x 37
    steps, K=16 on 4 x 50; chip_smoke.py BF16_ORDER_CASES): on
    ORDER_INPUTS inputs the loss within BF16_LOSS_TOL, a second call
    bit-equal, and the kernel's gradient error, at the worst input and at
    the median, at most the larger of BF16_GRAD_TOL and ORDER_MULT times
    the plain versions' own spread on the same inputs (the CPU's
    compute_loss and autograd and its tiled version, each against the
    card's plain version)."""
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_grads, fused_loss_and_grads_reference,
        fused_loss_and_grads_tiled)

    m16 = _model(cuda, seed=6, u_dim=4, **widths, **BF16)
    cpu = _model("cpu", seed=6, u_dim=4, **widths, **BF16)

    def share(got, want):
        return max(float((got[n].cpu() - w.cpu()).abs().max())
                   / float(w.abs().max())
                   for n, w in want.items() if float(w.abs().max()) > 0)

    kern, spread = [], []
    for seed in range(ORDER_INPUTS):
        x, u, lens = _train_inputs(cuda, B, T, 100 * B + seed,
                                   C=widths["input_dim"], short=short)
        loss, grads = fused_loss_and_grads(m16, x, u, lens, 0.5)
        want_loss, want = fused_loss_and_grads_reference(m16, x, u, lens, 0.5)
        args = (cpu, x.cpu(), u.cpu(), lens.cpu(), 0.5)
        _, ref = fused_loss_and_grads_reference(*args)
        _, tiled = fused_loss_and_grads_tiled(*args, 16, splits=1)
        assert abs(float(loss) - float(want_loss)) \
            <= BF16_LOSS_TOL * abs(float(want_loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        if seed == 0:
            loss2, grads2 = fused_loss_and_grads(m16, x, u, lens, 0.5)
            assert torch.equal(loss, loss2)
            assert all(torch.equal(grads[n], grads2[n]) for n in grads)
        kern.append(share(grads, want))
        spread.append(max(share(ref, want), share(tiled, want)))
    for pick in (max, statistics.median):
        assert pick(kern) <= max(BF16_GRAD_TOL, ORDER_MULT * pick(spread)), \
            (kern, spread)


def test_fused_train_bf16_kernels_use_tensor_cores(cuda):
    """The bfloat16 mode's forward, backward and weight-gradient kernels
    issue tensor-core instructions (HMMA in the built library's SASS);
    the float32 mode's five kernels and the pack kernels issue none."""
    from vqvaehmm_tpu_torch.ops import _build

    names = ("train_forward_bf16_kernel", "train_backward_bf16_kernel",
             "train_weight_grad_bf16_kernel", "train_pack_bf16_kernel",
             "train_pack_kernel", "train_forward_kernel",
             "train_backward_kernel", "train_weight_grad_kernel",
             "train_reduce_kernel")
    hmma = _build.sass_counts(names)
    for name in names[:3]:
        assert hmma[name] > 0, hmma
    for name in names[3:]:
        assert hmma[name] == 0, hmma


# kernel C's bfloat16 mode against its plain version on the card: the
# loss's relative error and a gradient's share of its leaf's largest entry
# (see test_fused_train_bf16_matches_plain; chip_smoke.py phase 29 states
# the same bars with their measurements)
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-4, 5e-4
# the short batches' inputs, and the multiple of the plain versions' spread
# their gradients are held to (chip_smoke.py ORDER_INPUTS, ORDER_MULT)
ORDER_INPUTS, ORDER_MULT = 6, 2.0


def test_fused_train_float32_mode_unchanged_by_bf16_calls(cuda):
    """The float32 mode gives the same bits before and after calls of the
    bfloat16 mode on the same weights and inputs (nothing of one mode's
    packed weights or scratch reaches the other)."""
    from vqvaehmm_tpu_torch.ops.fused_train import fused_loss_and_grads

    widths = dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128)
    m32 = _model(cuda, seed=8, **widths)
    m16 = _model(cuda, seed=8, **widths, **BF16)
    x, u, lens = _train_inputs(cuda, 16, 96, 3)
    first = fused_loss_and_grads(m32, x, u, lens, 1.0)
    fused_loss_and_grads(m16, x, u, lens, 1.0)
    again = fused_loss_and_grads(m32, x, u, lens, 1.0)
    assert torch.equal(first[0], again[0])
    assert all(torch.equal(first[1][n], again[1][n]) for n in first[1])


def test_bf16_model_serving_launches_no_float32_kernel(cuda, tmp_path):
    """A bfloat16 model's /infer in four modes, /predict and a stream
    frame launch kernels A, 8 and 11 no time; kernel B once a viterbi
    request.  use_kernel=True on it raises."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    m = InferenceModel(_serving_config(tmp_path, cuda, seed=3,
                                       hidden_dim=64, hidden_dim2=32,
                                       **BF16), device=cuda)
    assert m.model.compute_dtype == torch.bfloat16
    rng = np.random.default_rng(5)
    x, u = rng.normal(size=(5, 60)).tolist(), rng.normal(size=(4, 60)).tolist()
    before = (fused_forward.launches, fused_encode.launches,
              fused_evidence.launches, viterbi_fused.launches)
    for mode in ("mean_field", "smoothed", "filtered", "viterbi"):
        out = m.infer(x, u=u, mode=mode)
        assert np.isfinite(np.asarray(out["regime_probs"])).all()
    m.predict(x)
    m.stream("s", x_t=[r[0] for r in x], u_t=[r[0] for r in u])
    with torch.inference_mode():
        m.model.posterior(torch.tensor([x], dtype=torch.float32,
                                       device=cuda))
    after = (fused_forward.launches, fused_encode.launches,
             fused_evidence.launches, viterbi_fused.launches)
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 1]
    xt = torch.zeros(1, 5, 8, device=cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="float32"):
            m.model.infer_forward(xt, use_kernel=True)
        with pytest.raises(ValueError, match="float32"):
            fused_encode(m.model, xt, use_kernel=True)


def test_bf16_batched_rows_within_tolerance_of_solo(cuda, tmp_path):
    """A bfloat16 model's micro-batched rows against the same requests
    served solo: within BF16_ROW_TOL of each output's magnitude (the
    plain path's bfloat16 convolutions may add in another order at another
    batch size, and a bfloat16 rounding then moves a value by up to
    2^-8 of it); one dispatch a group."""
    import concurrent.futures

    from vqvaehmm_tpu_torch.serve.app import InferenceModel
    from vqvaehmm_tpu_torch.serve.batching import BatchingModel

    m = InferenceModel(_serving_config(tmp_path, cuda, seed=7,
                                       hidden_dim=64, hidden_dim2=32,
                                       **BF16), device=cuda)
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(5, int(T))).tolist()
          for T in rng.integers(65, 129, size=8)]
    solo = [m.infer(x) for x in xs]
    b = BatchingModel(m, max_batch=8, max_wait_ms=10000.0)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            got = list(ex.map(b.infer, xs))
        assert b.dispatches == 1
        for g, s in zip(got, solo):
            for key in ("mu", "logvar", "regime_probs"):
                a, w = np.asarray(g[key]), np.asarray(s[key])
                bar = BF16_ROW_TOL * np.maximum(np.abs(w), 1.0)
                assert np.all(np.abs(a - w) <= bar), key
    finally:
        b.close()


# a batched bfloat16 row's share of its solo value's magnitude (at least 1)
BF16_ROW_TOL = 2 ** -6


# -- the rest of the downstream zoo and the recipe's eval stage ------------

ZOO = ("AttentionPortfolioOptimizer", "TransformerPortfolioOptimizer",
       "BayesianPortfolioOptimizer", "EnsemblePortfolioOptimizer",
       "HierarchicalPortfolioOptimizer", "RegimeLSTMOptimizer",
       "RegimeChangeDetector", "ForwardTransitionPredictor",
       "RegimePersistenceModel", "RegimeFactorModel")


def _zoo_model(name, dev, seed=0):
    from vqvaehmm_tpu_torch.models import portfolio as P
    from vqvaehmm_tpu_torch.models import regime as R

    g = torch.Generator().manual_seed(seed)
    if hasattr(P, name):
        return getattr(P, name)(P.HeadConfig(3, 6, 16), device=dev,
                                generator=g)
    if name == "RegimeFactorModel":
        return R.RegimeFactorModel(3, 6, device=dev, generator=g)
    return getattr(R, name)(3, hidden_dim=16, device=dev, generator=g)


def _zoo_out(name, m, q, A):
    if name == "RegimePersistenceModel":
        return m(q, A)
    if name == "RegimeFactorModel":
        return m.get_covariance(q)
    return m(q)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_model_on_the_card_matches_the_cpu(cuda, name):
    """Forward in eval() mode and the gradients of a train() mode step,
    the card against the CPU within 1e-5, from one seeded draw."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.dirichlet(np.ones(3), size=(8, 30))
                         .astype(np.float32)).transpose(1, 2).contiguous()
    A = torch.from_numpy(rng.dirichlet(np.ones(3), size=3)
                         .astype(np.float32))
    out = []
    for d in (cuda, torch.device("cpu")):
        m = _zoo_model(name, d)
        with torch.no_grad():
            y = _zoo_out(name, m.eval(), q.to(d), A.to(d)).cpu()
        m.train()
        (_zoo_out(name, m, q.to(d), A.to(d)) ** 2).mean().backward()
        # the Bayesian head's deterministic call leaves fc1_logvar off
        out.append((y, {k: p.grad.cpu() for k, p in m.named_parameters()
                        if p.grad is not None}))
    (y_card, g_card), (y_cpu, g_cpu) = out
    torch.testing.assert_close(y_card, y_cpu, rtol=0, atol=1e-5)
    assert sorted(g_card) == sorted(g_cpu)
    for k, g in g_cpu.items():
        torch.testing.assert_close(g_card[k], g, rtol=0, atol=1e-5)


def test_strategies_on_the_card_match_the_cpu(cuda):
    """20 online updates, 3 walk-forward windows and two MAML meta steps
    (an MLP head, and the LSTM head with cuDNN off for the meta step)."""
    from vqvaehmm_tpu_torch.losses.portfolio import sharpe_loss
    from vqvaehmm_tpu_torch.models.portfolio import (
        HeadConfig, HierarchicalPortfolioOptimizer, RegimeLSTMOptimizer)
    from vqvaehmm_tpu_torch.train.strategies import (
        MetaPortfolioOptimizer, OnlinePortfolioOptimizer, WalkForwardTrainer)

    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.dirichlet(np.ones(3), size=120)
                         .astype(np.float32))
    qs = torch.from_numpy(rng.dirichlet(np.ones(3), size=(64, 12))
                          .astype(np.float32)).transpose(1, 2).contiguous()
    rets = torch.from_numpy(rng.normal(5e-4, 0.01, size=(120, 10, 6))
                            .astype(np.float32))
    cfg = HeadConfig(3, 6, 16)

    def run(d):
        g = torch.Generator
        h1 = HierarchicalPortfolioOptimizer(cfg, device=d,
                                            generator=g().manual_seed(1))
        on = OnlinePortfolioOptimizer(h1, lr=1e-3)
        losses = [on.update(q[i::20], rets[i::20]) for i in range(20)]
        h2 = HierarchicalPortfolioOptimizer(cfg, device=d,
                                            generator=g().manual_seed(2))
        wf = WalkForwardTrainer(h2, sharpe_loss, train_window=48,
                                test_window=16, retrain_freq=16).run(
            (q, rets), n_periods=3)
        h3 = HierarchicalPortfolioOptimizer(cfg, device=d,
                                            generator=g().manual_seed(3))
        tasks = [((q[i:i + 16], rets[i:i + 16]),
                  (q[i + 16:i + 32], rets[i + 16:i + 32])) for i in (0, 40)]
        meta = MetaPortfolioOptimizer(h3, inner_lr=0.05, outer_lr=0.01,
                                      n_inner=3)
        ml = [meta.meta_update(tasks, sharpe_loss) for _ in range(2)]
        h4 = RegimeLSTMOptimizer(cfg, device=d, generator=g().manual_seed(4))
        seq = [((qs[i:i + 16], rets[i:i + 16]),
                (qs[i + 16:i + 32], rets[i + 16:i + 32])) for i in (0, 32)]
        ml.append(MetaPortfolioOptimizer(h4, n_inner=2).meta_update(
            seq, sharpe_loss))
        params = [p.detach().cpu() for h in (h1, h2, h3, h4)
                  for p in h.parameters()]
        return losses, wf, ml, params

    card, cpu = run(cuda), run(torch.device("cpu"))
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4, atol=1e-6)
    for g, w in zip(card[1], cpu[1]):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4 * max(1.0, abs(w[k])), k
    np.testing.assert_allclose(card[2], cpu[2], rtol=1e-4, atol=1e-6)
    for a, b in zip(card[3], cpu[3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_calibrate_regime_thresholds_on_the_encoder_kernel(cuda):
    """posterior_fn = VAEHMM.posterior: one kernel-8 launch, thresholds
    within 1e-5 of the CPU's."""
    from vqvaehmm_tpu_torch.calibration import calibrate_regime_thresholds
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(24, 5, 60)).astype(np.float32))
    true = rng.integers(0, 3, size=24)
    card, cpu = _model(cuda, seed=3), _model(torch.device("cpu"), seed=3)
    before = fused_encode.launches
    with torch.inference_mode():
        got = calibrate_regime_thresholds(card.posterior, x.to(cuda), true,
                                          3)
        assert fused_encode.launches == before + 1
        want = calibrate_regime_thresholds(cpu.posterior, x, true, 3)
    for k in range(3):
        assert abs(got[k] - want[k]) <= 1e-5


def test_recipe_eval_stage_on_the_serving_kernel(cuda, tmp_path):
    """The recipe's eval stage on the card: one kernel-A launch a batch
    of 32, 4 batches a checkpoint, and the MSE of each within 1e-5
    relative of the CPU's."""
    import os
    import shutil

    from vqvaehmm_tpu_torch import recipe

    out = str(tmp_path)
    recipe.stage_data(out)
    for tag, quality in (("published", False), ("quality", True)):
        cfg = recipe.recipe_config(out, quality)
        recipe._write_config(cfg, f"{out}/config_{tag}.json")
        ck = cfg.training.checkpoint_dir
        os.makedirs(ck)
        shutil.copyfile(f"{recipe.CHECKPOINT_DIR}/vae_hmm_trained.npz",
                        f"{ck}/vae_hmm_trained.npz")
    before = fused_forward.launches
    got = recipe.stage_eval(out, cuda)
    assert fused_forward.launches == before + 8
    want = recipe.stage_eval(out, torch.device("cpu"))
    assert sorted(got) == ["published", "quality"]
    for tag in got:
        assert abs(got[tag] - want[tag]) <= 1e-5 * want[tag]


@pytest.mark.parametrize("dtype,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-5), ("bfloat16", 1e-4, 5e-4)])
def test_fused_train_global_norm_halves_sum_to_the_whole(cuda, dtype,
                                                         loss_tol, grad_tol):
    """Kernel C's global-normalisation mode (data parallelism): two halves
    of a batch whose second half's longest row is short, each with the
    whole batch's norm, summed: the whole batch's loss and gradients
    within the bars of chip_smoke.py phase 32; the sentinel call bit-equal
    to the call given the batch's own norm; each half against its plain
    version in the same mode."""
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_flat_grads, global_norm)

    model = _model(cuda, hidden_dim=64, hidden_dim2=32, trans_hidden=128,
                   compute_dtype=dtype)
    rng = np.random.default_rng(16)
    B, T = 16, 96
    x = torch.from_numpy(rng.normal(size=(B, 5, T)).astype(np.float32)
                         ).to(cuda)
    u = torch.from_numpy(rng.normal(size=(B, 4, T)).astype(np.float32)
                         ).to(cuda)
    lens = rng.integers(20, T + 1, size=B).astype(np.int32)
    lens[0], lens[B // 2:] = T, np.minimum(lens[B // 2:], 50)
    lens = torch.from_numpy(lens).to(cuda)
    norm = global_norm(lens, T)
    halves = (slice(0, B // 2), slice(B // 2, B))
    whole_loss, whole = fused_loss_and_flat_grads(model, x, u, lens, 0.7,
                                                  use_kernel=True)
    own = fused_loss_and_flat_grads(model, x, u, lens, 0.7, use_kernel=True,
                                    norm=norm)
    assert torch.equal(own[0], whole_loss) and torch.equal(own[1], whole)
    parts = [fused_loss_and_flat_grads(model, x[h], u[h], lens[h], 0.7,
                                       use_kernel=True, norm=norm)
             for h in halves]
    loss = parts[0][0] + parts[1][0]
    assert abs(float(loss - whole_loss)) <= loss_tol * abs(float(whole_loss))
    flat = parts[0][1] + parts[1][1]
    assert float((flat - whole).abs().max()) <= \
        grad_tol * float(whole.abs().max())
    for h, (pl, pf) in zip(halves, parts):
        wl, wf = fused_loss_and_flat_grads(model, x[h], u[h], lens[h], 0.7,
                                           use_kernel=False, norm=norm)
        assert abs(float(pl - wl)) <= loss_tol * abs(float(wl))
        assert float((pf - wf).abs().max()) <= \
            10 * grad_tol * float(wf.abs().max())


# ---------------------------------------------------------------------------
# The bfloat16-operand mode of kernels A, 8, 11 and 10: a float32 model at
# a matmul_precision other than "highest" (ops/fused_train.py::
# infer_bf16_mode).  The bars are chip_smoke.py's (phase 36): the mode
# against its plain version, which rounds the same operands and sums in
# float32 in another order, agrees within BF16_INFER_EXACT but where such
# a sum moves an operand across a bfloat16 rounding boundary; there an
# output moves by up to BF16_INFER_TOL[output] of its largest magnitude
# (at least 1), each about four times the largest share measured on the
# card (2^-8 for mu), at no more than BF16_INFER_SHARE of the values.
# ---------------------------------------------------------------------------

DEFAULT = dict(matmul_precision="default")
BF16_INFER_EXACT, BF16_INFER_SHARE = 1e-5, 0.02
BF16_INFER_TOL = {"mu": 2 ** -8, "logvar": 2e-3, "q": 6e-5,
                  "logits": 2.6e-4, "log_A": 5e-4, "log_obs": 1.4e-4}


def _bf16_gap(got, want):
    """(max-abs error as a share of max(1, |want|), share of values past
    BF16_INFER_EXACT) of one output of the mode against its plain
    version."""
    diff = (got.double() - want.double()).abs()
    scale = max(1.0, float(want.abs().max()))
    return (float(diff.max()) / scale,
            float((diff > BF16_INFER_EXACT).double().mean()))


def _bf16_counts():
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    return [(f.launches, f.bf16_launches) for f in (
        fused_forward, fused_encode, fused_evidence, fused_viterbi_states)]


# widths whose bfloat16-mode weights are resident at the narrowest tile
# and stream through the ring at the wider ones (kernel A: ring at tiles
# 32 and 64; kernel 11: at 64), so that the tiles' bits hold the ring to
# the resident path
RING_WIDTHS = dict(hidden_dim=96, hidden_dim2=136, trans_hidden=384)


@pytest.mark.parametrize("widths", [
    dict(), dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128),
    dict(input_dim=7, hidden_dim=24, hidden_dim2=40, K=5, trans_hidden=36),
    RING_WIDTHS])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 37), (64, 200), (2, 600)])
def test_inference_bf16_matches_plain(cuda, widths, B, T, record_property):
    """Each of the four kernels in the mode against its plain version
    (use_kernel=False on the card, the references with
    bf16_operands=True): the outputs within the mode's bars, the decode
    bit-equal to kernel 11 -> kernel B and equal to the plain decode or
    tied; one launch each, counted in both counts.  Both designs of 8
    and 10 (the weights read from L2, and staged in shared memory where
    the plan keeps that design) give those same bits.  The same weights at
    "highest" take the float32 kernels, which the mode's count skips.
    Each output's readings (its share of the scale, its share of values
    past BF16_INFER_EXACT) are recorded as a property of the case, which
    --junitxml writes out."""
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe
    from vqvaehmm_tpu_torch.ops.fused_decode import (
        fused_evidence, fused_evidence_reference, fused_viterbi_states,
        fused_viterbi_states_reference)
    from vqvaehmm_tpu_torch.ops.fused_encoder import (fused_encode,
                                                      fused_encode_reference)

    model = _model(cuda, seed=21, **widths, **DEFAULT)
    C = model.cfg.input_dim
    x, u, lens = _train_inputs(cuda, B, T, B * 7 + T, C=C)
    before = _bf16_counts()
    with torch.inference_mode():
        got_a = fused_forward(model, x, valid_to=lens)
        got_8 = fused_encode(model, x, valid_to=lens)
        got_11 = fused_evidence(model, x, u, lens)
        states = fused_viterbi_states(model, x, u, lens)
        after = _bf16_counts()
        two_stage = viterbi_fused(*got_11, lens).states
        want_a = fused_forward_reference(model, x, valid_to=lens,
                                         bf16_operands=True)
        assert all(torch.equal(g, w) for g, w in zip(want_a, fused_forward(
            model, x, valid_to=lens, use_kernel=False)))
        want_8 = fused_encode_reference(model, x, valid_to=lens,
                                        bf16_operands=True)
        want_11 = fused_evidence_reference(model, x, u, lens,
                                           bf16_operands=True)
        plain = fused_viterbi_states_reference(model, x, u, lens,
                                               bf16_operands=True)
        f32 = _model(cuda, seed=21, **widths)
        f32_a = fused_forward(f32, x, valid_to=lens)
        assert _bf16_counts()[0] == (after[0][0] + 1, after[0][1])
        designs_8, designs_10 = _two_designs(model, x, u, lens)
    assert after == [(n + 1, m + 1) for n, m in before]
    for lg in designs_8:
        assert torch.equal(lg, got_8)
    for st in designs_10:
        assert torch.equal(st, states)
    gaps = {}
    for g, w, name in zip((*got_a, got_8, *got_11[1:]),
                          (*want_a, want_8, *want_11[1:]),
                          ("mu", "logvar", "q", "logits", "log_A",
                           "log_obs")):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        gaps[name] = _bf16_gap(g, w)
        record_property(name, gaps[name])
    for name, (share, past) in gaps.items():
        assert share <= BF16_INFER_TOL[name], (name, share)
        assert past <= BF16_INFER_SHARE, (name, past)
    assert torch.equal(got_11[0], want_11[0])
    assert not torch.equal(f32_a[0], got_a[0])
    assert torch.equal(states, two_stage)
    if not torch.equal(states, plain):
        # a path optimal under the kernel's evidence scores within twice
        # the two evidences' gap, summed over the steps, of the optimum
        full = lens.long()
        sg = _path_scores(*want_11, states, full).double()
        sw = _path_scores(*want_11, plain, full).double()
        slack = 2 * ((got_11[1] - want_11[1]).abs().amax(dim=(2, 3)).sum(1)
                     + (got_11[2] - want_11[2]).abs().amax(dim=2).sum(1))
        assert bool(((sg - sw).abs() <= 1e-4 + slack.double()).all())


def _two_designs(model, x, u, lens):
    """Kernel 8's logits from each of its designs in the mode (the first,
    and the second where its weights are resident or on a ring, on its
    plan's grid, on one block and on seven) at the plan's tile, and
    kernel 10's states from each of its designs (the first, and the plan's
    where that is the second), each design one launch."""
    from vqvaehmm_tpu_torch.ops import _build
    from vqvaehmm_tpu_torch.ops import fused_decode as fd
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe

    B, _, T = x.shape
    dims = fe.encoder_dims(model.cfg)
    sms = _build.sm_count(x.device)
    first = fe.plan_for(B, T, dims, sms, bf16=True)
    second = fe.encode_staged(first, dims, sms)
    grids = [0] + ([] if second is None else sorted(
        {second.grid, 1, min(7, second.blocks)}))
    logits = []
    for grid in grids:
        lg = torch.empty((B, model.cfg.K, T), device=x.device)
        fe._launch(model, x, lens, first.tile, lg, True, grid)
        logits.append(lg)
    states = [_first_decode(model, x, u, lens)]
    if fd.decode_plan(model, B, T, x.device, True).weights == "resident":
        states.append(fd.fused_viterbi_states(model, x, u, lens))
    return logits, states


def _first_decode(model, x, u, lens=None):
    """Kernel 10's states in the mode from its first design, one launch."""
    from vqvaehmm_tpu_torch.ops import fused_decode as fd

    B, _, T = x.shape
    plan = fd.decode_plan(model, B, T, x.device, True, staged=False)
    assert plan.weights == "direct"
    return fd._launch_decode(model, x.contiguous(), u, lens, plan, True)


@pytest.mark.parametrize("widths", ["published", "ring"])
@pytest.mark.parametrize("B,T", [(3, 37), (64, 200), (460, 20), (1, 2327)])
def test_inference_bf16_tiles_and_rows_bit_equal(cuda, B, T, widths):
    """In the mode every tile width (and split) of kernels A, 8 and 11
    gives the same bits, whatever the grid that walks the items (kernels
    A and 8 on a persistent grid of 1 and 7 blocks too) and wherever the
    weights are read from (kernels 8 and 11 staged and from L2), and a row
    of a batch of A, 8, 11 and 10 (each design of 8 and 10) is bit-equal
    to the row alone: each output's sum is one fixed sequence of chunks
    wherever its step sits in a tile or a halo and wherever its weights
    were read from (shared memory, the ring, L2)."""
    from vqvaehmm_tpu_torch.ops import fused_decode as fd
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe
    from vqvaehmm_tpu_torch.ops import fused_infer as fi

    w = RING_WIDTHS if widths == "ring" else dict(
        hidden_dim=64, hidden_dim2=32, trans_hidden=128)
    model = _model(cuda, seed=22, **w, **DEFAULT)
    cfg = model.cfg
    kinds = {fi.bf16_stage(t, 5, cfg.hidden_dim, cfg.hidden_dim2, 3,
                           cfg.hidden_dim).weights for t in fi.TILES}
    kinds11 = {fe.evidence_stage(t, fe.encoder_dims(cfg, prior=True))
               .weights for t in fi.TILES}
    assert kinds == kinds11 == ({"resident", "ring"} if widths == "ring"
                                else {"resident"})
    x, u, lens = _train_inputs(cuda, B, T, B + 3 * T, btu=True)
    outs = ([], [], [])
    with torch.inference_mode():
        for tile in fi.TILES:
            items = B * -(-T // tile)
            for grid in sorted({items, min(items, 1), min(items, 7)}):
                a = tuple(torch.empty((B, c, T), device=cuda)
                          for c in (5, 5, 3))
                fi._launch(model, x, lens, tile, a, bf16=True, grid=grid)
                outs[0].append(a)
            # kernel 8's three layers fit beside its operands at both
            assert fe.encode_stage(tile, fe.encoder_dims(cfg)).weights == \
                "resident"
            for grid in sorted({0, items, 1, min(items, 7)}):
                lg = torch.empty((B, 3, T), device=cuda)
                fe._launch(model, x, lens, tile, lg, bf16=True, grid=grid)
                outs[1].append((lg,))
            for split in (False, True):
                for staged in (True, False):
                    ev = (torch.empty((B, T, 3), device=cuda),
                          torch.empty((B, T, 3, 3), device=cuda))
                    fd._launch_evidence(model, x, u, lens, tile, split, ev,
                                        bf16=True, staged=staged)
                    outs[2].append(ev)
        for kind in outs:
            for o in kind[1:]:
                assert all(torch.equal(p, q) for p, q in zip(o, kind[0]))
        whole = (fi.fused_forward(model, x, valid_to=lens),
                 (fe.fused_encode(model, x, valid_to=lens),),
                 fd.fused_evidence(model, x, u)[1:],
                 (fd.fused_viterbi_states(model, x, u),))
        assert torch.equal(whole[3][0], _first_decode(model, x, u))
        # the launches above ran the mode the wrappers run
        for w, kind in zip(whole[:2], outs[:2]):
            assert all(torch.equal(p, q) for p, q in zip(w, kind[0]))
        for i in sorted({0, B // 2, B - 1}):
            r = slice(i, i + 1)
            alone = (fi.fused_forward(model, x[r], valid_to=lens[r]),
                     (fe.fused_encode(model, x[r], valid_to=lens[r]),),
                     fd.fused_evidence(model, x[r], u[r])[1:],
                     (fd.fused_viterbi_states(model, x[r], u[r]),))
            for w, a in zip(whole, alone):
                assert all(torch.equal(p[r], q) for p, q in zip(w, a)), i
            assert torch.equal(whole[3][0][r], _first_decode(
                model, x[r], u[r])), i


# the widths of the designs' test: the published model, its C = 16 twin,
# and the probe's (C = 16, hidden 256/128, K = 8), whose kernel-8 weights
# stream through the ring and whose kernel-10 weights do not fit beside
# its stage (the first design alone)
DESIGN_WIDTHS = {
    "published": dict(hidden_dim=64, hidden_dim2=32, trans_hidden=128),
    "c16": dict(input_dim=16, hidden_dim=64, hidden_dim2=32,
                trans_hidden=128),
    "probe": dict(input_dim=16, hidden_dim=256, K=8, hidden_dim2=128,
                  trans_hidden=256)}


@pytest.mark.parametrize("widths", sorted(DESIGN_WIDTHS))
@pytest.mark.parametrize("B,T", [(64, 200), (1, 200), (460, 20),
                                 (1, 2327)])
def test_inference_bf16_designs_bit_equal(cuda, B, T, widths):
    """Kernels 8 and 10 in the mode: the second design (the weights staged
    in shared memory: kernel 8 resident or on a ring, on its plan's grid
    and on 1 and 7 blocks; kernel 10 resident) gives the first design's
    bits, and kernel 10's evidence is kernel 11's (its states those of
    kernel 11 -> kernel B); the plans take the designs the widths allow."""
    from vqvaehmm_tpu_torch.ops import fused_decode as fd
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe

    w = DESIGN_WIDTHS[widths]
    model = _model(cuda, seed=24, **w, **DEFAULT)
    C, K = model.cfg.input_dim, model.cfg.K
    x, u, lens = _train_inputs(cuda, B, T, B + 5 * T, C=C)
    dims = fe.encoder_dims(model.cfg)
    stage = fe.encode_stage(fe.encode_plan(model.cfg, B, T, bf16=True).tile,
                            dims)
    assert stage.weights == ("ring" if widths == "probe" else "resident")
    with torch.inference_mode():
        logits, states = _two_designs(model, x, u, lens)
        ev = fd.fused_evidence(model, x, u, lens)
        two_stage = viterbi_fused(*ev, lens).states
        plan = fd.decode_plan(model, B, T, cuda, True)
    assert len(logits) >= 2 and all(torch.equal(lg, logits[0])
                                    for lg in logits)
    assert len(states) == (1 if widths == "probe" else 2)
    assert plan.weights == ("direct" if widths == "probe" else "resident")
    for st in states:
        assert torch.equal(st, two_stage)
    assert logits[0].shape == (B, K, T)


def test_inference_bf16_stream_bit_equal_to_batch(cuda, tmp_path):
    """A default-precision model's /stream session (kernel 11's mode on
    each step's window): every settled column bit-equal to the card's
    batch filtered posterior, which runs the same mode on the whole
    sequence; 3T - 3 evidence steps, all in the mode."""
    import json

    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    path = _serving_config(tmp_path, cuda, seed=9, hidden_dim=64,
                           hidden_dim2=32, trans_hidden=128)
    cfg = json.loads(open(path).read())
    cfg["model"]["matmul_precision"] = "default"
    open(path, "w").write(json.dumps(cfg))
    m = InferenceModel(path, device=cuda)
    rng = np.random.default_rng(13)
    T = 40
    x = rng.normal(size=(5, T)).astype(np.float32)
    u = rng.normal(size=(4, T)).astype(np.float32)
    n0 = (fused_evidence.launches, fused_evidence.bf16_launches)
    got = {}
    for t in range(T):
        out = m.stream("s", x_t=x[:, t].tolist(), u_t=u[:, t].tolist(),
                       finish=t == T - 1)
        got.update({d["t"]: d["regime_probs"] for d in out["settled"]})
    assert (fused_evidence.launches - n0[0],
            fused_evidence.bf16_launches - n0[1]) == (3 * T - 3, 3 * T - 3)
    with torch.inference_mode():
        batch = m.model.filtered_posterior(
            torch.from_numpy(x)[None].to(cuda),
            torch.from_numpy(u)[None].to(cuda),
            torch.tensor([T], device=cuda))[0].cpu()
    assert sorted(got) == list(range(T))
    assert torch.equal(torch.tensor([got[t] for t in range(T)]).T, batch)


def test_inference_bf16_kernel_a_reads_l2_at_its_gate_edge(cuda):
    """Kernel A of the mode at the widest operand its gate takes: no room
    beside the operands for even two ring slots, so its weights are read
    from L2 (tile_mma.cuh::staged_layer's DIRECT); the outputs within the
    mode's bars of its plain version, one launch in the mode."""
    from vqvaehmm_tpu_torch.ops import fused_infer as fi

    edge = max(h for h in range(16, 4000, 16)
               if fi.operand_bytes(16, 5, 8, h, 3, 8) <= SMEM_LIMIT)
    model = _model(cuda, seed=23, hidden_dim=8, hidden_dim2=edge, **DEFAULT)
    assert fi.launch_plan(1, 12, 5, 8, edge, 3, 8, bf16=True).weights == \
        "direct"
    x, _, lens = _train_inputs(cuda, 1, 12, 24)
    before = (fused_forward.launches, fused_forward.bf16_launches)
    with torch.inference_mode():
        got = fused_forward(model, x, valid_to=lens)
        want = fused_forward_reference(model, x, valid_to=lens,
                                       bf16_operands=True)
    assert (fused_forward.launches, fused_forward.bf16_launches) == \
        (before[0] + 1, before[1] + 1)
    for g, w, name in zip(got, want, ("mu", "logvar", "q")):
        assert bool(torch.isfinite(g).all()), name
        share, past = _bf16_gap(g, w)
        assert share <= BF16_INFER_TOL[name], (name, share)


def test_inference_bf16_first_designs_at_their_edges(cuda):
    """Kernels 8 and 10 of the mode where their second design gives way:
    kernel 8 at the widest operand its gate takes (no room beside the
    operands for two ring slots) runs its first design, the weights read
    from L2; kernel 10's plan stages its weights only where that keeps the
    first design's tiles a block, so over growing batches it takes the
    second design, then the first from the batch where staging would need
    more tiles a block, and refuses no batch the first design takes.  The
    outputs within the mode's bars of their plain versions, each launch
    counted in the mode and in the design it ran."""
    from vqvaehmm_tpu_torch.ops import fused_decode as fd
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_viterbi_states
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    wide = _model(cuda, seed=25, hidden_dim=8, hidden_dim2=2880, **DEFAULT)
    plan = fe.encode_plan(wide.cfg, 1, 12, bf16=True)
    assert (plan.tile, plan.weights, plan.grid) == (16, "direct", 0)
    x, u, lens = _train_inputs(cuda, 1, 12, 25)
    n0 = (fused_encode.bf16_launches, fused_encode.staged_launches)
    with torch.inference_mode():
        got = fused_encode(wide, x, valid_to=lens)
        want = fe.fused_encode_reference(wide, x, valid_to=lens,
                                         bf16_operands=True)
    assert (fused_encode.bf16_launches, fused_encode.staged_launches) == \
        (n0[0] + 1, n0[1])
    share, _ = _bf16_gap(got, want)
    assert share <= BF16_INFER_TOL["logits"]
    model = _model(cuda, seed=26, hidden_dim=64, hidden_dim2=32,
                   trans_hidden=128, **DEFAULT)
    T, kinds, edge = 2000, [], None
    for B in range(8, 400, 8):
        try:
            first = fd.decode_plan(model, B, T, cuda, True, staged=False)
        except ValueError:
            with pytest.raises(ValueError, match="resident"):
                fd.decode_plan(model, B, T, cuda, True)
            break
        plan = fd.decode_plan(model, B, T, cuda, True)
        kinds.append(plan.weights)
        if plan.weights == "resident":
            assert (plan.tile, plan.ntb, plan.grid) == (
                first.tile, first.ntb, first.grid), B
        else:
            assert plan == first, B
            edge = edge or B
    assert kinds[0] == "resident" and edge is not None
    x, u, lens = _train_inputs(cuda, edge, T, 26)
    n0 = (fused_viterbi_states.bf16_launches,
          fused_viterbi_states.staged_launches)
    with torch.inference_mode():
        states = fused_viterbi_states(model, x, u, lens)
        ev = fd.fused_evidence(model, x, u, lens)
        two_stage = viterbi_fused(*ev, lens).states
    assert (fused_viterbi_states.bf16_launches,
            fused_viterbi_states.staged_launches) == (n0[0] + 1, n0[1])
    assert torch.equal(states, two_stage)


def test_inference_bf16_gates_raise(cuda):
    """A model the mode's gate refuses (operands past a block's shared
    memory at every tile), and a decode grid the mode cannot keep
    resident, raise: no kernel launches and nothing falls back to the
    float32 kernels or to the plain path."""
    from vqvaehmm_tpu_torch.ops.fused_decode import (fused_evidence,
                                                     fused_viterbi_states)
    from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

    wide = _model(cuda, hidden_dim=8, hidden_dim2=3000, **DEFAULT)
    x = torch.zeros((1, 5, 16), device=cuda)
    u = torch.zeros((1, 4, 16), device=cuda)
    before = _bf16_counts()
    with torch.inference_mode():
        with pytest.raises(ValueError, match="bfloat16"):
            fused_forward(wide, x)
        for fn in (fused_encode, lambda m, a: fused_evidence(m, a, u),
                   lambda m, a: fused_viterbi_states(m, a, u)):
            with pytest.raises(ValueError, match="unsupported"):
                fn(wide, x)
        many = _model(cuda, K=8, **DEFAULT)
        with pytest.raises(ValueError, match="resident"):
            fused_viterbi_states(many, torch.zeros((256, 5, 2000),
                                                   device=cuda),
                                 torch.zeros((256, 4, 2000), device=cuda))
    assert _bf16_counts() == before
