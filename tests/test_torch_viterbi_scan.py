"""The segmented max-plus scan of the Viterbi kernels
(vqvaehmm_tpu_torch/ops/fused_viterbi.py::viterbi_segmented_reference, the
plain version of csrc/maxplus_scan.cuh that kernels B and 10 match bit for
bit) against the JAX package's decodes: the lax.scan recursion and the
Pallas kernels (monolithic and chunked) in interpret mode, and against the
port's sequential decode (ops/hmm.py::viterbi).  Both decodes read no
step past a row's length, whatever it holds: the property on which
kernel 11's inert tiles for the Viterbi decode rest.

The scan reassociates the max-plus sums at segment boundaries, so its
scores differ from a sequential recursion by float roundings: they are
held to 1e-4 absolute or 32 float32 roundings of the score (TIE_ATOL,
TIE_ULPS), and its states to equality, or else a path whose score under
the same evidence is within that tolerance of the optimum (a tie).  T runs
over the edges of the segments of each segment length S (4 up to T = 32,
8 up to 128, then 16)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import hmm_inputs, inputs, model_pair, t
from vqvaehmm_tpu.ops import hmm as jax_hmm
from vqvaehmm_tpu.ops.pallas_hmm import viterbi_pallas, viterbi_pallas_tiled
from vqvaehmm_tpu_torch.ops import _build
from vqvaehmm_tpu_torch.ops import hmm as port_hmm
from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence
from vqvaehmm_tpu_torch.ops.fused_viterbi import (
    MAX_LANES, STAGE_BYTES, fold_chunk, num_segments, segment_length,
    viterbi_plan, viterbi_segmented_reference, viterbi_smem_bytes)

TIE_ATOL, TIE_ULPS = 1e-4, 32
# 1, then S - 1, S, S + 1 and 3 S + 2 for S = 4, 8, 16 (S is a function
# of T: the S - 1 of S = 8 is T = 39, that of S = 16 T = 143)
EDGES = (1, 3, 4, 5, 14, 39, 40, 41, 50, 143, 144, 145, 146)


def _shape_log_A(log_A, ndim):
    return {4: log_A, 3: log_A[0], 2: log_A[0, 0]}[ndim]


def _path_score(log_pi, log_A, log_obs, states, L):
    """log p(z, x) in float64 of each row's path over its L valid steps
    (the inert steps past L add nothing), log_A (B, T, K, K)."""
    out = []
    for b in range(states.shape[0]):
        s = np.asarray(states[b], np.int64)
        v = float(log_pi[s[0]]) + float(log_obs[b, 0, s[0]])
        for i in range(1, int(L[b])):
            v += float(log_A[b, i, s[i - 1], s[i]]) + float(log_obs[b, i, s[i]])
        out.append(v)
    return np.array(out)


def _tol(score):
    return np.maximum(TIE_ATOL, TIE_ULPS * np.finfo(np.float32).eps
                      * np.abs(score))


def assert_map_path(got, want_states, want_score, log_pi, log_A4, log_obs,
                    L):
    """got's score within the tolerance of want's, and got's states equal
    to want's or a path scoring within the tolerance of the optimum."""
    want_score = np.asarray(want_score, np.float64)
    gs = got.score.double().numpy()
    assert (np.abs(gs - want_score) <= _tol(want_score)).all(), \
        (gs, want_score)
    g, w = got.states.numpy(), np.asarray(want_states)
    for b in range(g.shape[0]):
        if not np.array_equal(g[b, :L[b]], w[b, :L[b]]):
            sg = _path_score(log_pi, log_A4, log_obs, g[b:b + 1], L[b:b + 1])
            sw = _path_score(log_pi, log_A4, log_obs, w[b:b + 1], L[b:b + 1])
            assert abs(sg[0] - sw[0]) <= _tol(sw)[0], (b, sg, sw)
        # frozen past the length
        assert (g[b, L[b]:] == g[b, L[b] - 1]).all()


@pytest.mark.parametrize("ndim", [4, 3, 2])
def test_segmented_matches_jax_scan_and_pallas(ndim):
    """T = 40: five segments of 8, ragged lengths ending inside and at the
    edge of a segment; the Pallas kernels in interpret mode for the
    per-step log_A (each compiles for about a second on the CPU)."""
    B, T, K = 4, 40, 3
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=ndim)
    lengths[1:] = (1, 16, 29)
    la = _shape_log_A(log_A, ndim)
    la4 = np.broadcast_to(la, (B, T, K, K))
    args = tuple(map(jnp.asarray, (log_pi, la, log_obs, lengths)))
    got = viterbi_segmented_reference(*map(t, (log_pi, la, log_obs,
                                               lengths)))
    assert got.states.dtype == torch.int32 and got.states.shape == (B, T)
    wants = [jax_hmm.viterbi(*args)]
    if ndim == 4:
        wants += [viterbi_pallas(*args, interpret=True),
                  viterbi_pallas_tiled(*args, chunk=16, interpret=True)]
    for want in wants:
        assert_map_path(got, want.states, want.score, log_pi, la4, log_obs,
                        lengths)


@pytest.mark.parametrize("K", [1, 2, 5, 8])
def test_segmented_matches_jax_scan_across_K(K):
    B, T = 3, 145
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=40 + K)
    want = jax_hmm.viterbi(*map(jnp.asarray, (log_pi, log_A, log_obs,
                                              lengths)))
    got = viterbi_segmented_reference(*map(t, (log_pi, log_A, log_obs,
                                               lengths)))
    assert_map_path(got, want.states, want.score, log_pi, log_A, log_obs,
                    lengths)


def test_segmented_matches_jax_scan_at_the_panel_length():
    """T = 2327 (the fixture panel): 146 segments of 16."""
    B, T, K = 2, 2327, 3
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=2327)
    want = jax_hmm.viterbi(*map(jnp.asarray, (log_pi, log_A, log_obs,
                                              lengths)))
    got = viterbi_segmented_reference(*map(t, (log_pi, log_A, log_obs,
                                               lengths)))
    assert_map_path(got, want.states, want.score, log_pi, log_A, log_obs,
                    lengths)


@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("T", EDGES)
def test_segmented_matches_sequential_decode(K, T):
    """Every log_A shape, with and without ragged lengths (a length of 1
    among them), against ops/hmm.py::viterbi, the sequential decode."""
    B = 3
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=K * 997 + T)
    lengths[2] = 1
    for ndim in (4, 3, 2):
        la = _shape_log_A(log_A, ndim)
        la4 = np.broadcast_to(la, (B, T, K, K))
        for L in (None, lengths):
            args = [t(log_pi), t(np.ascontiguousarray(la)), t(log_obs),
                    None if L is None else t(L)]
            got = viterbi_segmented_reference(*args)
            want = port_hmm.viterbi(*args)
            assert_map_path(got, want.states, want.score, log_pi, la4,
                            log_obs, np.full(B, T) if L is None else L)


def _past_length(a, lengths, fill, rng):
    """A copy of a (B, T, ...) with every step t >= lengths[b] replaced:
    NaN, random values, or the inert step (0; log_A the identity)."""
    a = a.copy()
    K = a.shape[-1]
    for b, L in enumerate(lengths):
        tail = a[b, L:]
        if fill == "nan":
            tail[...] = np.nan
        elif fill == "random":
            tail[...] = rng.normal(scale=50.0, size=tail.shape)
        elif a.ndim == 4:
            tail[...] = np.where(np.eye(K, dtype=bool), 0.0, -np.inf)
        else:
            tail[...] = 0.0
    return a


@pytest.mark.parametrize("fill", ["nan", "random", "inert"])
@pytest.mark.parametrize("T", [32, 33, 128, 129, 2327])
@pytest.mark.parametrize("K", [2, 3, 5])
def test_decodes_read_no_step_past_the_length(K, T, fill):
    """The property the evidence kernel's inert tiles rest on: the
    sequential decode and the segmented scan return the same states and
    scores, bit for bit, whatever log_obs and log_A hold past each row's
    length (NaN, random, or the inert values the kernel writes there).
    Ragged lengths: T, 1, and lengths inside and at the edge of a
    segment."""
    B = 5
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=K * 31 + T)
    S = segment_length(T)
    lengths[1:] = (1, max(1, T - S), min(T, 2 * S), max(1, T // 2 + 1))
    rng = np.random.default_rng(T + K)
    masked = (_past_length(log_A, lengths, fill, rng),
              _past_length(log_obs, lengths, fill, rng))
    for decode in (port_hmm.viterbi, viterbi_segmented_reference):
        want = decode(t(log_pi), t(log_A), t(log_obs), t(lengths))
        got = decode(t(log_pi), t(masked[0]), t(masked[1]), t(lengths))
        assert torch.equal(got.states, want.states)
        assert torch.equal(got.score, want.score)
        assert not torch.isnan(got.score).any()


def test_fused_evidence_ignores_the_inert_flag_on_the_cpu():
    """On a CPU tensor fused_evidence computes its plain version, every
    step, with inert_past_length as without it, and launches nothing."""
    _, _, tm = model_pair(seed=25)
    x, u, lengths = inputs(3, 40, seed=26)
    lengths[1:] = (1, 17)
    counts = (fused_evidence.launches, fused_evidence.inert_launches)
    with torch.no_grad():
        for L in (None, t(lengths)):
            want = fused_evidence(tm, t(x), t(u), L)
            got = fused_evidence(tm, t(x), t(u), L, inert_past_length=True)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            got = tm._evidence_inputs(t(x), t(u), L, None,
                                      inert_past_length=True)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert (fused_evidence.launches, fused_evidence.inert_launches) == \
        counts


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("T", [1024, 1025, 1040, 1153, 1168])
def test_two_level_fold_matches_sequential_decode(K, T):
    """Past G = 64 segments the fold runs in two levels over chunks of 8
    segments (T = 1025: 65 segments, the last chunk a single segment; T =
    1153 and 1168: a last chunk of 1 and of 2 segments); T = 1024 is the
    last single-level T.  Ragged lengths end inside the first and the last
    chunks."""
    B = 3
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=K * 31 + T)
    lengths[1:] = (17, T - 20)
    args = [t(log_pi), t(log_A), t(log_obs), t(lengths)]
    got = viterbi_segmented_reference(*args)
    want = port_hmm.viterbi(*args)
    assert_map_path(got, want.states, want.score, log_pi, log_A, log_obs,
                    lengths)
    assert (num_segments(T) > 64) == (T > 1024)


@pytest.mark.parametrize("K", [2, 3, 8])
def test_exact_ties_give_a_map_path(K):
    """State K - 1 a copy of state 0 (its row and column of log_A, its
    column of log_obs, its log_pi): the two are indistinguishable, every
    path through either is a MAP path, and the first maximum decides.  The
    scan's path scores as the optimum of the sequential decodes (JAX's and
    the port's)."""
    B, T = 3, 145
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=70 + K)
    log_A[..., K - 1, :] = log_A[..., 0, :]
    log_A[..., K - 1] = log_A[..., 0]
    log_obs[..., K - 1] = log_obs[..., 0]
    log_pi[K - 1] = log_pi[0]
    args = (log_pi, log_A, log_obs, lengths)
    got = viterbi_segmented_reference(*map(t, args))
    for want in (port_hmm.viterbi(*map(t, args)),
                 jax_hmm.viterbi(*map(jnp.asarray, args))):
        assert_map_path(got, want.states, want.score, *args[:3], lengths)
    assert (got.states.numpy() != K - 1).all()       # first maximum wins


def test_batched_row_is_the_row_alone():
    """S and the fold depend on T alone: a row of a batch decodes to the
    bits of the row decoded by itself."""
    B, T, K = 5, 146, 3
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=9)
    lengths[1:] = (1, 16, 17, 100)
    batched = viterbi_segmented_reference(*map(t, (log_pi, log_A, log_obs,
                                                   lengths)))
    for b in range(B):
        solo = viterbi_segmented_reference(
            t(log_pi), t(log_A[b:b + 1]), t(log_obs[b:b + 1]),
            t(lengths[b:b + 1]))
        assert torch.equal(batched.states[b:b + 1], solo.states)
        assert torch.equal(batched.score[b:b + 1], solo.score)


@pytest.mark.parametrize("B,T,K,stationary,lanes,seqs", [
    # a sequence's segments in one round up to STAGE_BYTES (rounds of a
    # multiple of 8 segments where the fold has chunks of 8: 35 -> 32,
    # 213 -> 208); up to a warp of sequences a block where a sequence takes
    # 16 threads or fewer, no more than leaves a block for each of 132 SMs
    (64, 200, 3, False, 13, 1), (1, 200, 3, False, 13, 1),
    (460, 20, 3, False, 5, 4), (1, 2327, 3, False, 146, 1),
    (1, 2327, 8, False, 32, 1), (1, 2327, 8, True, 146, 1),
    (1, 1000, 8, False, 35, 1), (4096, 1, 3, True, 1, 32),
    (2, 100000, 3, False, 208, 1)])
def test_viterbi_plan(B, T, K, stationary, lanes, seqs):
    plan = viterbi_plan(B, T, K, stationary, sms=132)
    assert (plan.lanes, plan.seqs) == (lanes, seqs)
    assert plan.threads % 32 == 0 and plan.threads <= MAX_LANES
    assert plan.blocks * seqs >= B > (plan.blocks - 1) * seqs
    S, G = segment_length(T), num_segments(T)
    assert lanes * S * 4 * (K + (0 if stationary else K * K)) <= \
        STAGE_BYTES or lanes == 1
    assert plan.smem == viterbi_smem_bytes(T, K, stationary, lanes, seqs)
    # the fold's chunks never straddle two rounds
    assert lanes == G or fold_chunk(G) == G or lanes % fold_chunk(G) == 0
    # the sequence's maps and end states grow with G; the staged round
    # does not
    assert plan.smem >= seqs * 5 * G


def test_scan_constants_match_the_sources():
    """The plans' constants and the segment length are those of
    csrc/viterbi.cu, csrc/fused_decode.cu and csrc/maxplus_scan.cuh, which
    kernels B and 10 both include; the header enters the build's
    digest."""
    from vqvaehmm_tpu_torch.ops import fused_decode

    scan = (_build.CSRC / "maxplus_scan.cuh").read_text()
    src = (_build.CSRC / "viterbi.cu").read_text()
    decode = (_build.CSRC / "fused_decode.cu").read_text()
    assert re.search(r"return T > 128 \? 16 : \(T > 32 \? 8 : 4\);", scan)
    assert re.search(r"return G > 64 \? 8 : G;", scan)
    assert re.search(rf"constexpr int MAX_LANES = {MAX_LANES};", src)
    assert re.search(r"return 64 \* K \* K > 2048 \? 64 \* K \* K : 2048;",
                     decode)
    assert [fused_decode._chunk_floats(K) for K in (3, 5, 6, 8)] == \
        [2048, 2048, 2304, 4096]
    assert "maxplus_scan.cuh" in [h.name for h in _build.headers()]
    users = [s.name for s in _build.sources()
             if '#include "maxplus_scan.cuh"' in s.read_text()]
    assert users == ["fused_decode.cu", "viterbi.cu"]
    assert [segment_length(T) for T in (1, 32, 33, 128, 129)] == \
        [4, 4, 8, 8, 16]
