"""The port's evidence and one-kernel-decode wrappers
(vqvaehmm_tpu_torch/ops/fused_decode.py) against the JAX package's Pallas
kernels in interpret mode, as tests/test_pallas_decode.py runs them, on
shared weights and inputs.

On the CPU the port's wrappers compute their plain versions, which are
what the CUDA kernels are held against on the card
(tests/test_torch_cuda.py).  x is zero past max(lengths), as every batch
of the data pipeline is: the JAX evidence kernel does not mask x itself
there, while the model's plain evidence (and the port) do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, inputs, model_pair, t
from vqvaehmm_tpu.ops import hmm as jax_hmm
from vqvaehmm_tpu.ops.pallas_decode import fused_evidence as jax_evidence
from vqvaehmm_tpu.ops.pallas_decode import \
    fused_viterbi_states as jax_viterbi_states
from vqvaehmm_tpu_torch import ModelConfig
from vqvaehmm_tpu_torch.ops.fused_decode import (
    decode_smem_bytes, evidence_plan, evidence_smem_bytes, fused_evidence,
    fused_evidence_reference, fused_viterbi_states,
    fused_viterbi_states_reference, supported)
from vqvaehmm_tpu_torch.ops.fused_infer import SMEM_LIMIT

PUBLISHED = ModelConfig(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32,
                        u_dim=4, trans_hidden=128)


def _case(B, T, seed, layout, ragged):
    x, u, lengths = inputs(B, T, seed=seed)
    if not ragged:
        lengths = None
    else:
        lengths[0] = T - 3          # max(lengths) < T: the bound is live
        lengths = np.minimum(lengths, T - 3)
        x[:, :, T - 3:] = 0.0
    if layout == "BTU":
        u = np.ascontiguousarray(u.transpose(0, 2, 1))
    return x, u, lengths


@pytest.mark.parametrize("layout,ragged", [("BUT", True), ("BTU", True),
                                           ("BUT", False), ("BTU", False)])
def test_fused_evidence_matches_jax_kernel(layout, ragged):
    """log_pi, log_A and log_obs within 1e-5 (float32 on both sides,
    different summation orders and log-softmax routines)."""
    jm, params, tm = model_pair(seed=31)
    x, u, lengths = _case(4, 40, 32, layout, ragged)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else t(lengths)
    want = jax_evidence(jm, params, jnp.asarray(x), jnp.asarray(u), jl,
                        interpret=True)
    with torch.no_grad():
        got = fused_evidence(tm, t(x), t(u), tl)
        ref = fused_evidence_reference(tm, t(x), t(u), tl)
    for g, r, w, name in zip(got, ref, want, ("log_pi", "log_A", "log_obs")):
        assert tuple(g.shape) == tuple(w.shape), name
        assert torch.equal(g, r), name
        close(g, w, 1e-5, name)


def _score(log_pi, log_A, log_obs, states, lengths):
    """log p(z, x) of each path over its valid steps (numpy)."""
    B, T = states.shape
    out = np.zeros(B)
    for b in range(B):
        s = states[b]
        out[b] = log_pi[s[0]] + log_obs[b, 0, s[0]]
        for k in range(1, int(lengths[b])):
            out[b] += log_A[b, k, s[k - 1], s[k]] + log_obs[b, k, s[k]]
    return out


@pytest.mark.parametrize("layout,ragged", [("BUT", True), ("BTU", False)])
def test_fused_viterbi_states_match_jax_kernel(layout, ragged):
    """States equal to the Pallas one-kernel decode on every valid step,
    or score-tied under the JAX evidence (<= 1e-4), and frozen past each
    length."""
    jm, params, tm = model_pair(seed=33)
    B, T = 8, 40
    x, u, lengths = _case(B, T, 34, layout, ragged)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else t(lengths)
    want = np.asarray(jax_viterbi_states(jm, params, jnp.asarray(x),
                                         jnp.asarray(u), jl, interpret=True))
    with torch.no_grad():
        got = fused_viterbi_states(tm, t(x), t(u), tl)
        ref = fused_viterbi_states_reference(tm, t(x), t(u), tl)
        via_model = tm.viterbi_decode(t(x), t(u), tl)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    assert torch.equal(got, ref) and torch.equal(got, via_model)
    got = got.numpy()
    L = np.full(B, T) if lengths is None else lengths
    same = all(np.array_equal(got[b, :L[b]], want[b, :L[b]])
               for b in range(B))
    if not same:
        ev = [np.asarray(a) for a in jax_evidence(
            jm, params, jnp.asarray(x), jnp.asarray(u), jl, interpret=True)]
        np.testing.assert_allclose(_score(*ev, got, L), _score(*ev, want, L),
                                   rtol=0, atol=1e-4)
    for b in range(B):
        assert (got[b, L[b]:] == got[b, L[b] - 1]).all()
    # and the score the states reach is the sequential decode's optimum
    with torch.no_grad():
        ev = [a.numpy() for a in fused_evidence(tm, t(x), t(u), tl)]
    best = np.asarray(jax_hmm.viterbi(*[jnp.asarray(a) for a in ev],
                                      jl).score)
    np.testing.assert_allclose(_score(*ev, got, L), best, rtol=0, atol=1e-4)


def test_dispatch_and_gate_on_cpu():
    _, _, tm = model_pair(seed=35)
    x, u, lengths = (t(a) for a in inputs(2, 16, seed=36))
    for fn in (fused_evidence, fused_viterbi_states):
        with pytest.raises(ValueError, match="CUDA"):
            fn(tm, x, u, lengths, use_kernel=True)
    with torch.no_grad():
        for fn in (tm.smoothed_posterior, tm.filtered_posterior,
                   tm.viterbi_decode):
            assert torch.equal(fn(x, u, lengths),
                               fn(x, u, lengths, use_kernel=False))
    assert supported(tm.cfg, 64, 200) and supported(tm.cfg, 1, 2327)
    # the evidence: two weight buffers, a pad, the stage region (x, h1, h2
    # or u, hp: max(5 + 8 + 4, 4 + 8) rows), K rows of log_obs and K * K of
    # log_A, each of tile + 2 halos + JB floats
    assert evidence_smem_bytes(tm.cfg, 32) == \
        4 * (2 * 6144 + 8 + 40 * (17 + 3 + 9))
    # the decode: that stage (a multiple of 16 bytes here), then each of
    # its tiles' log_obs, log_A and backpointer words (K + K * K + 1 words
    # a step), then the fold's and reverse pass's scratch: 2048 floats of
    # staging (64 * K * K from K = 6), 32 chunk products and deltas
    # (K * K + K), 68 words
    assert decode_smem_bytes(tm.cfg, 32, 2) == \
        4 * (2 * 6144 + 8 + 40 * (17 + 3 + 9)) \
        + 4 * (2 * 32 * 13 + 2048 + 32 * 12 + 68)
    small = dict(input_dim=5, hidden_dim=8, hidden_dim2=4, u_dim=4,
                 trans_hidden=8)
    assert not supported(ModelConfig(K=9, **small), 1, 8)
    assert not supported(ModelConfig(K=3, **{**small, "trans_hidden": 4096}),
                         1, 8)
    assert not supported(ModelConfig(K=3, compute_dtype="bfloat16", **small),
                         1, 8)


@pytest.mark.parametrize("B,T,tile,blocks,split", [
    # published widths: max(101, 132) + 3 + 9 = 144 rows.  One wave of 256
    # blocks of 64 steps at (64, 200) (split, they would be two); the
    # encoder and the prior in blocks of their own where that keeps the
    # waves (a request at B = 1: the narrowest tile) or adds one wave of
    # blocks of 0.6 the cost (the bulk windows: 920 blocks in three waves
    # of 396 against 460 in two)
    (64, 200, 64, 256, False), (460, 20, 32, 920, True),
    (1, 200, 16, 26, True), (1, 37, 16, 6, True), (1, 1500, 16, 188, True),
    (1, 2327, 16, 292, True)])
def test_evidence_plan(B, T, tile, blocks, split):
    plan = evidence_plan(PUBLISHED, B, T)
    assert (plan.tile, plan.blocks, plan.split) == (tile, blocks, split)
    assert plan.smem == evidence_smem_bytes(PUBLISHED, tile) == \
        4 * (2 * 6144 + 8 + (tile + 8) * 144) <= SMEM_LIMIT
    # the widest register-tiled layer is the prior's hidden one, HP = 128
    assert plan.threads == {64: 288, 32: 320, 16: 192}[tile]


def test_gate_and_rows_where_the_prior_is_the_widest():
    """HP and K * K above H1 and H2: the prior's rows are sized by its own
    widths, not by the encoder's (a buffer of max(H1, H2) rows would be
    overrun).  The WBUF bound of each layer is part of the gate."""
    from vqvaehmm_tpu_torch.ops import fused_encoder as fe

    cfg = ModelConfig(input_dim=5, hidden_dim=8, K=8, hidden_dim2=4, u_dim=4,
                      trans_hidden=64)
    assert supported(cfg, 1, 200)
    assert evidence_smem_bytes(cfg, 16) == \
        4 * (2 * 6144 + 8 + 24 * (max(5 + 8 + 4, 4 + 64) + 8 + 64))
    assert evidence_plan(cfg, 1, 200).split
    assert not fe.layers_fit(5, 8, 4, 8, 4, 6148)
    assert not supported(ModelConfig(
        input_dim=5, hidden_dim=8, K=3, hidden_dim2=4, u_dim=4,
        trans_hidden=6148), 1, 8)
