"""The port's Viterbi decode (vqvaehmm_tpu_torch/ops/fused_viterbi.py and
ops/hmm.py) against the JAX package: its lax.scan decode and its Pallas
kernels (monolithic and chunked) in interpret mode.  Inputs are random
and continuous, so there are no ties: states must be equal, scores agree
to <= 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, hmm_inputs, model_pair, inputs, t
from vqvaehmm_tpu.ops import hmm as jax_hmm
from vqvaehmm_tpu.ops.pallas_hmm import viterbi_pallas, viterbi_pallas_tiled
from vqvaehmm_tpu_torch.ops import hmm as port_hmm
from vqvaehmm_tpu_torch.ops.fused_viterbi import (viterbi_fused,
                                                  viterbi_reference)


def _shape_log_A(log_A, ndim):
    return {4: log_A, 3: log_A[0], 2: log_A[0, 0]}[ndim]


@pytest.mark.parametrize("ndim", [4, 3, 2])
def test_matches_jax_scan_and_pallas(ndim):
    B, T, K = 3, 40, 3
    log_pi, log_A, log_obs, lengths = hmm_inputs(B, T, K, seed=ndim)
    log_A = _shape_log_A(log_A, ndim)
    args = tuple(map(jnp.asarray, (log_pi, log_A, log_obs, lengths)))
    want = jax_hmm.viterbi(*args)
    pallas = viterbi_pallas(*args, interpret=True)
    tiled = viterbi_pallas_tiled(*args, chunk=16, interpret=True)
    targs = tuple(map(t, (log_pi, log_A, log_obs, lengths)))
    for got in (viterbi_reference(*targs), port_hmm.viterbi(*targs)):
        assert got.states.dtype == torch.int32
        np.testing.assert_array_equal(got.states.numpy(),
                                      np.asarray(want.states))
        close(got.score, want.score, 1e-5, "score vs scan")
        for other in (pallas, tiled):
            for b, L in enumerate(lengths):
                np.testing.assert_array_equal(
                    got.states.numpy()[b, :L], np.asarray(other.states)[b, :L])
            close(got.score, other.score, 1e-5, "score vs pallas")


def test_no_lengths_and_length_one():
    log_pi, log_A, log_obs, _ = hmm_inputs(2, 9, 4, seed=5)
    lengths = np.array([1, 9], np.int32)
    for lens in (None, lengths):
        jargs = [jnp.asarray(a) for a in (log_pi, log_A, log_obs)]
        targs = [t(a) for a in (log_pi, log_A, log_obs)]
        want = jax_hmm.viterbi(*jargs, None if lens is None
                               else jnp.asarray(lens))
        got = viterbi_reference(*targs, None if lens is None else t(lens))
        np.testing.assert_array_equal(got.states.numpy(),
                                      np.asarray(want.states))
        close(got.score, want.score, 1e-5)


def test_model_viterbi_decode_matches_jax():
    jm, params, tm = model_pair(seed=12)
    x, u, lengths = inputs(3, 33, seed=13)
    with torch.no_grad():
        got = tm.viterbi_decode(t(x), t(u), t(lengths))
    want = jm.viterbi_decode(params, jnp.asarray(x), jnp.asarray(u),
                             jnp.asarray(lengths), use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_dispatch_takes_plain_version():
    log_pi, log_A, log_obs, lengths = hmm_inputs(2, 12, 3, seed=6)
    args = tuple(map(t, (log_pi, log_A, log_obs, lengths)))
    before = viterbi_fused.launches
    got, want = viterbi_fused(*args), viterbi_reference(*args)
    assert torch.equal(got.states, want.states)
    assert torch.equal(got.score, want.score)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_fused(*args, use_kernel=True)
    assert viterbi_fused.launches == before


def test_log_A_shape_validation():
    log_pi, log_A, log_obs, _ = hmm_inputs(2, 6, 3, seed=7)
    with pytest.raises(ValueError, match="3-D log_A"):
        viterbi_reference(t(log_pi), t(log_A[:, 0]), t(log_obs))
    with pytest.raises(ValueError, match="4-D log_A"):
        viterbi_reference(t(log_pi), t(log_A[:, :5]), t(log_obs))
