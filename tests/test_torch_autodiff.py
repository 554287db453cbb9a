"""The inference kernels' autodiff routing (ops/fused_infer.py::
kernel_route and autograd_aside), held against the JAX package's
(tests/test_gradients.py).

JAX's auto-dispatch steps aside for an autodiff tracer: jax.grad through
posterior, infer_forward or viterbi_decode takes the XLA path, never the
VJP-less Pallas kernels.  The port steps aside for a call that autograd
would record (grad mode on and x, u or a weight of the stage requiring
grad).  On the CPU no kernel runs, so, as JAX's tests force its backend
gate open, these force the port's device gate (`on_card`) open: the
differentiating call must then still take the plain version, and its
gradients equal JAX's on the same seeded numpy inputs within 1e-4 (both
float32, different summation orders).  Outside autograd the forced-open
gate picks the kernel (the decision only: no kernel runs on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, model_pair, t
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.ops import fused_decode as fd
from vqvaehmm_tpu_torch.ops import fused_encoder as fe
from vqvaehmm_tpu_torch.ops import fused_infer as fi

# the widths of JAX's tests: make_model(5, 8, 3, 4, u_dim=4, trans_hidden=8)
B, T = 2, 16


@pytest.fixture
def gate_open(monkeypatch):
    """The kernels' device gate forced open, as JAX's tests force
    jax.default_backend() to "tpu"."""
    monkeypatch.setattr(fi, "on_card", lambda x: True)


def _case(seed):
    jm, params, tm = model_pair(seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 5, T)).astype(np.float32)
    u = rng.normal(size=(B, 4, T)).astype(np.float32)
    lengths = np.array([T, T - 5], np.int32)
    w = rng.normal(size=(B, 3, T)).astype(np.float32)
    return jm, params, tm, x, u, lengths, w


def _param_grads(tm):
    return {n: p.grad for n, p in tm.named_parameters()}


def _close_param_grads(tm, jax_grads, what):
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_grads))
    got = _param_grads(tm)
    assert set(got) == set(want), what
    for name, g in got.items():
        w = want[name]
        if g is None:       # no path from the loss: JAX's gradient is 0
            g = torch.zeros_like(torch.as_tensor(w))
        close(g, w, 1e-4, f"{what}: {name}")


# (entry point, the port's call, JAX's call): each loss weighs the
# entry point's regime output by a seeded w, so that its gradient is not
# the zero of a softmax's sum
ENTRIES = {
    "posterior": (lambda tm, x, u, L: tm.posterior(x),
                  lambda jm, p, x, u, L: jm.posterior(p, x)),
    "infer_forward": (lambda tm, x, u, L: tm.infer_forward(x)[2],
                      lambda jm, p, x, u, L: jm.infer_forward(p, x)[2]),
    "smoothed_posterior": (
        lambda tm, x, u, L: tm.smoothed_posterior(x, u, L),
        lambda jm, p, x, u, L: jm.smoothed_posterior(p, x, u, L)),
    "filtered_posterior": (
        lambda tm, x, u, L: tm.filtered_posterior(x, u, L),
        lambda jm, p, x, u, L: jm.filtered_posterior(p, x, u, L)),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_grad_through_entry_point_takes_plain_path(gate_open, entry):
    """jax.grad through the entry point with the default dispatch, with
    respect to the weights and to x (tests/test_gradients.py:75 for
    posterior, :103 for infer_forward; the exact modes' evidence the
    same): the port's default call under autograd takes the plain version
    with the gate forced open, and its gradients equal JAX's."""
    port, ref = ENTRIES[entry]
    jm, params, tm, x, u, lengths, w = _case(seed=len(entry))
    xt = t(x).requires_grad_(True)
    out = port(tm, xt, t(u), t(lengths))
    assert out.requires_grad and out.grad_fn is not None
    (out * t(w)).sum().backward()

    def loss(p, xx):
        return (ref(jm, p, xx, jnp.asarray(u), jnp.asarray(lengths))
                * jnp.asarray(w)).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    close(xt.grad, gx, 1e-4, f"{entry}: x")
    _close_param_grads(tm, gp, entry)


def test_grad_around_viterbi_decode_takes_plain_path(gate_open):
    """viterbi_decode inside a differentiated computation
    (tests/test_gradients.py:137): its states equal JAX's scan path's and
    carry no gradient, so the loss's gradient with respect to x is zero,
    as JAX's, and the decoder's gradients through the decoded one-hot
    equal JAX's; the evidence took the plain version (the route), and
    the decode ops/hmm.py's, as no kernel runs on the CPU."""
    jm, params, tm, x, u, lengths, _ = _case(seed=137)
    xt = t(x).requires_grad_(True)
    states = tm.viterbi_decode(xt, t(u), t(lengths))
    onehot = torch.nn.functional.one_hot(states.long(), 3).transpose(1, 2)
    mu, _ = tm.decode(onehot.float())
    (mu ** 2).sum().backward()

    def loss(p, xx):
        s = jm.viterbi_decode(p, xx, jnp.asarray(u), jnp.asarray(lengths))
        mu, _ = jm.decode(p, jax.nn.one_hot(s, 3).transpose(0, 2, 1))
        return (mu ** 2).sum()

    want_states = jm.viterbi_decode(params, jnp.asarray(x), jnp.asarray(u),
                                    jnp.asarray(lengths))
    np.testing.assert_array_equal(states.numpy(), np.asarray(want_states))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    assert xt.grad is None and not np.asarray(gx).any()
    _close_param_grads(tm, gp, "viterbi_decode")


def _wrappers(tm, x, u):
    """(name, the tensors the route reads besides x, the default call) of
    the four inference kernels' wrappers."""
    return (
        ("fused_forward", fi.infer_tensors(tm),
         lambda xx: fi.fused_forward(tm, xx)),
        ("fused_encode", list(tm.encoder.parameters()),
         lambda xx: fe.fused_encode(tm, xx)),
        ("fused_evidence", fd.evidence_tensors(tm, u),
         lambda xx: fd.fused_evidence(tm, xx, u)),
        ("fused_viterbi_states", fd.evidence_tensors(tm, u),
         lambda xx: fd.fused_viterbi_states(tm, xx, u)))


@pytest.mark.parametrize("which", range(4))
def test_route_decision(gate_open, which):
    """With the gate forced open: the kernel outside autograd (no_grad,
    inference_mode, or no input or weight requiring grad), the plain
    version where autograd records the call (a weight, x or, for the
    evidence and the decode, u requiring grad), and the plain version
    for a bfloat16 model at any grad mode; use_kernel as given."""
    _, _, tm, x, u, _, _ = _case(seed=11)
    xt, ut = t(x), t(u)
    name, tensors, call = _wrappers(tm, xt, ut)[which]

    def route(m, xx, use, ts):
        return fi.kernel_route(m, xx, use) and not fi.autograd_aside(
            use, xx, ts)

    assert not route(tm, xt, None, tensors), name
    with torch.no_grad():
        assert route(tm, xt, None, tensors), name
    with torch.inference_mode():
        assert route(tm, xt, None, tensors), name
    assert route(tm, xt, True, tensors) and not route(tm, xt, False, tensors)
    # the default call under autograd: the plain version, differentiable
    out = call(xt)
    if name != "fused_viterbi_states":
        got = out[2] if isinstance(out, tuple) else out
        assert got.requires_grad, name
    for p in tm.parameters():
        p.requires_grad_(False)
    assert route(tm, xt, None, tensors), name
    assert not route(tm, xt.clone().requires_grad_(True), None, tensors)
    if name in ("fused_evidence", "fused_viterbi_states"):
        uu = ut.clone().requires_grad_(True)
        assert not route(tm, xt, None, _wrappers(tm, xt, uu)[which][1])
    bf = model_pair(seed=11, compute_dtype="bfloat16")[2]
    with torch.no_grad():
        assert not route(bf, xt, None, _wrappers(bf, xt, ut)[which][1])


def test_forced_kernel_under_autograd_raises():
    """refuse_grad, which a wrapper forced onto its kernel (use_kernel=True)
    calls on a CUDA tensor: it raises where autograd would record the
    call, through u too, and passes under no_grad and inference_mode and
    with nothing requiring grad."""
    _, _, tm, x, u, _, _ = _case(seed=12)
    xt, ut = t(x), t(u)
    tensors = fd.evidence_tensors(tm, ut)
    with pytest.raises(RuntimeError, match="no gradient"):
        fi.refuse_grad("fused evidence", xt, tensors)
    with torch.no_grad():
        fi.refuse_grad("fused evidence", xt, tensors)
    with torch.inference_mode():
        fi.refuse_grad("fused evidence", xt, tensors)
    frozen = [p.detach() for p in tm.parameters()]
    fi.refuse_grad("fused evidence", xt, frozen + [ut])
    with pytest.raises(RuntimeError, match="no gradient"):
        fi.refuse_grad("fused evidence", xt,
                       frozen + [ut.clone().requires_grad_(True)])
