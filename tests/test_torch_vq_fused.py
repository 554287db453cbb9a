"""The straight-through quantizer of the port (vqvaehmm_tpu_torch/ops/vq.py)
as the card runs it: one forward and one backward, whose plain versions
`quantize_st_forward_reference` and `quantize_st_backward_reference` are
held here against jax.value_and_grad of the JAX package's quantize_st and
against torch autograd of the plain forward (`quantize_st_reference`), on
the same numpy inputs; `_FusedQuantize` runs on the CPU with those plain
functions, which checks its wiring.  Tolerances: 1e-4 absolute against JAX
(float32, other summation orders, as tests/test_torch_vq.py), 1e-6 against
torch autograd, integers equal."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, t
from vqvaehmm_tpu.ops import vq as jvq
from vqvaehmm_tpu_torch.ops import _build
from vqvaehmm_tpu_torch.ops import vq as tvq

ATOL_JAX = 1e-4
ATOL_TORCH = 1e-6
GC, GK = 0.7, 1.3            # cotangents of the commitment and codebook loss


def _case(kind, seed):
    """z (B, T, D), codebook (M, D), mask (B, T) or None, cotangent w."""
    rng = np.random.default_rng(seed)
    B, T, D, M = 3, 11, 8, 6
    z = rng.normal(size=(B, T, D)).astype(np.float32)
    cb = (0.5 * rng.normal(size=(M, D))).astype(np.float32)
    w = rng.normal(size=z.shape).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([11, 4, 7])[:, None]
    if kind == "tie":
        cb[5] = cb[2]                                 # an exact tie
    elif kind == "all masked":
        mask = np.zeros_like(mask)
    elif kind == "unmasked":
        mask = None
    return z, cb, mask, w


def _jax(z, cb, mask, w):
    def loss(z_, cb_):
        r = jvq.quantize_st(z_, cb_, 0.25, mask=None if mask is None
                            else jnp.asarray(mask))
        return ((r.quantized * w).sum() + GC * r.commitment_loss
                + GK * r.codebook_loss), r

    (_, r), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(cb))
    return r, grads


def _torch(z, cb, mask, w, channels_first, via):
    """(result with (B, T, D) z_q_st, dz (B, T, D), dcodebook) through
    `via`: "autograd" (quantize_st_reference), "function" (_FusedQuantize
    with the plain functions) or "backward" (quantize_st_backward_reference
    called directly)."""
    tz = t(z).clone().requires_grad_()
    tc = t(cb).clone().requires_grad_()
    zin = tz.transpose(1, 2) if channels_first else tz
    tm = None if mask is None else t(mask)
    tw = t(w).transpose(1, 2) if channels_first else t(w)
    if via == "backward":
        q, idx, commit, cbl, denom = tvq.quantize_st_forward_reference(
            zin, tc, 0.25, tm, channels_first)
        dz, dcb = tvq.quantize_st_backward_reference(
            tw, torch.tensor(GC), torch.tensor(GK), zin.detach(),
            tc.detach(), idx, tm, denom, 0.25, channels_first)
        r = tvq.VQResult(q, idx, commit, cbl)
        grads = (dz.transpose(1, 2) if channels_first else dz), dcb
    else:
        if via == "autograd":
            r = tvq.quantize_st_reference(zin, tc, 0.25, tm, channels_first)
        else:
            r = tvq.VQResult(*tvq._FusedQuantize.apply(
                zin, tc, tm, 0.25, channels_first,
                tvq.quantize_st_forward_reference,
                tvq.quantize_st_backward_reference))
        ((r.quantized * tw).sum() + GC * r.commitment_loss
         + GK * r.codebook_loss).backward()
        grads = tz.grad, tc.grad
    q = r.quantized.transpose(1, 2) if channels_first else r.quantized
    return r._replace(quantized=q.detach()), grads


@pytest.mark.parametrize("kind", ["masked", "unmasked", "tie", "all masked"])
@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("via", ["backward", "function"])
def test_plain_quantizer_matches_jax_and_autograd(kind, channels_first, via):
    z, cb, mask, w = _case(kind, seed=len(kind))
    jr, (jgz, jgc) = _jax(z, cb, mask, w)
    ar, (agz, agc) = _torch(z, cb, mask, w, channels_first, "autograd")
    r, (gz, gc) = _torch(z, cb, mask, w, channels_first, via)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    assert r.indices.dtype == torch.int32 and not r.indices.requires_grad
    assert torch.equal(r.indices, ar.indices)
    assert torch.equal(r.quantized, ar.quantized)
    close(r.quantized, jr.quantized, ATOL_JAX)
    for got, want, atol in ((r.commitment_loss, jr.commitment_loss,
                             ATOL_JAX),
                            (r.codebook_loss, jr.codebook_loss, ATOL_JAX),
                            (r.commitment_loss, ar.commitment_loss,
                             ATOL_TORCH),
                            (r.codebook_loss, ar.codebook_loss,
                             ATOL_TORCH)):
        close(got.detach(), want.detach() if hasattr(want, "detach")
              else want, atol)
    close(gz, jgz, ATOL_JAX, "d/dz_e against JAX")
    close(gc, jgc, ATOL_JAX, "d/dcodebook against JAX")
    close(gz, agz, ATOL_TORCH, "d/dz_e against autograd")
    close(gc, agc, ATOL_TORCH, "d/dcodebook against autograd")
    if kind == "tie":
        assert not (r.indices == 5).any() and not gc[5].any()
    if kind == "all masked":
        assert float(r.commitment_loss.detach()) == 0.0 \
            == float(r.codebook_loss.detach())
        assert torch.equal(gz, t(w)) and not gc.any()


@pytest.mark.parametrize("used", ["z_q_st", "commitment", "codebook_loss"])
def test_fused_function_routes_each_cotangent(used):
    """Each output of _FusedQuantize carries its gradient to the input
    autograd gives it and to no other: z_q_st and the commitment loss to
    z_e alone, the codebook loss to the codebook alone; the indices carry
    none, and neither do the mask and the scalars."""
    z, cb, mask, w = _case("masked", seed=9)
    grads = []
    for via in ("autograd", "function"):
        tz = t(z).clone().requires_grad_()
        tc = t(cb).clone().requires_grad_()
        if via == "autograd":
            r = tvq.quantize_st_reference(tz, tc, 0.25, t(mask))
        else:
            r = tvq.VQResult(*tvq._FusedQuantize.apply(
                tz, tc, t(mask), 0.25, False,
                tvq.quantize_st_forward_reference,
                tvq.quantize_st_backward_reference))
        out = {"z_q_st": (r.quantized * t(w)).sum(),
               "commitment": r.commitment_loss,
               "codebook_loss": r.codebook_loss}[used]
        out.backward()
        grads.append([torch.zeros_like(a) if a.grad is None else a.grad
                      for a in (tz, tc)])
    for got, want in zip(grads[1], grads[0]):
        close(got, want, ATOL_TORCH)
    assert bool(grads[1][0].any()) == (used != "codebook_loss")
    assert bool(grads[1][1].any()) == (used == "codebook_loss")


def test_quantize_st_dispatch_on_the_cpu():
    """A CPU tensor takes the plain autograd path and launches nothing;
    use_kernel=True on a CPU tensor raises."""
    z, cb, mask, _ = _case("masked", seed=3)
    counters = (tvq.vq_nearest, tvq.quantize_st_fused_forward,
                tvq.quantize_st_fused_backward)
    before = [c.launches for c in counters]
    tz = t(z).clone().requires_grad_()
    r = tvq.quantize_st(tz, t(cb), 0.25, mask=t(mask))
    (r.commitment_loss + r.codebook_loss).backward()
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        tvq.quantize_st(t(z), t(cb), use_kernel=True)


def _cu_constant(name):
    text = (_build.CSRC / "vq.cu").read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    return eval(expr)                     # a literal product, e.g. 48 * 1024


@pytest.mark.parametrize("M,D,fwd,bwd", [
    # D=16: 256 tokens a backward chunk
    (8, 16, 4 * (8 * 16 + 8) + 2048, 4 * (128 + 16 * 257 + 256)),
    # D=64: 64 tokens a chunk
    (40, 64, 4 * (40 * 64 + 40) + 2048, 4 * (2560 + 64 * 65 + 64)),
    # D=5 pads to 8 in the forward: 256 tokens a chunk
    (3, 5, 4 * (3 * 8 + 3) + 2048, 4 * (15 + 5 * 257 + 256))])
def test_quantizer_gate_mirrors_the_kernel(M, D, fwd, bwd):
    """vq_supported and quantize_smem_bytes use the constants of
    csrc/vq.cu, and every C entry point bound in ops/_build.py is defined
    there."""
    for name, value in (("THREADS", tvq.THREADS), ("MAX_D", tvq.MAX_D),
                        ("TILE_FLOATS", tvq.TILE_FLOATS),
                        ("SMEM_OPTIN", tvq.SMEM_OPTIN),
                        ("SMEM_DEFAULT", tvq.SMEM_LIMIT)):
        assert _cu_constant(name) == value
    assert tvq.quantize_smem_bytes(M, D) == (fwd, bwd)
    assert tvq.vq_supported(M, D, torch.float32, "cuda", quantize=True)
    assert not tvq.vq_supported(M, D, torch.float32, "cpu", quantize=True)
    assert not tvq.vq_supported(M, 65, torch.float32, "cuda", quantize=True)
    # past the nearest-code kernel's 48 KB, within the quantizer's opt-in
    assert not tvq.vq_supported(400, 32, torch.float32, "cuda")
    assert tvq.vq_supported(400, 32, torch.float32, "cuda", quantize=True)
    assert not tvq.vq_supported(4000, 64, torch.float32, "cuda",
                                quantize=True)     # the forward's codebook
    sources = "".join(s.read_text() for s in _build.sources())
    for entry in list(_build._SIGNATURES) + list(_build._SIZE_SIGNATURES):
        assert re.search(rf'extern "C" (int|long long) {entry}\(', sources)
