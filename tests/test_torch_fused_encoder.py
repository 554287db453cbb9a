"""The port's fused encoder wrapper (vqvaehmm_tpu_torch/ops/fused_encoder.py)
against the JAX package: the Pallas encoder kernel in interpret mode and the
plain `VAEHMM.encode`, on shared weights and inputs.

On the CPU the port's wrapper computes its plain version, which is what
its CUDA kernel is held against on the card (tests/test_torch_cuda.py).
Tolerance 1e-5: float32 on both sides, different summation orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, inputs, model_pair, t
from vqvaehmm_tpu_torch import ModelConfig
from vqvaehmm_tpu.ops.pallas_encoder import fused_encode as jax_fused_encode
from vqvaehmm_tpu_torch.ops.fused_encoder import (encode_supported,
                                                  fused_encode,
                                                  fused_encode_reference,
                                                  smem_bytes)
from vqvaehmm_tpu_torch.ops.fused_infer import SMEM_LIMIT


@pytest.mark.parametrize("kind", ["none", "scalar", "vector"])
def test_fused_encode_matches_jax_kernel_and_encode(kind):
    """None, scalar and per-sequence valid_to; x is non-zero past valid_to,
    so a leak of x[valid_to] into conv1 at valid_to - 1 would show."""
    jm, params, tm = model_pair(seed=21)
    B, T = 3, 40
    x, _, lengths = inputs(B, T, seed=22)
    vt = {"none": None, "scalar": T - 7, "vector": lengths}[kind]
    jvt = None if vt is None else jnp.asarray(vt)
    tvt = t(vt) if kind == "vector" else vt
    with torch.no_grad():
        got = fused_encode(tm, t(x), valid_to=tvt)
        via_model = tm.encode(t(x), valid_to=tvt)
    assert got.shape == (B, 3, T) and torch.equal(got, via_model)
    close(got, jax_fused_encode(params, jnp.asarray(x), valid_to=jvt,
                                interpret=True), 1e-5, "Pallas kernel")
    close(got, jm.encode(params, jnp.asarray(x), valid_to=jvt), 1e-5,
          "VAEHMM.encode")
    if vt is not None:
        # the tail past valid_to must not reach the valid region
        x2 = x.copy()
        for b in range(B):
            x2[b, :, int(np.broadcast_to(vt, (B,))[b]):] = 7.0
        with torch.no_grad():
            again = fused_encode(tm, t(x2), valid_to=tvt)
        for b in range(B):
            n = int(np.broadcast_to(vt, (B,))[b])
            assert torch.equal(again[b, :, :n], got[b, :, :n])


def test_rows_do_not_see_their_neighbours():
    """Batch-boundary isolation: a row of a batched call equals the row
    alone (SAME zero padding at both ends of every row)."""
    _, _, tm = model_pair(seed=23)
    x, _, lengths = inputs(4, 24, seed=24)
    with torch.no_grad():
        batched = fused_encode(tm, t(x), valid_to=t(lengths))
        for b in range(4):
            solo = fused_encode(tm, t(x[b:b + 1]),
                                valid_to=t(lengths[b:b + 1]))
            close(batched[b:b + 1], solo, 1e-6, f"row {b}")


def test_dispatch_and_gate_on_cpu():
    _, _, tm = model_pair(seed=25)
    x = t(inputs(2, 16, seed=26)[0])
    with torch.no_grad():
        assert torch.equal(fused_encode(tm, x, use_kernel=False),
                           fused_encode_reference(tm, x))
        assert torch.equal(tm.posterior(x, fused=False), tm.posterior(x))
    with pytest.raises(ValueError, match="CUDA"):
        fused_encode(tm, x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tm.posterior(x, fused=True)
    assert encode_supported(tm.cfg, 460, 20)
    assert encode_supported(tm.cfg, 1, 2327)
    assert smem_bytes(tm.cfg) == 4 * 40 * (5 + 8 + 4 + 3)
    big = ModelConfig(input_dim=5, hidden_dim=2048, K=3, hidden_dim2=4,
                      u_dim=4, trans_hidden=8)
    assert smem_bytes(big) > SMEM_LIMIT and not encode_supported(big, 1, 8)
    bf16 = ModelConfig(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4,
                       u_dim=4, trans_hidden=8, compute_dtype="bfloat16")
    assert not encode_supported(bf16, 1, 8)


def test_shared_header_enters_the_build_digest():
    """The encoder stages live in a header that two sources include: an
    edited header must change the library's name, so the build hashes the
    headers beside the sources."""
    from vqvaehmm_tpu_torch.ops import _build

    names = [h.name for h in _build.headers()]
    assert names == ["encoder_tile.cuh"]
    users = [s.name for s in _build.sources()
             if '#include "encoder_tile.cuh"' in s.read_text()]
    assert users == ["fused_decode.cu", "fused_encoder.cu"]
    assert len(_build.sources()) == 7
    for entry in ("vqhmm_fused_encode", "vqhmm_fused_evidence",
                  "vqhmm_fused_decode", "vqhmm_vq_nearest"):
        assert entry in _build._SIGNATURES
        assert f'extern "C" int {entry}(' in "".join(
            s.read_text() for s in _build.sources())


def test_kernel_path_refuses_autograd():
    """The kernels carry no gradient.  Their wrappers raise where grad mode
    is on and x or a weight requires grad, so that nobody trains through a
    detached tensor; on the CPU the plain version runs and stays
    differentiable, as the JAX encode is."""
    from vqvaehmm_tpu_torch.ops.fused_encoder import refuse_grad

    _, _, tm = model_pair(seed=27)
    x = t(inputs(2, 16, seed=28)[0])
    with pytest.raises(RuntimeError, match="fused=False"):
        refuse_grad("fused encoder", x, tm.encoder.parameters())
    with torch.no_grad():
        refuse_grad("fused encoder", x, tm.encoder.parameters())
    with torch.inference_mode():
        refuse_grad("fused encoder", x, tm.encoder.parameters())
    frozen = [p.detach() for p in tm.encoder.parameters()]
    refuse_grad("fused encoder", x, frozen)
    with pytest.raises(RuntimeError, match="no gradient"):
        refuse_grad("fused encoder", x.clone().requires_grad_(True), frozen)
    q = tm.posterior(x)
    assert q.requires_grad
    q.sum().backward()
    assert tm.encoder.conv1.weight.grad is not None
