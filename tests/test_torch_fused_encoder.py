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
from vqvaehmm_tpu_torch.ops import fused_encoder as fe
from vqvaehmm_tpu_torch.ops.fused_encoder import (encode_plan,
                                                  encode_supported,
                                                  fused_encode,
                                                  fused_encode_reference,
                                                  smem_bytes)
from vqvaehmm_tpu_torch.ops.fused_infer import SMEM_LIMIT

PUBLISHED = ModelConfig(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32,
                        u_dim=4, trans_hidden=128)


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
    # two weight buffers, a pad, then C + H1 + H2 + K rows of tile + 2
    # halos + JB floats
    assert smem_bytes(tm.cfg, 64) == 4 * (2 * 6144 + 8 + 72 * (5 + 8 + 4 + 3))
    big = ModelConfig(input_dim=5, hidden_dim=2048, K=3, hidden_dim2=4,
                      u_dim=4, trans_hidden=8)
    assert smem_bytes(big, 16) > SMEM_LIMIT and not encode_supported(big, 1, 8)
    bf16 = ModelConfig(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4,
                       u_dim=4, trans_hidden=8, compute_dtype="bfloat16")
    assert not encode_supported(bf16, 1, 8)


def test_shared_header_enters_the_build_digest():
    """The encoder stages live in headers that several sources include: an
    edited header must change the library's name, so the build hashes the
    headers beside the sources.  Kernels 8, 10 and 11 share
    encoder_fma.cuh (on tile_fma.cuh) and, in their bfloat16-operand
    mode, encoder_mma.cuh (on tile_mma.cuh); kernels B and 10 share the
    scan of maxplus_scan.cuh; kernel C's bfloat16 mode and kernel A's are
    on tile_mma.cuh."""
    from vqvaehmm_tpu_torch.ops import _build

    names = [h.name for h in _build.headers()]
    assert names == ["encoder_fma.cuh", "encoder_mma.cuh",
                     "maxplus_scan.cuh", "tile_fma.cuh", "tile_mma.cuh"]
    users = [s.name for s in _build.sources()
             if '#include "tile_mma.cuh"' in s.read_text()]
    assert users == ["fused_infer.cu", "fused_train.cu"]
    for header in ("encoder_fma.cuh", "encoder_mma.cuh"):
        users = [s.name for s in _build.sources()
                 if f'#include "{header}"' in s.read_text()]
        assert users == ["fused_decode.cu", "fused_encoder.cu"]
    assert '#include "tile_fma.cuh"' in (
        _build.CSRC / "encoder_fma.cuh").read_text()
    assert '#include "tile_mma.cuh"' in (
        _build.CSRC / "encoder_mma.cuh").read_text()
    users = [s.name for s in _build.sources()
             if '#include "tile_fma.cuh"' in s.read_text()]
    assert users == ["fused_infer.cu", "fused_train.cu", "viterbi.cu"]
    assert len(_build.sources()) == 7
    for entry in ("vqhmm_fused_infer", "vqhmm_fused_train",
                  "vqhmm_fused_encode", "vqhmm_fused_evidence",
                  "vqhmm_fused_decode", "vqhmm_vq_nearest",
                  "vqhmm_encoder_pack"):
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


@pytest.mark.parametrize("B,T,tile,blocks,threads,smem", [
    # published widths: C + H1 + H2 + K = 104 rows
    (64, 200, 64, 256, 288, 4 * (2 * 6144 + 8 + 72 * 104)),
    (1, 200, 16, 13, 128, 4 * (2 * 6144 + 8 + 24 * 104)),
    (460, 20, 64, 460, 288, 4 * (2 * 6144 + 8 + 72 * 104)),
    (1, 2327, 16, 146, 128, 4 * (2 * 6144 + 8 + 24 * 104)),
    (1, 37, 16, 3, 128, 4 * (2 * 6144 + 8 + 24 * 104)),
    (8, 512, 16, 256, 128, 4 * (2 * 6144 + 8 + 24 * 104))])
def test_encode_plan(B, T, tile, blocks, threads, smem):
    """The tile whose grid costs least in waves of resident blocks times a
    block's steps: one wave of 256 blocks of 64 steps at (64, 200) (two
    an SM), the narrowest tile where even it leaves SMs idle; for the bulk
    scorer's windows of 20, 460 blocks of 20 steps are two waves at tile
    64 (two an SM) and at 32 (three), and the wider tile, with more
    threads a block for the same steps, wins the tie (16 would need three
    waves)."""
    plan = encode_plan(PUBLISHED, B, T)
    assert (plan.tile, plan.blocks, plan.threads, plan.smem) == \
        (tile, blocks, threads, smem)
    assert not plan.split and plan.per_sm == (2 if tile == 64 else 3)
    assert plan.smem == smem_bytes(PUBLISHED, tile) <= SMEM_LIMIT


def test_launch_plan_bounds_and_source_constants():
    """The wrapper's counts are the kernels' own: the constants of
    csrc/encoder_fma.cuh, tile_fma.cuh and fused_encoder.cu, the row and
    packed-float formulas, the launch bound behind the register count."""
    import re

    from vqvaehmm_tpu_torch.ops import _build

    header = (_build.CSRC / "encoder_fma.cuh").read_text()
    tile_fma = (_build.CSRC / "tile_fma.cuh").read_text()
    src = (_build.CSRC / "fused_encoder.cu").read_text()
    assert re.search(rf"constexpr int HALO = {fe.HALO};", header)
    assert re.search(rf"constexpr int JB = {fe.JB};", header)
    assert re.search(rf"constexpr int MAX_THREADS = {fe.MAX_THREADS};",
                     header)
    assert re.search(rf"constexpr int SMEM_LIMIT = {SMEM_LIMIT};", header)
    assert re.search(rf"constexpr int WBUF = {fe.WBUF};", tile_fma)
    assert re.search(rf"constexpr int ROW_PAD = {fe.ROW_PAD};", tile_fma)
    assert "tile == 16 || tile == 32 || tile == 64" in header
    assert sorted(fe.TILES) == [16, 32, 64]
    assert "return tile + 2 * HALO + JB;" in header
    assert "return region_rows(d) + d.K + (d.HP > 0 ? d.K * d.K : 0);" \
        in header
    assert "const int e = d.C + d.H1 + d.H2, p = d.U + d.HP;" in header
    assert "(G + 3) / 4 * (tile / JB + 2)" in header
    # 64 registers a thread: 65536 / (MAX_THREADS * 2)
    assert "__launch_bounds__(encfma::MAX_THREADS, 2) fused_encoder_kernel" \
        in src
    assert fe._REGS == 65536 // (2 * fe.MAX_THREADS)
    # conv1 5 x 3 x 64, conv2 64 x 3 x 32, to_logits 32 x 4; the prior
    # 4 x 128 and 128 x round4(9)
    assert fe.packed_floats(5, 64, 32, 3) == 960 + 6144 + 128
    assert fe.packed_floats(5, 64, 32, 3, 4, 128) == 7232 + 512 + 1536
    assert fe.smem_dims_bytes(16, (5, 8, 8, 5, 4, 64)) == 4 * (
        2 * 6144 + 8 + 24 * (max(21, 68) + 5 + 25))
    for t in fe.TILES:
        assert fe.row_stride(t) % 4 == 0
        assert fe.block_threads(t, 64) % 32 == 0
        assert 128 <= fe.block_threads(t, 2048) <= fe.MAX_THREADS


def test_gate_refuses_layers_wider_than_a_weight_buffer():
    """A k=3 layer of more than WBUF / 3 outputs has no slab of one input
    channel: the gate refuses it (so does the shared memory it would
    take), and so does a narrower model in bfloat16."""
    assert fe.layers_fit(5, 2048, 8, 3)
    assert not fe.layers_fit(5, 8, 2052, 3)
    wide = ModelConfig(input_dim=5, hidden_dim=8, K=3, hidden_dim2=2052,
                       u_dim=4, trans_hidden=8)
    assert not encode_supported(wide, 1, 8)
    assert encode_supported(PUBLISHED, 0, 0)
    # H2 above H1: rows sized by each stage's own width
    deep = ModelConfig(input_dim=5, hidden_dim=8, K=5, hidden_dim2=32,
                       u_dim=4, trans_hidden=8)
    assert encode_supported(deep, 1, 8)
    assert smem_bytes(deep, 16) == 4 * (2 * 6144 + 8 + 24 * (5 + 8 + 32 + 5))
