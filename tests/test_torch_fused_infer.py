"""The port's fused serving forward (vqvaehmm_tpu_torch/ops/fused_infer.py).

On the CPU its wrapper computes the plain version, which is held here
against the JAX package's Pallas kernel run in interpret mode (as
tests/test_pallas_infer.py runs it).  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, inputs, model_pair, t
from vqvaehmm_tpu.ops.pallas_infer import fused_forward as jax_fused
from vqvaehmm_tpu_torch.ops import fused_infer as fi
from vqvaehmm_tpu_torch.ops.fused_infer import (fused_forward,
                                                fused_forward_reference,
                                                launch_plan, valid_to_rows)


@pytest.mark.parametrize("B,T,kind", [(4, 24, "none"), (2, 40, "scalar"),
                                      (4, 24, "vector")])
def test_reference_matches_pallas_kernel(B, T, kind):
    jm, params, tm = model_pair(seed=B * 100 + T, hidden_dim=16,
                                hidden_dim2=8)
    x, _, lengths = inputs(B, T, seed=T)
    vt = {"none": None, "scalar": T - 9, "vector": lengths}[kind]
    with torch.no_grad():
        got = fused_forward_reference(
            tm, t(x), valid_to=t(vt) if kind == "vector" else vt)
    want = jax_fused(jm, params, jnp.asarray(x),
                     valid_to=None if vt is None else jnp.asarray(vt),
                     interpret=True)
    for g, w, name, tol in zip(got, want, ("mu", "logvar", "q"),
                               (1e-4, 1e-4, 1e-5)):
        close(g, w, tol, name)


def test_cpu_dispatch_takes_plain_version():
    _, _, tm = model_pair(seed=3)
    x, _, lengths = inputs(3, 20, seed=4)
    before = fused_forward.launches
    with torch.no_grad():
        got = fused_forward(tm, t(x), valid_to=t(lengths))
        want = fused_forward_reference(tm, t(x), valid_to=t(lengths))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="CUDA"):
            fused_forward(tm, t(x), use_kernel=True)
    assert fused_forward.launches == before


def test_valid_to_rows():
    dev = torch.device("cpu")
    assert valid_to_rows(None, 3, 17, dev).tolist() == [17, 17, 17]
    assert valid_to_rows(5, 2, 17, dev).tolist() == [5, 5]
    assert valid_to_rows(torch.tensor([4, 9]), 2, 17, dev).dtype \
        == torch.int32
    with pytest.raises(ValueError):
        valid_to_rows(np.array([1, 2, 3]), 2, 17, dev)


PUBLISHED = (5, 64, 32, 3, 64)          # C, H1, H2, K, D
PROBE = (16, 256, 128, 8, 256)
WIDE_INPUT = (40, 64, 32, 3, 64)        # 2C above every hidden width
NARROW_HIDDEN = (5, 8, 8, 3, 8)


@pytest.mark.parametrize("B,T,widths,tile", [
    (64, 200, PUBLISHED, 64), (1, 200, PUBLISHED, 16), (1, 37, PUBLISHED, 16),
    (8, 512, PUBLISHED, 16), (1, 1, PUBLISHED, 16), (460, 20, PUBLISHED, 64),
    (64, 200, PROBE, 64), (1, 2327, PUBLISHED, 16),
    (64, 200, WIDE_INPUT, 64), (3, 37, NARROW_HIDDEN, 16)])
def test_launch_plan(B, T, widths, tile):
    """The widest tile whose grid still has a block for every SM; where
    B * T is too small for that, the narrowest (the most blocks); the
    shared memory within a Hopper block's 227 KB."""
    plan = launch_plan(B, T, *widths)
    assert plan.tile == tile and plan.blocks == B * -(-T // tile)
    assert plan.smem == fi.smem_bytes(tile, *widths) <= fi.SMEM_LIMIT
    assert plan.blocks >= fi.H100_SMS or tile == fi.TILES[-1]
    for wider in (w for w in fi.TILES if w > tile):
        assert B * -(-T // wider) < fi.H100_SMS \
            or fi.smem_bytes(wider, *widths) > fi.SMEM_LIMIT


def test_launch_plan_bounds_and_source_constants():
    import re
    from vqvaehmm_tpu_torch.ops import _build

    assert fi.SMEM_LIMIT == 227 * 1024
    assert launch_plan(64, 200, *PUBLISHED, sms=300).tile == 32
    # C + 2 max(H1, H2, D) + K rows of tile + 2 halos + JB floats, after
    # the two weight buffers
    assert fi.smem_bytes(64, *PUBLISHED) == 4 * (2 * 6144 + 8 + 76 * 136)
    assert fi.packed_floats(*PUBLISHED) == 32768
    # the last layer leaves 2C rows of (mu, logvar) in a buffer: where 2C
    # is above every hidden width the buffers hold 2C rows
    assert fi.smem_bytes(64, *WIDE_INPUT) == 4 * (
        2 * 6144 + 8 + 76 * (40 + 2 * 80 + 3))
    assert fi.smem_bytes(16, *NARROW_HIDDEN) == 4 * (
        2 * 6144 + 8 + 28 * (5 + 2 * 10 + 3))
    with pytest.raises(ValueError, match="input_dim"):
        launch_plan(1, 8, 4000, 64, 32, 3, 64)
    with pytest.raises(ValueError, match=str(fi.SMEM_LIMIT)):
        launch_plan(1, 8, 5, 1024, 8, 3, 1024)
    with pytest.raises(ValueError, match="hidden widths"):
        launch_plan(1, 8, 5, 4096, 8, 3, 4096)
    src = (_build.CSRC / "fused_infer.cu").read_text()
    header = (_build.CSRC / "tile_fma.cuh").read_text()
    assert re.search(rf"constexpr int HALO = {fi.HALO};", src)
    assert re.search(rf"constexpr int JB = {fi.JB};", src)
    assert re.search(rf"constexpr int WBUF = {fi.WBUF};", header)
    assert "tile != 16 && tile != 32 && tile != 64" in src
    assert "C + 2 * buffer_rows(C, H1, H2, D) + K" in src
    assert "return h > 2 * C ? h : 2 * C;" in src
    assert sorted(fi.TILES) == [16, 32, 64]
