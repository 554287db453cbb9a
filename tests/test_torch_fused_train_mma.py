"""Kernel C's bfloat16 mode on the tensor cores, on the CPU: the weight
packing's plain version and the mode's launch plan.

The bfloat16 mode packs every layer's weights, rounded to bfloat16, in the
order the A operand of mma.m16n8k16 takes them
(csrc/tile_mma.cuh::pack_fragments; its plain version
ops/fused_train.py::pack_mma_reference).  These tests hold that packing
to the rounded weights and to their transposes at odd widths, rebuild each
layer from its fragments the way the PTX ISA lays out the A operand and
run it as the kernel does (tap-major chunks of 16, float32 sums a chunk)
against torch's convolution, and check the mode's launch plan and gate
against the constants of csrc/fused_train.cu.  The kernels themselves run
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 29)."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvaehmm_tpu_torch import ModelConfig
from vqvaehmm_tpu_torch.ops import _build
from vqvaehmm_tpu_torch.ops import fused_train as ft
from vqvaehmm_tpu_torch.ops.fused_infer import H100_SMS, SMEM_LIMIT
from vqvaehmm_tpu_torch.ops.nn import bf16_round

BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")
PUBLISHED = dict(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32, u_dim=4,
                 trans_hidden=128)
PROBE = dict(input_dim=16, hidden_dim=256, K=8, hidden_dim2=128, u_dim=4,
             trans_hidden=256)


def _weights(O, I, taps, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=(O, I, taps)).astype(np.float32))


def _unpack(packed, O, I, taps):
    """The (round16(O), round16(I), taps) grid the packed values fill, and
    how often each entry was written."""
    o, i, k = ft.mma_fragment_index(O, I, taps)
    O16, I16 = -(-O // 16) * 16, -(-I // 16) * 16
    grid = torch.zeros(O16, I16, taps)
    hits = torch.zeros(O16, I16, taps, dtype=torch.int64)
    grid[o, i, k] = packed
    hits.index_put_((o, i, k), torch.ones_like(o), accumulate=True)
    return grid, hits


# (O, I, taps) of the layers at odd widths: C=5, K=3 (K*K=9), 2C=10,
# HP=128, the probe's C=16, K=8, and widths past a chunk
LAYERS = [(64, 5, 3), (32, 64, 3), (3, 32, 1), (64, 3, 1), (10, 64, 1),
          (128, 4, 1), (9, 128, 1), (64, 10, 1), (128, 9, 1), (256, 16, 3),
          (8, 128, 1), (64, 256, 1), (256, 64, 1), (40, 24, 3), (17, 33, 3)]


@pytest.mark.parametrize("O,I,taps", LAYERS)
@pytest.mark.parametrize("trans", [False, True])
def test_pack_mma_reference_round_trips(O, I, taps, trans):
    """Every entry of the padded grid is packed exactly once; the packed
    values are the weights rounded to bfloat16 (for the transposed layer
    w[b][a][taps - 1 - k]) and zero in the padding."""
    w = _weights(I, O, taps, O + I) if trans else _weights(O, I, taps, O * I)
    packed = ft.pack_mma_reference(w, taps, trans=trans)
    assert packed.shape == (ft._mma_packed(O, I, taps),)
    assert packed.numel() % 256 == 0
    grid, hits = _unpack(packed, O, I, taps)
    assert bool((hits == 1).all())
    want = w.transpose(0, 1).flip(-1) if trans else w
    assert torch.equal(grid[:O, :I], bf16_round(want))
    assert float(grid[O:].abs().sum()) == 0.0
    assert float(grid[:, I:].abs().sum()) == 0.0
    # values are bfloat16 already: rounding again changes nothing
    assert torch.equal(bf16_round(packed), packed)


def _ptx_a(fragment):
    """A 16 x 16 A operand of mma.m16n8k16 from one packed fragment (32
    lanes x 8 values), as the PTX ISA lays it out: a0, a1, a4, a5 in row
    groupID and a2, a3, a6, a7 in row groupID + 8; a_e in column
    2 threadID_in_group + (e & 1), 8 more for e >= 4."""
    rows = (0, 0, 8, 8, 0, 0, 8, 8)
    cols = (0, 1, 0, 1, 8, 9, 8, 9)
    a = torch.zeros(16, 16)
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for e in range(8):
            a[gid + rows[e], 2 * tig + cols[e]] = fragment[lane * 8 + e]
    return a


def _emulate_layer(packed, O, I, taps, x):
    """out[o][j] of the bfloat16 mode's layer (csrc/tile_mma.cuh::layer)
    on x (I, N) zero-padded by taps // 2 a side, from the packed
    fragments: for each m-tile, the chunks in order (tap k outer, input
    channels [16 g, 16 g + 16) inner), a float32 sum a chunk."""
    H = taps // 2
    groups = -(-I // 16)
    N = x.shape[1]
    xp = F.pad(bf16_round(x), (H, H, 0, -(-I // 16) * 16 - I))
    frags = packed.view(-1, 256)
    out = torch.zeros(-(-O // 16) * 16, N)
    for mt in range(-(-O // 16)):
        acc = torch.zeros(16, N)
        for c in range(taps * groups):
            k, g = divmod(c, groups)
            a = _ptx_a(frags[mt * taps * groups + c])
            acc = acc + a @ xp[16 * g:16 * g + 16, k:k + N]
        out[16 * mt:16 * mt + 16] = acc
    return out[:O]


@pytest.mark.parametrize("O,I,taps", [(64, 5, 3), (10, 64, 1), (9, 128, 1),
                                      (40, 24, 3), (17, 33, 3)])
@pytest.mark.parametrize("trans", [False, True])
def test_packed_layer_computes_the_convolution(O, I, taps, trans):
    """The layer rebuilt from its fragments and run in the kernel's chunk
    order is the convolution (or, transposed, the gradient with respect
    to the layer's input) of the rounded operands: within 1e-5 of the
    largest output (float32 sums in another order)."""
    w = _weights(I, O, taps, 3 * O + I) if trans else _weights(O, I, taps, O)
    x = torch.from_numpy(np.random.default_rng(I).normal(
        size=(I, 37)).astype(np.float32))
    got = _emulate_layer(ft.pack_mma_reference(w, taps, trans=trans), O, I,
                         taps, x)
    wr, xr = bf16_round(w), bf16_round(x)[None]
    H = taps // 2
    if trans:
        # din[a][s] = sum_{b,k} w[b][a][k] dy[b][s + 1 - k]
        want = F.conv_transpose1d(xr, wr, padding=H)[0]
    else:
        want = F.conv1d(xr, wr, padding=H)[0]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_pack_follows_the_cuda_source():
    """The plain pack and the sizes follow csrc/tile_mma.cuh: 256 values a
    fragment, the chunk order, the operand rows' stride."""
    src = (_build.CSRC / "tile_mma.cuh").read_text()
    assert "const long long f = local >> 8;" in src
    assert "o = 16 * mt + (lane >> 2) + 8 * ((e >> 1) & 1);" in src
    assert "i = 16 * g + 2 * (lane & 3) + (e & 1) + 8 * (e >> 2);" in src
    assert "k = c / groups;" in src
    assert "return round16(n) + 8;" in src
    for n in (3, 5, 9, 16, 128):
        # an odd number of 16-byte words a row: ldmatrix's 8 rows fall on
        # distinct banks
        assert (2 * ft._op_stride(n) // 16) % 2 == 1
    cu = (_build.CSRC / "fused_train.cu").read_text()
    assert re.search(rf"constexpr int MMA_THREADS = {ft.MMA_THREADS};", cu)
    assert re.search(r"__launch_bounds__\(MMA_THREADS, "
                     rf"{ft.MMA_BLOCKS_PER_SM}\) train_forward_bf16_kernel",
                     cu)
    assert re.search(r"__launch_bounds__\(MMA_THREADS, "
                     rf"{ft.MMA_BLOCKS_PER_SM}\) train_backward_bf16_kernel",
                     cu)


def _cfg(widths, bf16):
    return ModelConfig(**widths, **(BF16 if bf16 else {}))


def _block_smem(cfg, tile):
    """Dynamic shared memory of the larger of a forward and a backward
    block, and its static part, restated from the layouts in
    csrc/fused_train.cu (smem_fwd_bf16, smem_bwd_bf16)."""
    C, U, H1, H2, K, HP, D = (cfg.input_dim, cfg.u_dim, cfg.hidden_dim,
                              cfg.hidden_dim2, cfg.K, cfg.trans_hidden,
                              cfg.hidden_dim)

    def st(n):
        return -(-n // 16) * 16 + 8

    def ws(halo):
        return (tile + 2 * halo + 4 + 3) // 4 * 4

    fwd = 2 * (tile + 8) * (2 * st(max(H1, H2, D, HP, K)) + st(C) + st(U)) \
        + 4 * ws(4) * max(2 * K, 2 * C, K * K)
    bwd = 2 * (tile + 6) * (2 * st(max(D, H2)) + st(2 * C) + st(K)
                            + st(K * K)) + 4 * ws(3) * (3 * K + K * K)
    assert ft.smem_fwd_bytes(cfg, tile) == fwd
    assert ft.smem_bwd_bytes(cfg, tile) == bwd
    return max(fwd, bwd) + 8 * 256 + 128


@pytest.mark.parametrize("widths,B,T,tile", [
    (PUBLISHED, 64, 200, 64), (PUBLISHED, 8, 200, 16),
    (PUBLISHED, 1, 1, 16), (PROBE, 256, 512, 32), (PROBE, 2, 37, 16),
    ({**PUBLISHED, "hidden_dim": 128}, 64, 200, 64)])
def test_bf16_train_plan(widths, B, T, tile):
    """The bfloat16 mode's plan: its own shared-memory layout, at most
    MMA_BLOCKS_PER_SM (3) blocks an SM, the tile of the fewest waves x
    steps; the weight
    gradients' tiles and splits as in the float32 mode."""
    cfg = _cfg(widths, True)
    plan = ft.train_plan(cfg, B, T)
    assert plan.tile == tile and plan.blocks == B * -(-T // tile)
    assert plan.smem_fwd == ft.smem_fwd_bytes(cfg, tile)
    assert plan.smem_bwd == ft.smem_bwd_bytes(cfg, tile)

    def cost(t):
        resident = min(228 * 1024 // (_block_smem(cfg, t) + 1024),
                       ft.MMA_BLOCKS_PER_SM)
        return -(-B * -(-T // t) // (H100_SMS * resident)) * (t + 8 + 32)

    assert _block_smem(cfg, tile) <= SMEM_LIMIT
    for other in ft.TILES:
        assert _block_smem(cfg, other) > SMEM_LIMIT \
            or (cost(tile), -tile) <= (cost(other), -other)
    # bfloat16 values two a float, every layer padded to 16 x 16 chunks
    assert plan.packed * 2 == sum(ft._mma_packed(*layer)
                                  for layer in ft._layers(cfg))
    # the weight gradients in (o, i) tiles of 64 a side, the (sequence,
    # slab) units in the fewest equal splits that give every SM eight
    # blocks, none empty
    assert plan.wg_tiles == sum(-(-O // 64) * -(-I // 64) for
                                _, _, _, O, I, _, _ in
                                ft.weight_grad_jobs(cfg))
    units = B * -(-T // ft.WG_SLAB)
    assert (plan.splits - 1) * plan.units_per_split < units \
        <= plan.splits * plan.units_per_split
    assert plan.splits * plan.wg_tiles <= max(8 * H100_SMS, plan.wg_tiles)
    f32 = ft.train_plan(_cfg(widths, False), B, T)
    assert (plan.partials // plan.splits, plan.scratch_rows) == (
        f32.partials // f32.splits, f32.scratch_rows)


def test_bf16_and_float32_plans_and_gates_apart():
    """The two modes are planned apart: other shared memory and packed
    sizes at the same widths, other tiles where the budgets differ, and
    the weight buffer's limit only in the float32 mode."""
    for widths in (PUBLISHED, PROBE):
        a, b = (ft.train_plan(_cfg(widths, bf16), 64, 200)
                for bf16 in (False, True))
        assert (a.smem_fwd, a.smem_bwd, a.packed, a.wg_tiles) != \
            (b.smem_fwd, b.smem_bwd, b.packed, b.wg_tiles)
        assert b.smem_fwd < a.smem_fwd
    # hidden 128 at (64, 200): a float32 block of 64 steps takes over half
    # an SM's shared memory, a bfloat16 one does not
    w128 = {**PUBLISHED, "hidden_dim": 128}
    assert ft.train_plan(_cfg(w128, False), 64, 200).tile == 32
    assert ft.train_plan(_cfg(w128, True), 64, 200).tile == 64
    # a layer too wide for a float32 weight buffer: refused there, taken
    # by the bfloat16 mode, which stages no weights
    wide = {**PUBLISHED, "hidden_dim": 2052}
    assert not ft.train_step_supported(_cfg(wide, False), 8, 64)
    assert ft.train_step_supported(_cfg(wide, True), 8, 64)
    assert ft.train_plan(_cfg(wide, True), 8, 64).tile == 16
    # operands too wide for a block's shared memory at every tile
    huge = _cfg({**PUBLISHED, "hidden_dim": 4096}, True)
    assert ft.train_plan(huge, 8, 64) is None
    assert not ft.train_step_supported(huge, 8, 64)
    # more regimes than a thread keeps
    assert not ft.train_step_supported(_cfg({**PUBLISHED, "K": 17}, True),
                                       64, 200)
    assert ft.train_step_supported(_cfg({**PUBLISHED, "K": 16}, True),
                                   64, 200)
    # the answers are kept per mode
    assert ft.train_step_supported(_cfg(wide, True), 8, 64) is True
    assert ft.train_step_supported(_cfg(wide, False), 8, 64) is False


def test_tiled_bf16_weight_gradients_sum_chunks_of_16():
    """The tiled version's bfloat16 weight gradients add float32 partials
    over chunks of 16 steps a unit (the kernel's two k16 mma chunks a slab
    of 32), here with T = 40 so that the last slab's second chunk is all
    padding: the loss and gradients stay with the reference plain version
    (1e-5 relative, 1e-4 of each leaf's largest entry)."""
    from tests.torch_port import inputs, model_pair, t

    _, _, tm = model_pair(seed=3, **BF16)
    x, u, lengths = (t(a) for a in inputs(2, 40, seed=5))
    loss, grads = ft.fused_loss_and_grads_tiled(tm, x, u, lengths, 1.0, 16,
                                                splits=1)
    want_loss, want = ft.fused_loss_and_grads_reference(tm, x, u, lengths,
                                                        1.0)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for name, w in want.items():
        assert float((grads[name] - w).abs().max()) \
            <= 1e-4 * float(w.abs().max()), name
