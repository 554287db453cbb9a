"""The staged weights of the inference kernels' bfloat16-operand mode
(kernels A and 11, and the second designs of kernels 8 and 10,
csrc/tile_mma.cuh::stage_plan and staged_layer): the wrappers'
shared-memory counts against the CUDA sources and the plans, the gates
against the operands-only rule they had before the weights were staged,
and the persistent grids' walk over the items.  The kernels themselves
run on the card (tests/test_torch_cuda.py)."""

import re

import pytest

from vqvaehmm_tpu_torch import ModelConfig
from vqvaehmm_tpu_torch.ops import _build
from vqvaehmm_tpu_torch.ops import fused_decode as fd
from vqvaehmm_tpu_torch.ops import fused_encoder as fe
from vqvaehmm_tpu_torch.ops import fused_infer as fi

PUBLISHED = dict(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32, u_dim=4,
                 trans_hidden=128)
# the widths the tests use: the published model; the probe's (C=16,
# hidden 256/128, K=8); the published model at C=16
WIDTHS = {"published": PUBLISHED,
          "probe": dict(input_dim=16, hidden_dim=256, K=8, hidden_dim2=128,
                        u_dim=4, trans_hidden=256),
          "c16": dict(PUBLISHED, input_dim=16)}
# where the weights go at every tile, kernels A, 11, 8 and 10: 36352,
# 13824, 9728 and 13824 packed values at the published widths (72.7, 27.6,
# 19.5 and 27.6 KB) fit beside the operands; the probe's 518144, 133120,
# 112640 and 133120 do not (kernel 10 stages only resident weights)
KIND = {"published": ("resident",) * 4,
        "probe": ("ring", "ring", "ring", "direct"),
        "c16": ("resident",) * 4}
SMS = fi.H100_SMS


def _cfg(w):
    return ModelConfig(**w, matmul_precision="default")


def _a(w):
    return (w["input_dim"], w["hidden_dim"], w["hidden_dim2"], w["K"],
            w["hidden_dim"])


def test_stage_plan_follows_the_cuda_source():
    """The wrappers' constants and prefetch counts restate tile_mma.cuh's,
    fused_infer.cu's and fused_decode.cu's, and kernel A walks its items
    as `_walk` does."""
    mma = (_build.CSRC / "tile_mma.cuh").read_text()
    assert f"constexpr int RING_SLOTS = {fi.RING_SLOTS};" in mma
    assert "constexpr int RING_MTILES = 8;" in mma
    assert fi.SLOT_ELEMS == 8 * 256
    assert "constexpr int SLOT_ELEMS = RING_MTILES * 256;" in mma
    assert "constexpr int CTRL_BYTES = 8 * 2 * RING_SLOTS + 32 * 8;" in mma
    assert fi.CTRL_BYTES == 8 * 2 * fi.RING_SLOTS + 32 * 8
    assert re.search(r"const long long resident = base \+ prefetch \+ "
                     r"CTRL_BYTES \+ 2 \* elems;", mma)
    infer = (_build.CSRC / "fused_infer.cu").read_text()
    assert "(long long)sizeof(float) * C * op_rows_bf16(tile)," in infer
    assert "for (int item = blockIdx.x; item < items; item += gridDim.x)" \
        in infer
    decode = (_build.CSRC / "fused_decode.cu").read_text()
    assert "return tilemma::stage_plan(base, 0, encmma::packed(d).total," \
        in decode
    # kernel 8's second design: the operands, the next item's raw x window,
    # the weights; its walk is kernel A's
    encoder = (_build.CSRC / "fused_encoder.cu").read_text()
    assert f"constexpr int STAGED_BLOCKS_PER_SM = " \
        f"{fe.STAGED_BLOCKS_PER_SM};" in encoder
    assert "__launch_bounds__(encmma::THREADS, STAGED_BLOCKS_PER_SM)\n" \
        "    fused_encoder_bf16_staged_kernel" in encoder
    assert ("return tilemma::stage_plan(encmma::smem_bytes(d, tile),\n"
            "                             4LL * d.C * encmma::op_rows(tile),"
            "\n                             encmma::packed(d).total, "
            "encfma::SMEM_LIMIT);") in encoder
    assert "for (int item = blockIdx.x; item < items; item += gridDim.x)" \
        in encoder
    # kernel 10's: the control region and the five layers after its stage
    assert ("? (tilemma::CTRL_BYTES + 2 * (int)encmma::packed(d).total) / 4"
            in decode)
    assert "decode_stage_floats<BF16>(d, tile) +\n                " \
        "decode_weight_floats<KIND>(d) +" in decode


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_staged_smem_against_the_plan(name):
    """A block's shared memory at every tile: the operands, then the
    weights resident (kernel A with the next item's raw x; the control
    region), else a ring of as many 4 KB slots as fit (up to 8), else
    none; the plans carry the same count and kind, kernel 11's weights
    staged only where its grid leaves an SM a block at most."""
    w = WIDTHS[name]
    cfg = _cfg(w)
    dims11 = fe.encoder_dims(cfg, prior=True)
    dims8 = fe.encoder_dims(cfg)
    C, U = w["input_dim"], w["u_dim"]
    for tile in fe.TILES:
        for ops, prefetch, elems, got, kind in (
                (fi.operand_bytes(tile, *_a(w)), 4 * C * (tile + 8),
                 fi.packed_bf16(*_a(w)), fi.bf16_stage(tile, *_a(w)),
                 KIND[name][0]),
                (fd.evidence_stage_bytes(cfg, tile, True), 0,
                 fe.packed_bf16(*dims11), fe.evidence_stage(tile, dims11),
                 KIND[name][1]),
                (fe.smem_bytes(cfg, tile, True), 4 * C * (tile + 4),
                 fe.packed_bf16(*dims8), fe.encode_stage(tile, dims8),
                 KIND[name][2])):
            resident = ops + prefetch + fi.CTRL_BYTES + 2 * elems
            slots = min(8, (fi.SMEM_LIMIT - ops - fi.CTRL_BYTES) // 4096)
            want = (("resident", 0, resident)
                    if resident <= fi.SMEM_LIMIT else
                    ("ring", slots, ops + fi.CTRL_BYTES + 4096 * slots)
                    if slots >= 2 else ("direct", 0, ops))
            assert tuple(got) == want and got.weights == kind, (tile, got)
        assert fi.smem_bytes(tile, *_a(w), True) == \
            fi.bf16_stage(tile, *_a(w)).bytes
        assert fd.evidence_smem_bytes(cfg, tile, True) == \
            fe.evidence_stage(tile, dims11).bytes
        assert tuple(fe.evidence_stage(tile, dims11, False)) == (
            "direct", 0, fd.evidence_stage_bytes(cfg, tile, True))
        # kernel 10's second design: its weights after the stage region,
        # where a block of one tile still fits
        for ntb in (1, 2, 5):
            staged = fd.decode_smem_bytes(cfg, tile, ntb, True, True)
            assert staged == fd.decode_smem_bytes(cfg, tile, ntb, True) + \
                fi.CTRL_BYTES + 2 * fe.packed_bf16(*dims11)
        fits10 = fd.decode_smem_bytes(cfg, tile, 1, True, True) \
            <= fi.SMEM_LIMIT
        assert fits10 == (KIND[name][3] == "resident"), tile
    for B, T in ((64, 200), (1, 200), (460, 20), (1, 2327)):
        a = fi.launch_plan(B, T, *_a(w), bf16=True)
        assert (a.smem, a.weights) == (
            fi.smem_bytes(a.tile, *_a(w), True), KIND[name][0])
        e = fd.evidence_plan(cfg, B, T, bf16=True)
        staged = e.blocks <= SMS
        assert (e.smem, e.weights) == (
            fe.evidence_stage(e.tile, dims11, staged).bytes,
            KIND[name][1] if staged else "direct")
        assert e.smem <= fi.SMEM_LIMIT and e.threads == fe.MMA_THREADS
        # kernel 8: the first design's tile; the second design's block
        # where a block computes at most STAGED_STEPS steps (the requests
        # and the windows of 20), else the first design's (64, 200)
        p = fe.encode_plan(cfg, B, T, bf16=True)
        first = fe.plan_for(B, T, dims8, bf16=True)
        assert (p.tile, p.blocks, p.threads) == (first.tile, first.blocks,
                                                 first.threads)
        few = min(p.tile, T) <= fe.STAGED_STEPS
        assert few == ((B, T) != (64, 200))
        assert (p.smem, p.weights) == (
            (fe.encode_stage(p.tile, dims8).bytes, KIND[name][2]) if few
            else (first.smem, "direct"))
        assert fe.smem_bytes(cfg, p.tile, True) == first.smem
        # at the published widths a request (1, 200) stages; the bulk
        # shapes' grids hold more blocks than SMs
        if name == "published":
            assert staged == ((B, T) == (1, 200))


@pytest.mark.parametrize("which", ["fused_infer", "fused_evidence",
                                   "fused_encode", "fused_decode"])
def test_staged_gates_refuse_nothing_the_operands_fit(which):
    """The gates and plans take every model whose operands fit a block at
    the narrowest tile, as they did before the weights were staged: at
    the edge the weights are read from L2 (direct; kernel 8 then runs its
    first design), below it they are resident or on a ring.  Kernel 10's
    gate is its first design's (its second design is taken only where it
    keeps the first's tiles a block, ops/fused_decode.py::decode_plan)."""
    taken = 0
    for h in list(range(16, 400, 48)) + list(range(2000, 3200, 16)):
        if which == "fused_infer":
            w = (5, 8, h, 3, 8)
            fits = fi.operand_bytes(16, *w) <= fi.SMEM_LIMIT
            try:
                plan = fi.launch_plan(1, 8, *w, bf16=True)
            except ValueError:
                plan = None
            assert (plan is not None) == fits, h
            stage = fi.bf16_stage(16, *w)
        elif which == "fused_encode":
            cfg = _cfg(dict(PUBLISHED, hidden_dim=8, hidden_dim2=h))
            dims = fe.encoder_dims(cfg)
            fits = fe.smem_bytes(cfg, 16, True) <= fi.SMEM_LIMIT
            assert fe.encode_supported(cfg, 0, 0, bf16=True) == fits, h
            plan = fe.encode_plan(cfg, 1, 8, bf16=True)
            assert (plan is not None) == fits, h
            stage = fe.encode_stage(16, dims)
            if fits:
                assert plan.grid == (0 if stage.weights == "direct" else 1)
        else:
            cfg = _cfg(dict(PUBLISHED, trans_hidden=h))
            fits = (fd.evidence_stage_bytes(cfg, 16, True) <= fi.SMEM_LIMIT
                    and fd.decode_smem_bytes(cfg, 16, 1, True)
                    <= fi.SMEM_LIMIT)
            assert fd.supported(cfg, 0, 0, bf16=True) == fits, h
            stage = fe.evidence_stage(16, fe.encoder_dims(cfg, prior=True))
            if which == "fused_decode":
                # the second design holds more than the first, never less
                assert fd.decode_smem_bytes(cfg, 16, 1, True, True) > \
                    fd.decode_smem_bytes(cfg, 16, 1, True)
        if fits:
            taken += 1
            assert stage.bytes <= fi.SMEM_LIMIT, h
    assert taken > 10
    # the last width that fits at the edge of kernels A and 8 takes L2
    edge = max(h for h in range(16, 4000, 16)
               if fi.operand_bytes(16, 5, 8, h, 3, 8) <= fi.SMEM_LIMIT)
    assert fi.bf16_stage(16, 5, 8, edge, 3, 8).weights == "direct"
    cfg = _cfg(dict(PUBLISHED, hidden_dim=8, hidden_dim2=2880))
    assert fe.encode_stage(16, fe.encoder_dims(cfg)).weights == "direct"
    assert fe.encode_plan(cfg, 1, 8, bf16=True).grid == 0


def _walk(grid, items):
    """The items each block of a persistent grid takes, as kernel A's
    bfloat16 mode walks them (csrc/fused_infer.cu: for item = blockIdx.x;
    item < items; item += gridDim.x)."""
    return [list(range(i, items, grid)) for i in range(grid)]


@pytest.mark.parametrize("B,T", [(64, 200), (1, 200), (460, 20), (1, 2327),
                                 (8, 512), (1, 5), (1000, 200), (3, 37)])
@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_persistent_grid_covers_every_item_once(B, T, name):
    """Kernel A's grid in the mode walks the items blockIdx.x, blockIdx.x +
    grid, ...: every item exactly once.  Resident weights take the blocks
    that stay resident (2 an SM, as shared memory allows), each staging
    its weights once; a ring takes a block an item.  Kernel 11 takes a
    block an item (it stages only where the grid leaves an SM a block at
    most).  Kernel 8's second design walks as kernel A does (2 blocks an
    SM)."""
    w = WIDTHS[name]
    a = fi.launch_plan(B, T, *_a(w), bf16=True)
    walked = _walk(a.grid, a.blocks)
    flat = sorted(i for block in walked for i in block)
    assert flat == list(range(a.blocks))
    assert all(walked), "a block without an item"
    per_sm = min(fi.MMA_BLOCKS_PER_SM, fi.SM_SMEM // (a.smem + 1024))
    if a.weights == "resident":
        assert a.grid == min(a.blocks, per_sm * SMS)
    else:
        assert a.grid == a.blocks
    assert a.blocks == B * -(-T // a.tile)
    e = fd.evidence_plan(_cfg(w), B, T, bf16=True)
    assert e.blocks == B * -(-T // e.tile) * (2 if e.split else 1)
    # kernel 8's second design walks its items as kernel A does; its first
    # takes a block an item
    p = fe.encode_plan(_cfg(w), B, T, bf16=True)
    walked = _walk(p.grid or p.blocks, p.blocks)
    assert sorted(i for block in walked for i in block) == \
        list(range(p.blocks))
    assert all(walked) and p.blocks == B * -(-T // p.tile)
    per_sm = min(fe.STAGED_BLOCKS_PER_SM, fi.SM_SMEM // (p.smem + 1024))
    assert p.grid == (min(p.blocks, per_sm * SMS) if p.weights == "resident"
                      else p.blocks if p.weights == "ring" else 0)
    assert (p.grid > 0) == (min(p.tile, T) <= fe.STAGED_STEPS)
