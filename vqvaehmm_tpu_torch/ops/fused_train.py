"""Fused training step: the masked negative ELBO and all 18 parameter
gradients in one kernel call.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_train.py::_kernel (and the
loss assembly and log_prior chain of its wrapper) to hand-written CUDA
kernels for Hopper, csrc/fused_train.cu, whose header sets out the design
and the bound it meets.

* `fused_loss_and_grads(model, x, u, lengths, beta)` -> (loss, grads):
  the counterpart of the TPU kernel's wrapper, with `grads` a dict keyed
  like `model.state_dict()`.  On CUDA tensors it is one call of the C
  entry point (five kernels on the current stream: the weights packed for
  staging, the forward by time tiles, the activation gradients by time
  tiles, the weight gradients as a tiled reduction, and a fixed-order
  sum); on CPU tensors it is the plain version
  (`fused_loss_and_grads_reference`: compute_loss plus
  torch.autograd.grad).  `use_kernel=True` on a CPU tensor raises.
* Two numeric modes, from the model's compute_dtype (`bf16_mode`), as the
  TPU kernel's bf16_matmuls follows it: float32 (products as fp32 FMA
  chains on the CUDA cores), and for a bfloat16 model every product's two
  operands rounded to bfloat16 with float32 sums and every other value
  float32, the products on the tensor cores (csrc/tile_mma.cuh; the
  plain version: compute_loss(bf16_operands=True),
  ops/nn.py::bf16_matmul).  That is not the bfloat16 model's own plain
  path, whose activations are bfloat16: `loss_and_grads` is that path,
  what the trainer takes with fused=False.  The two modes have launch
  plans of their own (`train_plan`); `pack_mma_reference` is the plain
  version of the bfloat16 mode's weight packing.
* `fused_loss_and_grads_tiled`: a second plain version that computes the
  loss and the gradients the way the kernels do (time tiles with halos,
  the closed-form backward, partial sums per split), in either mode, so
  that the halo widths and the masks at tile edges are tested on the
  CPU.  Nothing on the card calls it.
* `train_plan(cfg, B, T)`: the launch plan (tile width, blocks, shared
  memory, scratch and partials sizes), pure Python.
* `FusedELBO`, a torch.autograd.Function: its forward runs the kernel and
  keeps the gradients, its backward hands them out scaled by the
  incoming gradient, so `loss.backward()` fills every parameter's `.grad`
  without a second kernel.  Like the TPU kernel it gives no gradient for
  x or u.
* `train_step_supported(cfg, B, T)`: the gate the trainer consults before
  it chooses the kernel.
* The global-normalisation mode, the TPU kernel's `axis_name` mode, for a
  rank of a data-parallel step (train/trainer.py, parallel/): `norm =
  (valid_to, mask_total, B_total)` of the whole global batch, taken by
  every function here, stands in for the batch's own max(lengths),
  sum(clamp(lengths, 0, T)) and B (`global_norm` makes it from the
  global lengths).  The loss and every gradient are then this rank's
  share, already globally scaled, and the ranks' sums are the global
  batch's (the log_prior chain is linear in the gradient, so summing
  after it is exact).  norm=None is the batch's own, as before.
  `fused_loss_and_flat_grads` returns the kernel's flat gradient vector
  for the one all-reduce a data-parallel step makes.

`fused_loss_and_grads.launches` counts the calls of the C entry point in
either mode, `fused_loss_and_grads.bf16_launches` those in the bfloat16
mode.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .fused_infer import H100_SMS, ROW_PAD, SMEM_LIMIT, WBUF, _packed
from .nn import bf16_round

# the kernel keeps K regimes a thread in registers (csrc/fused_train.cu)
KMAX = 16
_INT32_MAX = 2 ** 31 - 1
# time tiles the forward and backward kernels take; their halos (one step
# a k=3 convolution: four forward, three backward); steps a thread
TILES = (64, 32, 16)
HALO_FWD = 4
HALO_BWD = 3
JB = 4
# the weight-gradient kernel: a block owns WG_TILE x WG_TILE (output,
# input) pairs (WG_TILE_BF16 in the bfloat16 mode) and walks slabs of
# WG_SLAB time steps
WG_TILE = 32
WG_TILE_BF16 = 64
WG_SLAB = 32
# static shared memory of the forward and backward kernels (the doubles of
# the loss sums over MAX_THREADS threads), and an SM's shared memory: a
# resident block takes its own and 1 KB more of it
_STATIC_SMEM = 8 * 512 + 128
_SM_SMEM = 228 * 1024
# the bfloat16 mode's forward and backward blocks: MMA_THREADS threads
# (their loss sums' doubles are its static shared memory), at most
# MMA_BLOCKS_PER_SM resident an SM (__launch_bounds__(MMA_THREADS, 3))
MMA_THREADS = 256
MMA_BLOCKS_PER_SM = 3
_STATIC_SMEM_BF16 = 8 * MMA_THREADS + 128
# a block's fixed work (staging the weights, the barriers of 16 layers)
# in steps of a window, from the solo-block times of the serving forward
_FIXED_STEPS = 32

_count_lock = threading.Lock()

# the 18 parameter arrays in state_dict order, the kernel's argument order
PARAM_NAMES = (
    "encoder.conv1.weight", "encoder.conv1.bias",
    "encoder.conv2.weight", "encoder.conv2.bias",
    "encoder.to_logits.weight", "encoder.to_logits.bias",
    "prior.log_prior",
    "prior.transition_net.0.weight", "prior.transition_net.0.bias",
    "prior.transition_net.2.weight", "prior.transition_net.2.bias",
    "decoder.embeddings.weight",
    "decoder.conv1.weight", "decoder.conv1.bias",
    "decoder.conv2.weight", "decoder.conv2.bias",
    "decoder.to_params.weight", "decoder.to_params.bias",
)


def _widths(cfg):
    """(C, U, H1, H2, K, HP, D) of a model configuration."""
    return (cfg.input_dim, cfg.u_dim, cfg.hidden_dim, cfg.hidden_dim2,
            cfg.K, cfg.trans_hidden, cfg.hidden_dim)


def scratch_layout(cfg) -> Dict[str, Tuple[int, int]]:
    """name -> (first row, rows) of one sequence's scratch, rows of T
    floats (the same order as csrc/fused_train.cu::Rows): what the forward
    kernel leaves for the other two, then the activation gradients."""
    C, U, H1, H2, K, HP, D = _widths(cfg)
    out, at = {}, 0
    for name, rows in (("xm", C), ("uu", U), ("h1", H1), ("hp", HP),
                       ("h2", H2), ("q", K), ("lq", K), ("la", K * K),
                       ("e", D), ("hd1", D), ("hd2", D), ("dout", 2 * C),
                       ("dhd2", D), ("dhd1", D), ("de", D), ("dl", K),
                       ("dap", K * K), ("dh2", H2), ("dhp", HP),
                       ("dh1", H1)):
        out[name] = (at, rows)
        at += rows
    return out


def scratch_rows(cfg) -> int:
    """Rows of T floats of one sequence's scratch (the same count as
    csrc/fused_train.cu::scratch_rows)."""
    at, rows = scratch_layout(cfg)["dh1"]
    return at + rows


def weight_grad_jobs(cfg):
    """(gradient, dy rows, input rows, O, I, taps, has a bias) of the nine
    weight-gradient reductions gw[o][i][k] = sum_t dy[o][t] in[i][t-1+k],
    in the order of csrc/fused_train.cu::make_jobs."""
    C, U, H1, H2, K, HP, D = _widths(cfg)
    return (("encoder.conv1", "dh1", "xm", H1, C, 3, True),
            ("encoder.conv2", "dh2", "h1", H2, H1, 3, True),
            ("encoder.to_logits", "dl", "h2", K, H2, 1, True),
            ("prior.transition_net.0", "dhp", "uu", HP, U, 1, True),
            ("prior.transition_net.2", "dap", "hp", K * K, HP, 1, True),
            ("decoder.embeddings", "q", "de", K, D, 1, False),
            ("decoder.conv1", "dhd1", "e", D, D, 3, True),
            ("decoder.conv2", "dhd2", "hd1", D, D, 3, True),
            ("decoder.to_params", "dout", "hd2", 2 * C, D, 1, True))


class TrainPlan(NamedTuple):
    tile: int              # time steps a block of the forward and backward
    tiles: int             # ceil(T / tile)
    blocks: int            # B * tiles, of each of the two
    smem_fwd: int          # dynamic shared memory a block, bytes
    smem_bwd: int
    wg_tiles: int          # (output, input) tiles of the nine reductions
    splits: int            # fixed splits of the (sequence, slab) units
    units_per_split: int
    packed: int            # floats of the packed weights
    scratch_rows: int      # rows of T floats a sequence
    partials: int          # floats: splits * P
    loss_partials: int     # doubles: 3 a forward/backward block


def _buffer_rows(cfg) -> int:
    """Rows of one of the two ping-pong buffers: the widest layer, (mu,
    logvar) among them, the prior's hidden layer lying across both."""
    C, U, H1, H2, K, HP, D = _widths(cfg)
    return max(H1, H2, D, (HP + 1) // 2, 2 * C)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _mma_packed(O: int, I: int, taps: int) -> int:
    """bfloat16 values of one layer packed for the tensor cores
    (csrc/tile_mma.cuh::packed_elems)."""
    return _round16(O) * taps * _round16(I)


def _layers(cfg):
    """(O, I, taps) of the sixteen packed layers in the order of
    csrc/fused_train.cu::packed: the forward's nine, then the seven the
    backward convolves with."""
    C, U, H1, H2, K, HP, D = _widths(cfg)
    KK = K * K
    return ((H1, C, 3), (H2, H1, 3), (K, H2, 1), (D, K, 1), (D, D, 3),
            (D, D, 3), (2 * C, D, 1), (HP, U, 1), (KK, HP, 1),
            (D, 2 * C, 1), (D, D, 3), (D, D, 3), (K, D, 1), (H2, K, 1),
            (H1, H2, 3), (HP, KK, 1))


def packed_floats(cfg) -> int:
    """Floats of the packed weights a call allocates (the same count as
    csrc/fused_train.cu::packed): in the float32 mode the layers in the
    order the FMA slabs stage them, in the bfloat16 mode bfloat16 values
    in mma fragment order, two a float."""
    if bf16_mode(cfg):
        return sum(_mma_packed(*layer) for layer in _layers(cfg)) // 2
    return sum(_packed(*layer) for layer in _layers(cfg))


def mma_fragment_index(O: int, I: int, taps: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, i, k) of every value of a layer packed for the tensor cores, in
    packed order, by the index formulas of
    csrc/tile_mma.cuh::fragment_entry: for each m-tile of 16 output
    channels, each chunk (tap k, input channels [16 g, 16 g + 16)),
    tap-major, is a fragment of 256 values, 8 a lane, value e of lane l the
    A operand's a_e of mma.m16n8k16.  Entries with o >= O or i >= I are the
    zero padding."""
    idx = torch.arange(_mma_packed(O, I, taps))
    groups = _round16(I) // 16
    chunks = taps * groups
    f, lane, e = idx // 256, (idx // 8) % 32, idx % 8
    mt, c = f // chunks, f % chunks
    k, g = c // groups, c % groups
    o = 16 * mt + lane // 4 + 8 * ((e // 2) % 2)
    i = 16 * g + 2 * (lane % 4) + e % 2 + 8 * (e // 4)
    return o, i, k


def pack_mma_reference(w: torch.Tensor, taps: int, trans: bool = False
                       ) -> torch.Tensor:
    """Plain version of the bfloat16 mode's pack kernel
    (csrc/tile_mma.cuh::pack_fragments) for one layer: w is the torch
    tensor (O, I, taps) (a Linear's or an Embedding's (O, I) for taps 1),
    or with trans the tensor (I, O, taps) of the layer whose transpose is
    packed (output channel a, input channel b, tap k read w[b][a][taps - 1
    - k]).  Returns the packed values, rounded to bfloat16, as float32."""
    w = w.detach().to(torch.float32)
    w = w.reshape(w.shape[0], w.shape[1], taps)
    full = w.transpose(0, 1).flip(-1) if trans else w    # (O, I, taps)
    O, I = full.shape[:2]
    o, i, k = mma_fragment_index(O, I, taps)
    ok = (o < O) & (i < I)
    out = torch.zeros(o.shape)
    out[ok] = bf16_round(full[o[ok], i[ok], k[ok]])
    return out


def _smem(tile: int, halo: int, rows: int) -> int:
    return 4 * (2 * WBUF + ROW_PAD + _row_stride(tile, halo) * rows)


def _row_stride(tile: int, halo: int) -> int:
    return (tile + 2 * halo + JB + 3) // 4 * 4      # 16-byte rows


def _op_stride(n: int) -> int:
    """bfloat16 values a row of an operand of n channels
    (csrc/tile_mma.cuh::op_stride)."""
    return _round16(n) + 8


def smem_fwd_bytes(cfg, tile: int) -> int:
    """Dynamic shared memory of a forward block.  float32: two weight
    buffers, then x, u, two ping-pong buffers of the widest layer, q,
    log q, log_A.  bfloat16: the window's operands (two ping-pong buffers
    of the widest, x, u), time-major, then float32 rows for the logits,
    (mu, logvar) and log_A in turn."""
    C, U, H1, H2, K, HP, D = _widths(cfg)
    if bf16_mode(cfg):
        ops = 2 * _op_stride(max(H1, H2, D, HP, K)) + _op_stride(C) \
            + _op_stride(U)
        return 2 * (tile + 2 * HALO_FWD) * ops \
            + 4 * _row_stride(tile, HALO_FWD) * max(2 * K, 2 * C, K * K)
    G = _buffer_rows(cfg)
    return _smem(tile, HALO_FWD, C + U + 2 * G + 2 * K + K * K)


def smem_bwd_bytes(cfg, tile: int) -> int:
    """Dynamic shared memory of a backward block.  float32: two weight
    buffers, two ping-pong buffers, d(mu, logvar), q, log q, E de,
    d logits, log_A and d log_A.  bfloat16: the operands (two ping-pong
    buffers, d(mu, logvar), d logits, d log_A), then float32 q, log q,
    log_A and E de."""
    C, U, H1, H2, K, HP, D = _widths(cfg)
    if bf16_mode(cfg):
        ops = 2 * _op_stride(max(D, H2)) + _op_stride(2 * C) \
            + _op_stride(K) + _op_stride(K * K)
        return 2 * (tile + 2 * HALO_BWD) * ops \
            + 4 * _row_stride(tile, HALO_BWD) * (3 * K + K * K)
    G = _buffer_rows(cfg)
    return _smem(tile, HALO_BWD, 2 * G + 2 * C + 4 * K + 2 * K * K)


def param_count(cfg) -> int:
    C, U, H1, H2, K, HP, D = _widths(cfg)
    return (H1 * C * 3 + H1 + H2 * H1 * 3 + H2 + K * H2 + K + K + HP * U + HP
            + K * K * HP + K * K + K * D + 2 * (D * D * 3 + D) + 2 * C * D
            + 2 * C)


def train_plan(cfg, B: int, T: int, sms: int = H100_SMS
               ) -> Optional[TrainPlan]:
    """The launch plan at (B, T) in the model's mode (`bf16_mode`), or
    None where no tile fits a block's shared memory.  The tile is the one
    whose forward and backward grids cost least: waves of resident blocks
    (as many an SM as its shared memory holds, and in the bfloat16 mode at
    most MMA_BLOCKS_PER_SM) times the steps a block computes, its window
    and a fixed part; the wider of two that cost the same.  At B=64, T=200
    that is 256 blocks of 64 steps in either mode, one wave, not 448 of 32
    steps in two.  The weight gradients' (sequence,
    slab) units are cut into the fewest equal splits that give the grid
    eight blocks for every SM."""
    bf16 = bf16_mode(cfg)

    def fits(t):
        return max(smem_fwd_bytes(cfg, t), smem_bwd_bytes(cfg, t)) \
            + (_STATIC_SMEM_BF16 if bf16 else _STATIC_SMEM)

    def cost(t):
        resident = _SM_SMEM // (fits(t) + 1024)
        if bf16:
            resident = min(resident, MMA_BLOCKS_PER_SM)
        resident *= sms
        waves = -(-B * -(-T // t) // resident)
        return waves * (t + 2 * HALO_FWD + _FIXED_STEPS)

    tiles_ok = [t for t in TILES if fits(t) <= SMEM_LIMIT]
    if not tiles_ok:
        return None
    tile = min(tiles_ok, key=lambda t: (cost(t), -t))
    tiles = -(-T // tile)
    side = WG_TILE_BF16 if bf16 else WG_TILE
    wg_tiles = sum(-(-O // side) * -(-I // side)
                   for _, _, _, O, I, _, _ in weight_grad_jobs(cfg))
    units = B * -(-T // WG_SLAB)
    per = -(-units // max(1, min(units, 8 * sms // wg_tiles)))
    splits = -(-units // per)
    return TrainPlan(tile, tiles, B * tiles, smem_fwd_bytes(cfg, tile),
                     smem_bwd_bytes(cfg, tile), wg_tiles, splits, per,
                     packed_floats(cfg), scratch_rows(cfg),
                     splits * param_count(cfg), 3 * B * tiles)


_supported: dict = {}


def bf16_mode(cfg) -> bool:
    """Whether the kernel runs in its bfloat16-operand mode: the model's
    compute_dtype is bfloat16 (the TPU wrapper's bf16_matmuls)."""
    return cfg.compute_dtype == "bfloat16"


def infer_bf16_mode(cfg, device) -> bool:
    """Whether the inference kernels A, 8, 11 and 10 (ops/fused_infer.py,
    fused_encoder.py, fused_decode.py), and their plain versions where the
    wrappers take them, run in the bfloat16-operand mode on `device`: a
    float32 model whose matmul_precision is not "highest", on a CUDA
    device.  That is the JAX package's rule, `highest =
    matmul_precision == "highest"` (vqvaehmm_tpu/ops/pallas_infer.py:193,
    pallas_decode.py:296 and :338, models/vae_hmm.py:184), so "float32"
    takes the mode too, though JAX's XLA path then runs Precision.HIGH.  A
    bfloat16 model keeps its plain path, as JAX routes it around these
    kernels.  On the CPU the products are float32 at every precision, as
    they are in JAX's CPU backend and interpret mode."""
    return (torch.device(device).type == "cuda"
            and cfg.compute_dtype == "float32"
            and cfg.matmul_precision != "highest")


def train_step_supported(cfg, B: int, T: int) -> bool:
    """True when the fused train kernels take these shapes on Hopper:
    float32 or bfloat16 compute (the two modes), u-conditioned
    transitions, at most KMAX regimes (a thread keeps K values in
    registers), in the float32 mode a slab of every layer's weights within
    a weight buffer (the bfloat16 mode streams its weights from L2 and
    stages none), a time tile whose block fits the card's 227 KB of
    shared memory in the mode's plan, and one sequence's scratch within
    32-bit offsets.
    The trainer asks once a step, so the answer is kept a shape."""
    key = (_widths(cfg), cfg.compute_dtype, B, T)
    if key not in _supported:
        C, U, H1, H2, K, HP, D = _widths(cfg)
        _supported[key] = bool(
            cfg.compute_dtype in ("float32", "bfloat16") and U is not None
            and B > 0 and T > 0 and 1 <= K <= KMAX
            and (bf16_mode(cfg)
                 or 3 * ((max(_buffer_rows(cfg), HP) + 3) // 4 * 4) <= WBUF)
            and scratch_rows(cfg) * T <= _INT32_MAX
            and B * -(-T // TILES[-1]) <= _INT32_MAX
            and train_plan(cfg, B, T) is not None)
    return _supported[key]


def _u_strides(cfg, u: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, channel, time) strides of u, read as (B, U, T) when its
    dim 1 equals u_dim and as (B, T, U) otherwise (VAEHMM.prior's rule)."""
    sb, s1, s2 = u.stride()
    if u.shape[1] == cfg.u_dim:
        return sb, s1, s2
    return sb, s2, s1


Norm = Optional[Tuple[int, int, int]]


def global_norms(lengths, T: int) -> List[Tuple[int, int, int]]:
    """(valid_to, mask_total, B_total) of each global batch of a stacked
    epoch's lengths (batches, B_total), an array or a tensor (one host
    read): the norm argument of each of its ranks."""
    lens = torch.as_tensor(lengths).to("cpu", torch.int64)
    vt = lens.max(dim=1).values.tolist()
    msum = lens.clamp(0, T).sum(dim=1).tolist()
    return [(v, m, lens.shape[1]) for v, m in zip(vt, msum)]


def global_norm(lengths, T: int) -> Tuple[int, int, int]:
    """global_norms of one global batch's lengths (B_total,)."""
    return global_norms(torch.as_tensor(lengths).reshape(1, -1), T)[0]


def loss_and_grads(model, x: torch.Tensor, u: torch.Tensor,
                   lengths: torch.Tensor, beta, bf16_operands: bool = False,
                   norm: Norm = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """model.compute_loss and torch.autograd.grad, grads keyed like
    state_dict(): the model's own plain path (bfloat16 activations for a
    bfloat16 model), or with bf16_operands the kernel's bfloat16 mode;
    norm: the global batch's normalisation (module docstring)."""
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        loss = model.compute_loss(x, u, lengths, beta,
                                  bf16_operands=bf16_operands, norm=norm)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def fused_loss_and_grads_reference(model, x: torch.Tensor, u: torch.Tensor,
                                   lengths: torch.Tensor, beta,
                                   norm: Norm = None
                                   ) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
    """Plain version: loss_and_grads in the kernel's mode for the model
    (for a float32 model, compute_loss and autograd as they are)."""
    return loss_and_grads(model, x, u, lengths, beta,
                          bf16_operands=bf16_mode(model.cfg), norm=norm)


def _window(full: torch.Tensor, p0: int, W: int) -> torch.Tensor:
    """Steps [p0, p0 + W) of (B, R, T), zero outside [0, T)."""
    T = full.shape[-1]
    lo, hi = max(p0, 0), min(p0 + W, T)
    return F.pad(full[..., lo:hi], (lo - p0, p0 + W - hi))


def _conv_t(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The transposed k=3 convolution on a window, without padding:
    din[i][s] = sum_{o,k} w[o][i][k] dy[o][s + 1 - k] for s in [1, W - 1)."""
    return F.conv1d(dy, w.transpose(0, 1).flip(-1))


def fused_loss_and_grads_tiled(model, x: torch.Tensor, u: torch.Tensor,
                               lengths: torch.Tensor, beta, tile: int,
                               splits: Optional[int] = None,
                               norm: Norm = None
                               ) -> Tuple[torch.Tensor,
                                          Dict[str, torch.Tensor]]:
    """(loss, grads) computed the way csrc/fused_train.cu computes them, in
    plain PyTorch without autograd: the forward by time tiles of `tile`
    steps with a halo of 4, the closed-form activation gradients by tiles
    with a halo of 3 (reading the forward's activations and the
    neighbouring tiles' q and log_A from the scratch), the nine weight
    gradients as sums over (sequence, slab) units grouped into `splits`
    fixed splits, the loss from per-tile sums in double.  In the
    bfloat16 mode (bf16_mode) the weights and every activation that
    enters a product are rounded to bfloat16 there, and a unit's weight
    gradient sums float32 partials over chunks of 16 steps in order, as
    the kernel's mma accumulates them; the bias gradients sum the
    unrounded gradients.  norm: the global batch's normalisation."""
    cfg = model.cfg
    _check_inputs(model, x, u, lengths)
    C, U, H1, H2, K, HP, D = _widths(cfg)
    B, _, T = x.shape
    shapes = {n: w.shape for n, w in model.named_parameters()}
    rnd = bf16_round if bf16_mode(cfg) else (lambda a: a)
    # the 1x1 convolutions as matrices; the weights as a product reads them
    p = {n: rnd(w.detach().reshape(w.shape[0], -1))
         if n.endswith("weight") and w.dim() == 3 and w.shape[2] == 1
         else rnd(w.detach()) if n.endswith("weight")
         else w.detach() for n, w in model.named_parameters()}
    if u.shape[1] != cfg.u_dim:
        u = u.transpose(1, 2)
    lens = lengths.to(torch.int64)
    vt, msum, Bt = (int(lens.max()), int(lens.clamp(0, T).sum()), B) \
        if norm is None else norm
    vt = min(vt, T)
    s_r = 1.0 / max(msum * C, 1.0)
    s_p, s_h = -float(beta) / Bt, float(beta) / Bt
    log_pi = torch.log_softmax(p["prior.log_prior"], 0)
    sc = {name: torch.zeros(B, rows, T)
          for name, (_, rows) in scratch_layout(cfg).items()}
    sums = torch.zeros(3, dtype=torch.float64)
    steps = torch.arange(T)

    def relu_conv(a, name):
        return torch.relu(F.conv1d(rnd(a), p[name + ".weight"],
                                   p[name + ".bias"]))

    # ---- forward, a tile with its halo of 4 at a time ----
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        W, p0 = n + 2 * HALO_FWD, t0 - HALO_FWD
        pos = p0 + torch.arange(W)
        keep = ((pos >= 0) & (pos < T) & (pos < vt)).to(x.dtype)
        own = slice(t0, t0 + n)
        xs = _window(x, p0, W) * keep
        h1 = relu_conv(xs, "encoder.conv1") * keep[1:-1]
        h2 = relu_conv(h1, "encoder.conv2")
        logits = torch.einsum("ki,bit->bkt", p["encoder.to_logits.weight"],
                              rnd(h2)) + p["encoder.to_logits.bias"][:, None]
        lq = torch.log_softmax(logits, 1)
        q = torch.exp(lq)
        e = torch.einsum("kd,bkt->bdt", p["decoder.embeddings.weight"],
                         rnd(q)) * keep[2:-2]
        hd1 = relu_conv(e, "decoder.conv1") * keep[3:-3]
        hd2 = relu_conv(hd1, "decoder.conv2")
        out = torch.einsum("oi,bit->bot", p["decoder.to_params.weight"],
                           rnd(hd2)) + p["decoder.to_params.bias"][:, None]
        mu, lv = out[:, :C], out[:, C:]
        ev = torch.exp(lv)
        var = ev.clamp(min=1e-8)
        diff = mu - x[:, :, own]
        r = diff * diff / var
        mf = (steps[own][None, :] < lens[:, None]).to(x.dtype)[:, None, :]
        sums[0] += (0.5 * (math.log(2 * math.pi) + torch.log(var) + r)
                    * mf).double().sum()
        dmu = s_r * mf * diff / var
        dlv = torch.where(ev > 1e-8, s_r * mf * 0.5 * (1.0 - r),
                          torch.zeros(()))
        uu = u[:, :, own]
        hp = torch.relu(torch.einsum(
            "ju,but->bjt", p["prior.transition_net.0.weight"], rnd(uu))
            + p["prior.transition_net.0.bias"][:, None])
        la = torch.einsum("rj,bjt->brt", p["prior.transition_net.2.weight"],
                          rnd(hp)) + p["prior.transition_net.2.bias"][:, None]
        la = torch.log_softmax(la.view(B, K, K, n), 2).reshape(B, K * K, n)
        for name, val in (("xm", xs[:, :, 4:-4]), ("uu", uu),
                          ("h1", h1[:, :, 3:-3]), ("hp", hp),
                          ("h2", h2[:, :, 2:-2]), ("q", q[:, :, 2:-2]),
                          ("lq", lq[:, :, 2:-2]), ("la", la),
                          ("e", e[:, :, 2:-2]), ("hd1", hd1[:, :, 1:-1]),
                          ("hd2", hd2), ("dout", torch.cat([dmu, dlv], 1))):
            sc[name][:, :, own] = val

    # ---- activation gradients, a tile with its halo of 3 at a time ----
    emb = p["decoder.embeddings.weight"]
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        W, p0 = n + 2 * HALO_BWD, t0 - HALO_BWD
        pos = p0 + torch.arange(W)
        inside = (pos >= 0) & (pos < T)
        own = slice(t0, t0 + n)
        win = lambda name, a=0, b=0: _window(sc[name], p0 + a, W - a - b)  # noqa: E731
        dhd2 = torch.einsum("oi,bot->bit", p["decoder.to_params.weight"],
                            rnd(win("dout"))) * (win("hd2") > 0)
        dhd1 = _conv_t(rnd(dhd2), p["decoder.conv2.weight"]) \
            * (win("hd1", 1, 1) > 0)
        de = _conv_t(rnd(dhd1), p["decoder.conv1.weight"]) \
            * (inside & (pos < vt))[2:-2].to(x.dtype)
        # the per-step stage on window positions [2, W - 2)
        ts = pos[2:-2]
        ok = inside[2:-2].to(x.dtype)
        mf = (ts[None, :] < lens[:, None]).to(x.dtype)[:, None, :] * ok
        pm = mf * (ts >= 1).to(x.dtype)
        pmn = ((ts[None, :] + 1 < lens[:, None]) & (ts[None, :] + 1 < T)
               ).to(x.dtype)[:, None, :] * ok
        qt, lqt = win("q", 2, 2), win("lq", 2, 2)
        qp, qn = win("q", 1, 3), win("q", 3, 1)
        la = win("la", 2, 2).view(B, K, K, -1)
        lan = win("la", 3, 1).view(B, K, K, -1)
        gd = torch.einsum("kd,bdt->bkt", emb, rnd(de))
        in_t = torch.einsum("bit,bikt->bkt", qp, la)
        out_t = torch.einsum("bjt,bkjt->bkt", qn, lan)
        gq = gd + s_p * pm * in_t + s_p * pmn * out_t + s_h * mf * lqt
        gq = gq + s_p * log_pi[None, :, None] * (ts == 0).to(x.dtype)
        g = s_h * mf * qt + gq * qt
        dl = (g - qt * g.sum(1, keepdim=True)) * ok
        pair = s_p * pm[:, None] * qp[:, :, None, :] * qt[:, None, :, :]
        dap = ((pair - torch.exp(la) * pair.sum(2, keepdim=True)) * ok
               ).reshape(B, K * K, -1)
        mine = slice(1, 1 + n)                   # the tile's own steps
        init = (qt * log_pi[None, :, None]).sum(1) * (ts == 0).to(x.dtype)
        trans = torch.einsum("bit,bjt,bijt->bt", qp, qt, la) * pm[:, 0]
        sums[1] += (init + trans)[:, mine].double().sum()
        sums[2] += ((qt * lqt).sum(1) * mf[:, 0])[:, mine].double().sum()
        dh2 = torch.einsum("ki,bkt->bit", p["encoder.to_logits.weight"],
                           rnd(dl)) * (win("h2", 2, 2) > 0)
        dh1 = _conv_t(rnd(dh2), p["encoder.conv2.weight"]) \
            * (win("h1", 3, 3) > 0)
        dhp = torch.einsum("rj,brt->bjt", p["prior.transition_net.2.weight"],
                           rnd(dap[:, :, mine])) * (sc["hp"][:, :, own] > 0)
        for name, val in (("dhd2", dhd2[:, :, 3:-3]),
                          ("dhd1", dhd1[:, :, 2:-2]), ("de", de[:, :, 1:-1]),
                          ("dl", dl[:, :, mine]), ("dap", dap[:, :, mine]),
                          ("dh2", dh2[:, :, mine]), ("dhp", dhp),
                          ("dh1", dh1)):
            sc[name][:, :, own] = val

    # ---- weight gradients: (sequence, slab) units in fixed splits ----
    nslab = -(-T // WG_SLAB)
    units = B * nslab
    if splits is None:
        splits = train_plan(cfg, B, T).splits
    per = -(-units // splits)

    def by_unit(a, shift):
        """(B, R, T) -> (units, R, WG_SLAB) of a[..., t + shift]."""
        a = _window(a, shift, nslab * WG_SLAB)
        return a.view(B, -1, nslab, WG_SLAB).transpose(1, 2).reshape(
            units, -1, WG_SLAB)

    def in_splits(partial):
        """Sum the units of each split, then the splits, in order."""
        partial = F.pad(partial, (0, 0) * (partial.dim() - 1)
                        + (0, per * -(-units // per) - units))
        return partial.view(-1, per, *partial.shape[1:]).sum(1).sum(0)

    def chunked(a, b):
        """sum_t a[u, o, t] b[u, i, t] a unit, the bfloat16 mode's way:
        float32 partial sums over chunks of 16 steps, added to the unit's
        sum in order."""
        parts = torch.einsum("uoct,uict->cuoi",
                             a.view(*a.shape[:2], -1, 16),
                             b.view(*b.shape[:2], -1, 16))
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    product = chunked if bf16_mode(cfg) else (
        lambda a, b: torch.einsum("uot,uit->uoi", a, b))
    grads = {}
    for name, dy, inp, O, I, taps, bias in weight_grad_jobs(cfg):
        d = by_unit(sc[dy], 0)
        gw = torch.stack([product(rnd(d),
                                  rnd(by_unit(sc[inp], k - taps // 2)))
                          for k in range(taps)], -1)
        if name == "decoder.embeddings":
            grads[name + ".weight"] = in_splits(gw[..., 0])
            continue
        grads[name + ".weight"] = in_splits(gw if taps == 3 else gw[..., 0])
        if bias:
            grads[name + ".bias"] = in_splits(d.sum(-1))
    # the log_prior chain: g - softmax(log_prior) * sum(g)
    g = s_p * sc["q"][:, :, 0].sum(0)
    grads["prior.log_prior"] = g - torch.softmax(p["prior.log_prior"], 0) \
        * g.sum()
    loss = sums[0] / max(msum * C, 1.0) + float(beta) * (sums[2] - sums[1]) / Bt
    return loss.to(torch.float32), {n: grads[n].reshape(shapes[n])
                                    for n in PARAM_NAMES}


def _check_inputs(model, x, u, lengths):
    cfg = model.cfg
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"fused train step takes float32 x and u, got "
                        f"{x.dtype} and {u.dtype}")
    if x.dim() != 3 or x.shape[1] != cfg.input_dim:
        raise ValueError(f"x must be (B, C={cfg.input_dim}, T), got "
                         f"{tuple(x.shape)}")
    B, C, T = x.shape
    if u.dim() != 3 or u.shape[0] != B or not (
            tuple(u.shape[1:]) == (cfg.u_dim, T)
            or tuple(u.shape[1:]) == (T, cfg.u_dim)):
        raise ValueError(f"u must be (B, U={cfg.u_dim}, T) or (B, T, U), "
                         f"got {tuple(u.shape)} for x {tuple(x.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    for t in (x, u, lengths):
        if t.device != x.device:
            raise ValueError("x, u and lengths must be on one device")


def _kernel_call(lib, model, params, x, u, lengths, beta, stream,
                 norm: Norm = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the kernel through `lib` with params =
    dict(model.named_parameters()): (loss (), flat grads (P,)); norm None
    passes the kernel its sentinel, -1 each."""
    cfg = model.cfg
    weights = [params[n].detach() for n in PARAM_NAMES]
    for n, w in zip(PARAM_NAMES, weights):
        if w.device != x.device or w.dtype != torch.float32 \
                or not w.is_contiguous():
            raise ValueError(f"parameter {n} must be contiguous float32 on "
                             f"{x.device} (got {w.dtype} on {w.device})")
    B, C, T = x.shape
    dims = (B, C, T, cfg.u_dim, cfg.hidden_dim, cfg.hidden_dim2, cfg.K,
            cfg.trans_hidden, cfg.hidden_dim)
    plan = _checked_plan(lib, cfg, B, T, _build.sm_count(x.device))
    x = x.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    dev = x.device
    # one allocation: the packed weights, the scratch, the partials
    n_scratch = B * plan.scratch_rows * T
    work = torch.empty(plan.packed + n_scratch + plan.partials,
                       dtype=torch.float32, device=dev)
    loss_partials = torch.empty(plan.loss_partials, dtype=torch.float64,
                                device=dev)
    grads = torch.empty(param_count(cfg), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    base = work.data_ptr()
    err = lib.vqhmm_fused_train(
        x.data_ptr(), u.data_ptr(), *_u_strides(cfg, u), lengths.data_ptr(),
        *[w.data_ptr() for w in weights], base, base + 4 * plan.packed,
        base + 4 * (plan.packed + n_scratch), loss_partials.data_ptr(),
        grads.data_ptr(), loss.data_ptr(), *dims, plan.tile, plan.splits,
        int(bf16_mode(cfg)), float(beta),
        *((-1, -1, -1) if norm is None else map(int, norm)), stream)
    _build.check(err, "fused_train kernel launch")
    return loss, grads


_plans: dict = {}


def _checked_plan(lib, cfg, B: int, T: int, sms: int) -> TrainPlan:
    """train_plan at these shapes, held once against the sizes the built
    library reports (the scratch, gradient and packed layouts, the shared
    memory of the two tiled kernels)."""
    key = (_widths(cfg), cfg.compute_dtype, B, T, sms)
    plan = _plans.get(key)
    if plan is None:
        plan = train_plan(cfg, B, T, sms)
        if plan is None:
            raise ValueError(f"fused train step: no time tile of {cfg} fits "
                             f"a block's {SMEM_LIMIT} bytes of shared memory")
        dims = (B, cfg.input_dim, T, cfg.u_dim, cfg.hidden_dim,
                cfg.hidden_dim2, cfg.K, cfg.trans_hidden, cfg.hidden_dim)
        sizes = [lib.vqhmm_fused_train_sizes(*dims, plan.tile, what,
                                             int(bf16_mode(cfg)))
                 for what in range(6)]
        if sizes != [param_count(cfg), plan.scratch_rows, plan.smem_fwd,
                     plan.smem_bwd, plan.wg_tiles, plan.packed]:
            raise RuntimeError(f"fused_train kernel and wrapper disagree on "
                               f"the launch plan: {sizes} vs {plan}")
        _plans[key] = plan
    return plan


def split_grads(params, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The kernel's flat gradient vector as views shaped like the
    parameters (params = dict(model.named_parameters())), keyed like
    state_dict()."""
    shapes = [params[n].shape for n in PARAM_NAMES]
    parts = flat.split([s.numel() for s in shapes])
    return {n: p.view(s) for n, p, s in zip(PARAM_NAMES, parts, shapes)}


def _check_norm(norm: Norm, B: int) -> None:
    if norm is None:
        return
    vt, msum, Bt = norm
    if not (vt >= 0 and 0 <= msum < 2 ** 24 and Bt >= B):
        raise ValueError(f"norm=(valid_to, mask_total, B_total) must be of "
                         f"the global batch holding these {B} rows "
                         f"(mask_total below 2**24), got {norm}")


def _launch(model, params, x, u, lengths, beta, norm: Norm
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The checked kernel call on CUDA tensors, counted: (loss, flat)."""
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the fused "
                         "train step is a CUDA kernel")
    _check_inputs(model, x, u, lengths)
    B, _, T = x.shape
    if not train_step_supported(model.cfg, B, T):
        raise ValueError(f"fused train step unsupported at B={B}, T={T} "
                         f"for {model.cfg} (see train_step_supported)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    loss, flat = _kernel_call(_build.library(), model, params, x, u, lengths,
                              beta, stream, norm)
    with _count_lock:
        fused_loss_and_grads.launches += 1
        fused_loss_and_grads.bf16_launches += bf16_mode(model.cfg)
    return loss, flat


def fused_loss_and_flat_grads(model, x: torch.Tensor, u: torch.Tensor,
                              lengths: torch.Tensor, beta,
                              use_kernel: Optional[bool] = None,
                              norm: Norm = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, flat grads (P,)): fused_loss_and_grads with the gradients as
    the kernel leaves them, one vector in PARAM_NAMES order (the plain
    version's concatenated, on the CPU)."""
    _check_norm(norm, x.shape[0])
    if use_kernel or (use_kernel is None and x.is_cuda):
        return _launch(model, dict(model.named_parameters()), x, u, lengths,
                       beta, norm)
    loss, grads = fused_loss_and_grads_reference(model, x, u, lengths, beta,
                                                 norm)
    return loss, torch.cat([grads[n].reshape(-1) for n in PARAM_NAMES])


def fused_loss_and_grads(model, x: torch.Tensor, u: torch.Tensor,
                         lengths: torch.Tensor, beta,
                         use_kernel: Optional[bool] = None,
                         norm: Norm = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) of model.compute_loss(x, u, lengths, beta) in the
    kernel's mode for the model (bf16_mode), grads keyed like
    state_dict(); norm: the global batch's normalisation (module
    docstring).  The caller checks train_step_supported first; an
    unsupported shape raises here.  Both modes count in `launches`."""
    _check_norm(norm, x.shape[0])
    if use_kernel or (use_kernel is None and x.is_cuda):
        # one walk of the module tree a call
        params = dict(model.named_parameters())
        loss, flat = _launch(model, params, x, u, lengths, beta, norm)
        return loss, split_grads(params, flat)
    return fused_loss_and_grads_reference(model, x, u, lengths, beta, norm)


fused_loss_and_grads.launches = 0
fused_loss_and_grads.bf16_launches = 0


class FusedELBO(torch.autograd.Function):
    """loss = FusedELBO.apply(model, x, u, lengths, beta, norm, *params),
    with params = tuple(p for _, p in model.named_parameters()) and norm
    the global batch's normalisation, None for a local batch (module
    docstring).  The forward computes the loss and every parameter
    gradient in the kernel (or the plain version on the CPU); the backward
    returns grad_output * gradient for the parameters and None for the
    rest."""

    @staticmethod
    def forward(ctx, model, x, u, lengths, beta, norm, *params):
        loss, grads = fused_loss_and_grads(model, x, u, lengths, beta,
                                           norm=norm)
        ctx.save_for_backward(*[grads[n] for n, _ in
                                model.named_parameters()])
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        return ((None,) * 6
                + tuple(grad_output * g for g in ctx.saved_tensors))
