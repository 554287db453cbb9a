"""Operations and bytes of the model's kernels, from the layers' shapes
and the steps the inputs need.

Frozen from the port's `chip_smoke.py` (`token_flops`, `weight_bytes`,
`kernel_bounds`, `gather_bound`), with one change: a call is counted over
the steps its inputs need, the sum of `lengths` where the entry takes
them (the whole T where it takes none), not B x T padded steps.  Each
input byte is counted read once and each output byte written once.  The
counts are written from the layers' shapes (reference/vaehmm.py's
layout), so another kernel that does the same work reads the same."""

from __future__ import annotations

import math
from typing import Tuple

from ..reference.vaehmm import Dims, layout
from .device import PEAK_BYTES


def token_flops(d: Dims) -> Tuple[int, int, int]:
    """FLOPs a time step of the encoder, the prior MLP and the decoder
    (a multiply and an add each)."""
    C, H1, H2, K, D = d.C, d.H1, d.H2, d.K, d.H1
    enc = 2 * (3 * C * H1 + 3 * H1 * H2 + H2 * K)
    prior = 2 * (d.U * d.HP + d.HP * K * K)
    dec = 2 * (K * D + 3 * D * D + 3 * D * D + D * 2 * C)
    return enc, prior, dec


def weight_bytes(d: Dims, part: str = "", bf16: bool = False) -> int:
    """Bytes of the parameters whose names start with `part` ("" all,
    "encoder.", "prior.", "decoder."), each read once: float32, or with
    bf16 the weights (two or more dimensions) at 2 bytes and the biases
    at 4."""
    return sum((2 if bf16 and len(shape) > 1 else 4) * math.prod(shape)
               for name, shape, _, _ in layout(d) if name.startswith(part))


def bound_s(flops: float, nbytes: float, peak_flops: float
            ) -> Tuple[float, str]:
    """(least seconds the card could take, what bounds it): the larger of
    the operations over the peak for their type and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def train_work(d: Dims, B: int, steps: int) -> Tuple[int, int]:
    """Kernel C, one training step of B rows holding `steps` valid steps
    in all: the forward and a backward of twice its operations; x, u,
    lengths and the weights read, the loss and one gradient a weight
    written."""
    enc, prior, dec = token_flops(d)
    return (3 * steps * (enc + prior + dec),
            4 * steps * (d.C + d.U) + 4 * B + 2 * weight_bytes(d) + 4)


def encode_work(d: Dims, B: int, steps: int) -> Tuple[int, int]:
    """Kernel 8 (the posterior's encoder): x -> logits over `steps`."""
    enc, _, _ = token_flops(d)
    return (steps * enc,
            4 * steps * (d.C + d.K) + 4 * B + weight_bytes(d, "encoder."))


def evidence_work(d: Dims, B: int, steps: int) -> Tuple[int, int]:
    """Kernel 11: x, u -> log_obs, log_A over `steps` valid steps."""
    enc, prior, _ = token_flops(d)
    K = d.K
    return (steps * (enc + prior + 4 * (K + K * K)),
            4 * steps * (d.C + d.U + K + K * K) + 4 * B
            + weight_bytes(d, "encoder.") + weight_bytes(d, "prior."))


def viterbi_work(d: Dims, B: int, steps: int) -> Tuple[int, int]:
    """Kernel B: log_A, log_obs, lengths, log_pi -> states, scores, over
    `steps` valid steps (steps - B transitions)."""
    K = d.K
    return ((steps - B) * (2 * K * K + K),
            4 * steps * (K * K + K + 1) + 8 * B + 4 * K)


def gather_work(d: Dims, T: int, windows: int, steps: int
                ) -> Tuple[int, int]:
    """Kernel D: the triples read, each window's valid steps of the pool
    read and its T steps written (zeros past its length)."""
    return 0, 3 * 4 * windows + 4 * (d.C + d.U) * (windows * T + steps)
