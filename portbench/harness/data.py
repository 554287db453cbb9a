"""Weights and data made from the seed, on the device, in a few large
calls.

`regime_panels` draws the regime-switching panels of the port's
`data/synthetic.py::synthetic_sequences` (a frozen copy of its model):
per seed K regimes with feature means N(0, 1), scales (0.3 + U(0, 0.4))
x noise_scale and covariate means N(0, 1); a sticky chain that stays
with probability `stickiness` and otherwise moves to one of the other
K - 1 regimes uniformly; x = mean + scale * N(0, 1) and u = mean + 0.2 *
N(0, 1) a step.  The original draws step by step on the host (minutes
for thousands of long panels); here the chain is a cumulative sum of
switch offsets and every draw is one call on the device."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from ..reference.vaehmm import Dims, layout


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, pool, draws, ...) of a
    run's seed; any whole number seeds it."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(torch, device, seed: int, tag: str):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def make_weights(torch, d: Dims, seed: int, device
                 ) -> Dict[str, "torch.Tensor"]:
    """The model's parameters keyed by the reference's state_dict names:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, N(0, 1)
    embeddings, zero initial logits (torch's defaults), float32, from
    one uniform and one normal draw."""
    g = generator(torch, device, seed, "weights")
    spec = layout(d)
    n_uni = sum(math.prod(s) for _, s, init, _ in spec if init == "uniform")
    n_nor = sum(math.prod(s) for _, s, init, _ in spec if init == "normal")
    uni = torch.rand(n_uni, generator=g, device=device) * 2.0 - 1.0
    nor = torch.randn(n_nor, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init, fan_in in spec:
        n = math.prod(shape)
        if init == "uniform":
            out[name] = (uni[iu:iu + n] * fan_in ** -0.5).reshape(shape)
            iu += n
        elif init == "normal":
            out[name] = nor[inn:inn + n].reshape(shape).clone()
            inn += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def regime_panels(torch, n: int, T: int, C: int, U: int, K: int, g,
                  stickiness: float = 0.95, noise_scale: float = 1.0
                  ) -> Tuple["torch.Tensor", "torch.Tensor"]:
    """x (n, C, T) and u (n, U, T), float32, on the generator's device."""
    dev = g.device
    means = torch.randn(K, C, generator=g, device=dev)
    scales = (0.3 + 0.4 * torch.rand(K, C, generator=g, device=dev)) \
        * noise_scale
    u_means = torch.randn(K, U, generator=g, device=dev)
    z0 = torch.randint(0, K, (n, 1), generator=g, device=dev)
    moves = torch.rand(n, T, generator=g, device=dev) >= stickiness
    offs = torch.randint(1, max(K, 2), (n, T), generator=g, device=dev)
    z = (z0 + torch.cumsum(moves * offs, dim=1)) % K
    x = means[z] + scales[z] * torch.randn(n, T, C, generator=g, device=dev)
    u = u_means[z] + 0.2 * torch.randn(n, T, U, generator=g, device=dev)
    return (x.permute(0, 2, 1).contiguous(),
            u.permute(0, 2, 1).contiguous())
