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
from vqvaehmm_tpu_torch.ops.fused_infer import (fused_forward,
                                                fused_forward_reference,
                                                valid_to_rows)


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
