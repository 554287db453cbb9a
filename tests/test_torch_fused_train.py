"""The port's fused loss-and-gradients (vqvaehmm_tpu_torch/ops/fused_train.py)
against the JAX package: on the CPU the port computes its plain version
(compute_loss plus autograd), held against JAX's Pallas train kernel in
interpret mode and against jax.value_and_grad(compute_loss), with the
bars of tests/test_pallas_train.py (loss rtol 5e-5; each gradient rtol
1e-4 plus 5e-5 of its largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import inputs, model_pair, t
from vqvaehmm_tpu.ops.pallas_train import fused_loss_and_grads as jax_fused
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.core.config import ModelConfig
from vqvaehmm_tpu_torch.ops import fused_train as ft
from vqvaehmm_tpu_torch.ops.fused_infer import H100_SMS, SMEM_LIMIT
from vqvaehmm_tpu_torch.ops.fused_train import (FusedELBO, PARAM_NAMES,
                                                fused_loss_and_grads,
                                                fused_loss_and_grads_reference,
                                                fused_loss_and_grads_tiled,
                                                train_plan,
                                                train_step_supported)

PUBLISHED = dict(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32, u_dim=4,
                 trans_hidden=128)
PROBE = dict(input_dim=16, hidden_dim=256, K=8, hidden_dim2=128, u_dim=4,
             trans_hidden=256)


def _as_state_dict(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close_grads(got, want):
    assert set(got) == set(want) == set(PARAM_NAMES)
    for name, w in want.items():
        a, b = w.numpy(), got[name].detach().numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            b, a, rtol=1e-4, atol=5e-5 * max(np.max(np.abs(a)), 1e-12),
            err_msg=name)


@pytest.mark.parametrize("beta,short,layout", [
    (1.0, None, "BUT"), (0.7, None, "BUT"), (1.0, 29, "BTU")])
def test_fused_loss_and_grads_match_jax(beta, short, layout):
    jm, params, tm = model_pair(seed=3)
    x, u, lengths = inputs(8, 48, seed=int(beta * 10) + (short or 0))
    if short is not None:
        lengths = np.minimum(lengths, short)       # valid_to inside T
    if layout == "BTU":
        u = np.ascontiguousarray(u.transpose(0, 2, 1))
    loss, grads = fused_loss_and_grads(tm, t(x), t(u), t(lengths), beta)
    args = (params, jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths),
            beta)
    ref_loss, ref_grads = jax.value_and_grad(jm.compute_loss)(*args)
    k_loss, k_grads = jax_fused(jm, *args, interpret=True)
    for want_loss, want in ((ref_loss, ref_grads), (k_loss, k_grads)):
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=5e-5)
        _close_grads(grads, _as_state_dict(want))


@pytest.mark.parametrize("shard", [False, True])
def test_fused_elbo_backward_fills_grad(shard):
    # shard: the first half of a batch whose longest sequence lies in the
    # other half, under the whole batch's normalisation
    _, _, tm = model_pair(seed=5)
    x, u, lengths = (t(a) for a in inputs(8 if shard else 4, 24, seed=6))
    norm = None
    if shard:
        lengths[4:] = 24
        lengths[:4] = torch.minimum(lengths[:4], torch.tensor(13))
        norm = ft.global_norm(lengths, 24)
        x, u, lengths = x[:4], u[:4], lengths[:4]
    params = [p for _, p in tm.named_parameters()]
    loss = FusedELBO.apply(tm, x, u, lengths, 0.6, norm, *params)
    (loss * 2.0).backward()
    got = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad()
    want_loss = tm.compute_loss(x, u, lengths, 0.6, norm=norm)
    (want_loss * 2.0).backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-6)
    _close_grads(got, {n: p.grad for n, p in tm.named_parameters()})
    f_loss, f_grads = fused_loss_and_grads(tm, x, u, lengths, 0.6, norm=norm)
    assert float(loss.detach()) == float(f_loss)
    for n, g in f_grads.items():
        assert torch.equal(got[n], 2.0 * g), n


def test_fused_loss_and_grads_dispatch():
    _, _, tm = model_pair(seed=7)
    x, u, lengths = (t(a) for a in inputs(2, 16, seed=8))
    before = fused_loss_and_grads.launches
    fused_loss_and_grads(tm, x, u, lengths, 1.0)      # CPU: plain version
    assert fused_loss_and_grads.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss_and_grads(tm, x, u, lengths, 1.0, use_kernel=True)
    cfg = tm.cfg
    assert train_step_supported(cfg, 64, 200)
    assert not train_step_supported(
        type(cfg)(**{**cfg.__dict__, "K": 17}), 64, 200)
    assert train_step_supported(
        type(cfg)(**{**cfg.__dict__, "compute_dtype": "bfloat16"}), 64, 200)
    assert not train_step_supported(cfg, 64, 2 ** 30)


# (B, T, tile, every length <= short, u layout, beta, splits, also JAX)
TILED_CASES = [
    (3, 40, 16, None, "BUT", 1.0, 3, True),      # T not a multiple of tile
    (3, 56, 16, 29, "BTU", 0.1, 1, True),        # valid_to < T
    (3, 45, 8, 29, "BTU", 0.1, 1, False),
    (2, 37, 37, None, "BUT", 1.0, 4, False),     # one tile
    (4, 70, 16, 20, "BUT", 0.1, 5, False),       # whole tiles past valid_to
    (2, 33, 8, None, "BTU", 1.0, 2, False),      # a last tile of one step
    (5, 24, 16, 17, "BUT", 1.0, None, False),    # the plan's own splits
]


@pytest.mark.parametrize("B,T,tile,short,layout,beta,splits,with_jax",
                         TILED_CASES)
def test_tiled_version_matches_autograd_and_jax(B, T, tile, short, layout,
                                                beta, splits, with_jax):
    """The plain version that computes the step the way the CUDA kernels
    do (time tiles with halos, closed-form backward, partial sums a
    split) against autograd and the JAX kernel: loss 1e-5 relative, each
    gradient 1e-4 of its largest entry (float32, other summation orders)."""
    jm, params, tm = model_pair(seed=11)
    x, u, lengths = inputs(B, T, seed=T + tile)
    if short is not None:
        lengths = np.minimum(lengths, short)
    un = np.ascontiguousarray(u.transpose(0, 2, 1)) if layout == "BTU" else u
    loss, grads = fused_loss_and_grads_tiled(tm, t(x), t(un), t(lengths),
                                             beta, tile, splits=splits)
    wants = [fused_loss_and_grads_reference(tm, t(x), t(un), t(lengths),
                                            beta)]
    if with_jax:
        k_loss, k_grads = jax_fused(jm, params, jnp.asarray(x),
                                    jnp.asarray(un), jnp.asarray(lengths),
                                    beta, interpret=True)
        wants.append((torch.tensor(float(k_loss)), _as_state_dict(k_grads)))
    for want_loss, want in wants:
        assert abs(float(loss) - float(want_loss)) \
            <= 1e-5 * abs(float(want_loss))
        assert set(grads) == set(want) == set(PARAM_NAMES)
        for name, w in want.items():
            assert grads[name].shape == w.shape, name
            err = float((grads[name] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (name, err)


def test_tiled_version_does_not_depend_on_the_tile():
    _, _, tm = model_pair(seed=12)
    x, u, lengths = (t(a) for a in inputs(3, 50, seed=13))
    a = fused_loss_and_grads_tiled(tm, x, u, lengths, 0.5, 8, splits=2)
    b = fused_loss_and_grads_tiled(tm, x, u, lengths, 0.5, 50, splits=2)
    assert float(a[0]) == pytest.approx(float(b[0]), rel=1e-6)
    for name in PARAM_NAMES:
        np.testing.assert_allclose(
            a[1][name].numpy(), b[1][name].numpy(), rtol=0,
            atol=1e-5 * float(b[1][name].abs().max()), err_msg=name)


@pytest.mark.parametrize("widths,B,T,tile", [
    (PUBLISHED, 64, 200, 64), (PUBLISHED, 8, 200, 16),
    (PUBLISHED, 256, 512, 64), (PUBLISHED, 1, 1, 16),
    (PROBE, 256, 512, 32), (PROBE, 2, 37, 16)])
def test_train_plan(widths, B, T, tile):
    cfg = ModelConfig(**widths)
    plan = train_plan(cfg, B, T)
    assert plan.tile == tile and plan.tiles == -(-T // tile)
    assert plan.blocks == B * plan.tiles

    def block_smem(t):
        return max(ft.smem_fwd_bytes(cfg, t), ft.smem_bwd_bytes(cfg, t)) \
            + ft._STATIC_SMEM

    def cost(t):          # waves of resident blocks x steps a block
        resident = H100_SMS * (228 * 1024 // (block_smem(t) + 1024))
        return -(-B * -(-T // t) // resident) * (t + 8 + 32)

    assert block_smem(tile) <= SMEM_LIMIT
    for other in ft.TILES:
        assert block_smem(other) > SMEM_LIMIT \
            or (cost(tile), -tile) <= (cost(other), -other)
    # every (sequence, slab) unit lies in exactly one split, none is empty
    units = B * -(-T // ft.WG_SLAB)
    assert (plan.splits - 1) * plan.units_per_split < units \
        <= plan.splits * plan.units_per_split
    assert plan.splits * plan.wg_tiles <= max(8 * H100_SMS, plan.wg_tiles)
    P = sum(p.numel() for p in VAEHMM_params(cfg))
    assert ft.param_count(cfg) == P and plan.partials == plan.splits * P
    assert plan.loss_partials == 3 * plan.blocks
    assert plan.scratch_rows == ft.scratch_rows(cfg)
    assert plan.packed == ft.packed_floats(cfg) and plan.packed % 4 == 0


def VAEHMM_params(cfg):
    from vqvaehmm_tpu_torch.models.vae_hmm import VAEHMM

    model = VAEHMM(cfg)
    assert tuple(n for n, _ in model.named_parameters()) == PARAM_NAMES
    return list(model.parameters())


def test_train_plan_scales_with_the_card_and_the_gate():
    cfg = ModelConfig(**PUBLISHED)
    # 256 blocks of 64 steps are one wave of an H100's 264 resident blocks;
    # a card of 100 SMs takes three waves of the narrowest tile instead
    plan = train_plan(cfg, 64, 200, sms=132)
    assert (plan.tile, plan.blocks) == (64, 256)
    assert train_plan(cfg, 64, 200, sms=100).tile == 16
    assert train_step_supported(cfg, 64, 200)
    assert train_step_supported(ModelConfig(**PROBE), 256, 512)
    assert not train_step_supported(ModelConfig(**{**PUBLISHED, "K": 17}),
                                    64, 200)
    # a layer too wide for a weight buffer, and widths whose narrowest tile
    # does not fit a block's shared memory
    assert not train_step_supported(
        ModelConfig(**{**PUBLISHED, "hidden_dim": 2052}), 8, 64)
    big = ModelConfig(**{**PUBLISHED, "hidden_dim": 1024})
    assert train_plan(big, 8, 64) is None
    assert not train_step_supported(big, 8, 64)
    # (mu, logvar) wider than every hidden layer sizes the buffers
    wide = ModelConfig(**{**PUBLISHED, "input_dim": 40})
    assert train_step_supported(wide, 8, 64)
    assert ft.smem_fwd_bytes(wide, 16) > ft.smem_fwd_bytes(cfg, 16)


def test_scratch_and_jobs_follow_the_cuda_source():
    """The wrapper's scratch rows, weight-gradient jobs and packed layers
    are counted in the same order as csrc/fused_train.cu lays them out
    (the kernel call also checks the sizes against the built library)."""
    import re
    from vqvaehmm_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_train.cu").read_text()
    cfg = ModelConfig(**PUBLISHED)
    rows = re.findall(r"  r\.(\w+) = p; p \+= ", src)
    assert rows == list(ft.scratch_layout(cfg))
    assert ft.scratch_rows(cfg) == 878
    jobs = re.findall(r"\{R\.(\w+), R\.(\w+), [^{}]*?, (\d), 0, 0, off\.",
                      src)
    assert [(dy, inp, int(taps)) for dy, inp, taps in jobs] == [
        (dy, inp, taps) for _, dy, inp, _, _, taps, _
        in ft.weight_grad_jobs(cfg)]
    assert len(re.findall(r"  p\.\w+ = at; at \+= packed_floats\(", src)) == 16
    assert ft.packed_floats(cfg) == 67680
    for const, value in (("WG_TILE", ft.WG_TILE), ("WG_SLAB", ft.WG_SLAB),
                         ("HALO_F", ft.HALO_FWD), ("HALO_B", ft.HALO_BWD),
                         ("KMAX", ft.KMAX), ("MAX_THREADS", 512)):
        assert re.search(rf"constexpr int {const} = {value};", src), const
    assert "atomicAdd" not in src
