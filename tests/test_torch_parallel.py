"""The port's data parallelism (vqvaehmm_tpu_torch/parallel/, the mesh=
paths of train/, data/device_sampler.py and models/vae_hmm.py) against
the JAX package's mesh paths on its 8 virtual CPU devices.

The port's ranks are gloo CPU processes: each world is spawned once, in
a module-scoped fixture, by parallel/dryrun.py::run_world (a FileStore
rendezvous under a temporary directory, no TCP port, every join with a
timeout).  It runs the dry run's own checks (parallel/dryrun.py::
dryrun_checks on dryrun_case's inputs, with JAX's initial parameters and
members) and the jobs of tests/torch_parallel_worker.py; the tests read
its results.  Bars: one step 1e-5 (loss and parameters), epochs and the
ensemble 1e-4, the sharded forward 5e-5 (tests/test_sharded_hmm.py's),
sharded inference 1e-5, the 2-D ensemble head 1e-6.  Kernel C's
global-normalisation mode is held on the CPU through its two plain
versions, against JAX's axis_name mode and against the whole batch."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_worker as worker
from vqvaehmm_tpu import TrainState as JaxTrainState
from vqvaehmm_tpu import make_model as jax_make_model
from vqvaehmm_tpu.data import dataset as jax_dataset
from vqvaehmm_tpu.ops.pallas_train import (
    fused_loss_and_grads as jax_fused_loss_and_grads)
from vqvaehmm_tpu.parallel import create_mesh as jax_mesh
from vqvaehmm_tpu.parallel.sharded_hmm import (
    forward_sharded as jax_forward_sharded)
from vqvaehmm_tpu.train import ensemble as jax_ensemble
from vqvaehmm_tpu.train.trainer import make_epoch_step as jax_epoch_step
from vqvaehmm_tpu.train.trainer import make_optimizer as jax_optimizer
from vqvaehmm_tpu.train.trainer import make_train_step as jax_train_step
from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.ops.fused_train import (
    PARAM_NAMES, fused_loss_and_grads, fused_loss_and_grads_reference,
    fused_loss_and_grads_tiled, global_norm)
from vqvaehmm_tpu_torch.parallel import Mesh, forward_sharded, shard_batch
from vqvaehmm_tpu_torch.parallel.dryrun import (dryrun_case,
                                                dryrun_failures, run_world)
from vqvaehmm_tpu_torch.train.ensemble import train_ensemble
from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

WIDTHS = dict(input_dim=5, hidden_dim=16, K=3, hidden_dim2=8, u_dim=4,
              trans_hidden=16)
B, T, BETA = 8, 24, 0.7
PIPE = {
    "model": WIDTHS,
    "data": {"x_sequences_path": "absent_x.npy",
             "u_sequences_path": "absent_u.npy",
             "min_len": 8, "max_len": 24, "samples_per_epoch": 16},
    "training": {"epochs": 4, "lr": 1e-3, "batch_size": 4,
                 "gradient_clip": 1.0, "save_freq": 2, "seed": 1,
                 "fused": True, "input_pipeline": "device"},
}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_params(seed=0):
    jm = jax_make_model(**WIDTHS)
    return jm, jm.init(jax.random.PRNGKey(seed))


def _batch(seed=0):
    """A global batch whose second half is shorter than its first: the
    halves' own valid_to differ from the global one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 5, T)).astype(np.float32)
    u = rng.normal(size=(B, 4, T)).astype(np.float32)
    lengths = np.array([24, 17, 9, 20, 12, 8, 11, 10], np.int32)
    return x, u, lengths


def _epochs(seed=1, n=2, batches=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xs = rng.normal(size=(batches, B, 5, T)).astype(np.float32)
        us = rng.normal(size=(batches, B, 4, T)).astype(np.float32)
        ls = rng.integers(6, T + 1, size=(batches, B)).astype(np.int32)
        ls[:, 0] = T
        out.append((xs, us, ls))
    return out


def _hmm(n_steps, seed=0, K=3):
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=(2, n_steps, K))
                   ).astype(np.float32)
    log_obs = rng.normal(size=(2, n_steps, K)).astype(np.float32)
    return log_pi, log_A, log_obs


def _ensemble_init(seeds):
    jm = jax_make_model(**WIDTHS)
    tx = jax_ensemble.make_optimizer(1e-3, 1.0)
    init = jax_ensemble.init_ensemble_state(jm, tx, seeds)
    return jm, tx, init, [
        params_from_numpy(_np_tree(jax_ensemble.ensemble_member(init,
                                                                i).params))
        for i in range(len(seeds))]


def _jax_ensemble_head(case):
    """JAX's EnsemblePortfolioOptimizer of the dry run's 2-D check and its
    init at PRNGKey(1), as in __graft_entry__.py::dryrun_multichip."""
    from vqvaehmm_tpu.models import EnsemblePortfolioOptimizer, HeadConfig

    ens = EnsemblePortfolioOptimizer(HeadConfig(**case["head"]),
                                     n_models=case["n_models"])
    return ens, ens.init(jax.random.PRNGKey(1))


def _case(n):
    """dryrun_case(n) with JAX's initial parameters, members and
    ensemble head."""
    from vqvaehmm_tpu_torch.data.checkpoint import zoo_params_from_numpy

    case = dryrun_case(n)
    assert case["widths"] == WIDTHS
    _, params = _jax_params()
    case["params"] = params_from_numpy(_np_tree(params))
    case["ensemble"]["init"] = _ensemble_init(case["ensemble"]["seeds"])[3]
    _, head = _jax_ensemble_head(case["ensemble_2d"])
    case["ensemble_2d"]["params"] = zoo_params_from_numpy(_np_tree(head))
    return case


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One world of two ranks, every job of the 2-rank tests."""
    tmp = tmp_path_factory.mktemp("world2")
    jobs = [("dryrun", "dryrun_checks", (str(tmp), _case(2))),
            ("refusal", "refusals", ()),
            ("trainers", "trainers", (WIDTHS,)),
            ("whole", "pipeline", (PIPE, str(tmp / "whole"), 0)),
            ("stopped", "pipeline", (PIPE, str(tmp / "stopped"), 2)),
            ("resumed", "resume", (PIPE, str(tmp / "stopped"), 1))]
    return run_world(2, worker.world, (jobs,))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    _, params = _jax_params()
    jobs = [("dryrun", "dryrun_checks", (str(tmp), _case(4))),
            ("epochs", "epochs", (WIDTHS, _np_tree(params), _epochs(),
                                  [0.5, 1.0]))]
    return run_world(4, worker.world, (jobs,))


def _out(ranks, name):
    """Each rank's sharded result `name` from its dry run."""
    return [r["dryrun"]["outputs"][name] for r in ranks]


def _gap_params(got, want_tree):
    want = params_from_numpy(want_tree)
    return max(float(np.abs(got[n] - want[n].numpy()).max())
               for n in PARAM_NAMES)


@pytest.mark.parametrize("jax_fused,port_fused",
                         [(False, False), (True, True), (False, True),
                          (True, False)])
def test_sharded_step_matches_jax(world2, jax_fused, port_fused):
    """JAX's make_train_step(mesh=create_mesh(2)) (its XLA path, or kernel
    5 in interpret mode with axis_name) against the port's two-rank step
    (compute_loss and autograd, or kernel C's plain version with the
    global normalisation): loss and parameters within 1e-5, every rank
    holding the same parameters."""
    jm, params = _jax_params()
    tx = jax_optimizer(1e-3, gradient_clip=1.0)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_train_step(jm, tx, mesh=jax_mesh(2), donate=False,
                          fused=jax_fused)
    case = dryrun_case(2)
    new, loss = step(state, *(jnp.asarray(case[k])
                              for k in ("x", "u", "lengths")),
                     jnp.float32(case["beta"]))
    (l0, p0), (l1, p1) = (o[port_fused] for o in _out(world2, "steps"))
    assert l0 == l1 and all(np.array_equal(p0[n], p1[n]) for n in p0)
    assert abs(l0 - float(loss)) <= 1e-5 * max(1.0, abs(float(loss)))
    assert _gap_params(p0, _np_tree(new.params)) <= 1e-5


def test_mesh_epochs_match_jax(world4):
    """JAX's make_epoch_step(mesh=create_mesh(4)) against the port's
    make_epoch_step(mesh=) on four ranks: two epochs of two batches,
    epoch losses within 1e-4."""
    jm, params = _jax_params()
    tx = jax_optimizer(1e-3, gradient_clip=1.0)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_epoch_step(jm, tx, mesh=jax_mesh(4), donate=False)
    want = []
    for (xs, us, ls), beta in zip(_epochs(), [0.5, 1.0]):
        state, loss = step(state, jnp.asarray(xs), jnp.asarray(us),
                           jnp.asarray(ls), jnp.float32(beta))
        want.append(float(loss))
    for r in world4:
        losses, got = r["epochs"]
        np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-4)
        assert _gap_params(got, _np_tree(state.params)) <= 1e-4


@pytest.mark.parametrize("n", [2, 4])
def test_forward_sharded_matches_jax(world2, world4, n):
    """forward_sharded over n ranks against JAX's over an n-device mesh:
    the ranks' log_alpha shards joined, and the log-likelihood every rank
    returns, within 5e-5."""
    want = jax_forward_sharded(*map(jnp.asarray, dryrun_case(n)["hmm"]),
                               jax_mesh(n))
    got = _out(world2 if n == 2 else world4, "hmm")
    alpha = np.concatenate([a for a, _ in got], axis=1)
    np.testing.assert_allclose(alpha, np.asarray(want.log_alpha),
                               atol=5e-5, rtol=0)
    for _, ll in got:
        np.testing.assert_allclose(ll,
                                   np.asarray(want.log_likelihood),
                                   atol=5e-5, rtol=0)


def test_sharded_infer_matches_jax(world2):
    """infer_forward(mesh=) on two ranks against JAX's infer_forward(mesh=
    create_mesh(2)), a per-sequence valid_to split with the rows: every
    rank returns the whole (mu, logvar, q) within 1e-5."""
    jm, params = _jax_params()
    case = dryrun_case(2)
    want = jm.infer_forward(params, jnp.asarray(case["x"]),
                            valid_to=jnp.asarray(case["lengths"]),
                            mesh=jax_mesh(2))
    for out in _out(world2, "infer"):
        for got, w in zip(out, want):
            np.testing.assert_allclose(got, np.asarray(w), atol=1e-5,
                                       rtol=0)


def test_member_parallel_ensemble_matches_jax(world2, monkeypatch):
    """The members over two ranks (train_ensemble(mesh=)) against JAX's
    make_ensemble_epoch_step(mesh=create_mesh(2)) from the same initial
    members over the same numpy epoch stream: loss histories within
    1e-4, every rank returning all four members, the same best."""
    monkeypatch.setattr(jax_dataset, "_fastdata", None)
    from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
    from vqvaehmm_tpu_torch.train.trainer import beta_schedule

    case = dryrun_case(2)
    ens, pool = case["ensemble"], case["pool"]
    jm, tx, states, _ = _ensemble_init(ens["seeds"])
    step = jax_ensemble.make_ensemble_epoch_step(jm, tx, donate=False,
                                                 mesh=jax_mesh(2))
    xs, us, _ = synthetic_sequences(pool["n_seq"], pool["length"], 5, 4, 3,
                                    seed=pool["seed"])
    ds = jax_dataset.RandomChunkDataset(xs, us, **ens["data"])
    epochs = ens["kw"]["num_epochs"]
    hist = []
    for ep in range(epochs):
        arrays = jax_dataset.epoch_arrays(ds, ens["kw"]["batch_size"],
                                          use_native=False)
        states, losses = step(states, *map(jnp.asarray, arrays),
                              jnp.float32(beta_schedule(ep, epochs)))
        hist.append(np.asarray(losses))
    want = np.stack(hist, axis=1)
    for got, best, members in _out(world2, "ensemble"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert best == int(want[:, -1].argmin()) and len(members) == 4
        for i, m in enumerate(members):
            assert _gap_params(m, _np_tree(jax_ensemble.ensemble_member(
                states, i).params)) <= 1e-4


def test_pipeline_sigterm_and_resume_on_half_the_ranks(world2, tmp_path):
    """TrainPipeline(use_mesh=True) on two ranks: the ranks' histories and
    parameters equal, within 1e-5 of the same pipeline in one process;
    SIGTERM to rank 0 after epoch 2 stops both ranks at that boundary
    with one periodic checkpoint (rank 0's); the run resumed on one rank
    ends within 1e-5 of the uninterrupted run."""
    (h0, pre0, p0, files), (h1, pre1, p1, _) = (r["whole"] for r in world2)
    assert not pre0 and not pre1 and h0 == h1 and len(h0) == 4
    assert all(np.array_equal(p0[n], p1[n]) for n in p0)
    assert "vae_hmm_trained.npz" in files
    from vqvaehmm_tpu_torch.core.config import (apply_overrides,
                                                config_from_dict)

    solo = TrainPipeline(apply_overrides(
        config_from_dict(PIPE), [f"training.checkpoint_dir={tmp_path}"]),
        device="cpu")
    state = solo.train(log_fn=None)
    np.testing.assert_allclose(h0, solo.history, rtol=1e-5)
    assert max(float(np.abs(p0[n] - p.detach().numpy()).max())
               for n, p in state.model.named_parameters()) <= 1e-5

    (hs, pres, _, sfiles), (hs1, pres1, _, _) = (r["stopped"]
                                                for r in world2)
    assert pres and pres1 and len(hs) == len(hs1) == 2
    assert sfiles == ["vae_hmm_periodic.meta.json", "vae_hmm_periodic.pt"]
    resumed, params, size = world2[0]["resumed"]
    assert world2[1]["resumed"] is None and size == 1
    np.testing.assert_allclose(resumed, h0[2:], rtol=1e-5)
    assert max(float(np.abs(params[n] - p0[n]).max()) for n in p0) <= 1e-5


def test_train_model_and_trainer_over_two_ranks(world2):
    """train_model(mesh=) and Trainer(mesh=) on two ranks against the same
    calls in one process (the same seeds, the same host epoch stream):
    epoch losses within 1e-5 relative, the Trainer's parameters within
    1e-5, equal across the ranks."""
    from vqvaehmm_tpu_torch.train.trainer import Trainer, train_model

    _, want = train_model(VAEHMM(ModelConfig(**WIDTHS)), worker.dataset(),
                          num_epochs=2, batch_size=8, seed=5,
                          gradient_clip=1.0, device="cpu", log_fn=None)
    trainer = Trainer(VAEHMM(ModelConfig(**WIDTHS)), seed=6)
    twant = trainer.train(worker.dataset(1), 2, 8, log_fn=None)
    (h0, t0, p0), (h1, t1, p1) = (r["trainers"] for r in world2)
    assert h0 == h1 and t0 == t1
    np.testing.assert_allclose(h0, want, rtol=1e-5)
    np.testing.assert_allclose(t0, twant, rtol=1e-5)
    for n, p in trainer.model.named_parameters():
        assert np.array_equal(p0[n], p1[n])
        np.testing.assert_allclose(p0[n], p.detach().numpy(), atol=1e-5,
                                   rtol=0)


def test_refusals(world2):
    """A world of another size than the mesh asked for, and rows, steps or
    members that do not divide over the ranks, raise."""
    assert all("4-device mesh" in r["refusal"] for r in world2)
    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(mesh, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="must divide"):
        forward_sharded(*(torch.from_numpy(a) for a in _hmm(5)), mesh)
    with pytest.raises(ValueError, match="do not divide"):
        VAEHMM(ModelConfig(**WIDTHS)).infer_forward(torch.zeros(3, 5, 8),
                                                    mesh=mesh)
    with pytest.raises(ValueError, match="members do not divide"):
        train_ensemble(VAEHMM(ModelConfig(**WIDTHS)), None, [0, 1, 2],
                       device="cpu", mesh=mesh)
    assert shard_batch(Mesh(None, 1, 2, torch.device("cpu")),
                       torch.arange(8).reshape(2, 4), dim=1).tolist() == \
        [[2, 3], [6, 7]]


def _halves(model, fn, norm_of):
    """Kernel C's two half-batch calls (by fn) summed: (loss, grads)."""
    x, u, lengths = (torch.from_numpy(a) for a in _batch())
    total, grads = 0.0, None
    for rows in (slice(0, B // 2), slice(B // 2, B)):
        loss, g = fn(model, x[rows], u[rows], lengths[rows], BETA,
                     norm=norm_of(lengths[rows]))
        total = total + loss
        grads = g if grads is None else {n: grads[n] + g[n] for n in g}
    return total, grads


PLAIN = {"reference": fused_loss_and_grads_reference,
         "tiled": lambda *a, **k: fused_loss_and_grads_tiled(
             *a, 16, splits=2, **k),
         "wrapper": fused_loss_and_grads}


@pytest.mark.parametrize("plain", sorted(PLAIN))
def test_global_norm_halves_sum_to_the_whole_batch(plain):
    """Kernel C's plain versions in the global-normalisation mode: two
    half-batch calls summed give the whole batch's loss within 1e-5
    relative and each gradient within 1e-5 of its largest magnitude.  A
    half whose own longest row is shorter than the batch's: a run that
    takes each half's own valid_to (the mask total and B still global)
    parts visibly, by more than 1e-3 of some gradient's largest
    magnitude; without the global norm at all the loss itself parts."""
    model = VAEHMM(ModelConfig(**WIDTHS),
                   generator=torch.Generator().manual_seed(0))
    x, u, lengths = (torch.from_numpy(a) for a in _batch())
    want_loss, want = fused_loss_and_grads_reference(model, x, u, lengths,
                                                     BETA)
    norm = global_norm(lengths, T)
    assert norm == (24, 111, 8)
    fn = PLAIN[plain]

    def share(got):
        return max(float((got[n] - want[n]).abs().max()
                         / want[n].abs().max()) for n in want)

    loss, grads = _halves(model, fn, lambda ln: norm)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert share(grads) <= 1e-5
    _, local_vt = _halves(model, fn, lambda ln: (int(ln.max()), *norm[1:]))
    assert share(local_vt) > 1e-3
    local, _ = _halves(model, fn, lambda ln: None)
    assert abs(float(local) - float(want_loss)) > 1e-2


def test_global_norm_matches_jax_axis_name_mode():
    """Kernel 5 in interpret mode with axis_name under shard_map on two
    devices (the psum'd loss and gradients) against the port's kernel-C
    plain version called on each half with the global norm and summed:
    within 1e-5."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jm, params = _jax_params()
    model = VAEHMM(ModelConfig(**WIDTHS))
    model.load_state_dict(params_from_numpy(_np_tree(params)))
    x, u, lengths = _batch()

    def per_shard(p, xx, uu, ll):
        return jax_fused_loss_and_grads(jm, p, xx, uu, ll, BETA,
                                        interpret=True, axis_name="data")

    jloss, jgrads = shard_map(
        per_shard, mesh=jax_mesh(2),
        in_specs=(P(), P("data"), P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False)(
        params, jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths))
    norm = global_norm(lengths, T)
    loss, grads = _halves(model, fused_loss_and_grads_reference,
                          lambda ln: norm)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_numpy(_np_tree(jgrads))
    for n in PARAM_NAMES:
        np.testing.assert_allclose(grads[n].numpy(), want[n].numpy(),
                                   atol=1e-5 * float(want[n].abs().max()),
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("n", [2, 4])
def test_ensemble_2d_layout_matches_jax(world2, world4, n):
    """The ensemble head on the (n/2) x 2 grid (members over "model",
    rows over "data") against JAX's, its parameters sharded P("model") and
    the batch P("data") over an (n/2, 2) device mesh, as the JAX dry run
    lays it out: each rank's rows within 1e-6 of JAX's, the ranks of one
    grid row equal, the weights summing to 1 within 1e-4."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    case = dryrun_case(n)["ensemble_2d"]
    ens, params = _jax_ensemble_head(case)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n // 2, 2),
                ("data", "model"))
    params = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("model"))),
        params)
    q = jax.device_put(jnp.asarray(case["q"]),
                       NamedSharding(mesh, P("data")))
    want = np.asarray(jax.jit(lambda p, qq: ens(p, qq), out_shardings=
                              NamedSharding(mesh, P("data")))(params, q))
    got = _out(world2 if n == 2 else world4, "ensemble_2d")
    per = want.shape[0] // (n // 2)
    for r, rows in enumerate(got):
        i = r // 2                       # the rank's row of the grid
        np.testing.assert_allclose(rows, want[i * per:(i + 1) * per],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(rows.sum(-1), 1.0, atol=1e-4, rtol=0)
        assert np.array_equal(rows, got[2 * i + (1 - r % 2)])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(world2, world4, n):
    """parallel/dryrun.py's checks on the n-rank world (what
    dryrun_multichip(n) runs): every check (the sharded step in both
    modes, resume on n/2 ranks, the device sampler, the sharded forward,
    sharded inference, the member-parallel ensemble) within its bar of
    the one-process computation, on every rank."""
    ranks = [r["dryrun"] for r in (world2 if n == 2 else world4)]
    assert dryrun_failures(ranks) == []
    assert set(ranks[0]["gaps"]) >= {
        "step_params_fused1", "resume_half_params", "sampler_epoch_params",
        "forward_sharded_alpha", "infer_sharded", "ensemble_params",
        "ensemble_2d", "ensemble_2d_sum"}
    assert all("resume_half_params" in r["gaps"] for r in ranks[:n // 2])
    json.dumps(ranks[0]["gaps"])
