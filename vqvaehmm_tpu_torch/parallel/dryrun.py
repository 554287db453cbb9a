"""A dry run of the data-parallel paths over n gloo CPU processes (the
port's counterpart of __graft_entry__.py::dryrun_multichip, less the 2-D
layout of the ensemble head).

    python -m vqvaehmm_tpu_torch.parallel.dryrun [N]

`run_world(n, target, args)` starts n processes of one gloo world
(spawned; rendezvous through a FileStore in a temporary directory; every
join and collective with a timeout), runs `target(mesh, *args)` on each
rank and returns the ranks' results; a rank that raises ends the whole
world with its traceback.  The ranks compute on the CPU, or on one CUDA
device they share (`device=`: gloo takes CUDA tensors, where NCCL takes
one card a rank).  `dryrun_multichip(n)` runs `dryrun_checks` on such a
world: each data-parallel path against the same computation in one
process, on tiny shapes.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import create_mesh

# seconds a world may take, spawn and imports included
WORLD_TIMEOUT = 600.0


def _rank_main(rank, n, store_path, target, args, results, timeout,
               device):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout))
        out = target(create_mesh(n, device=device), *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which ends the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(n: int, target, args=(), timeout: float = WORLD_TIMEOUT,
              device="cpu"):
    """[target(mesh, *args) of rank r for r in range(n)], each rank a
    spawned process in one gloo world, its mesh on `device`.  target and
    args are pickled (target by import path).  Raises RuntimeError, after
    ending every process, when a rank raises, dies or the world outlasts
    timeout."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="vqhmm_world_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, os.path.join(tmp, "store"), target,
                                   args, results, timeout, device),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        outs, deadline = {}, time.monotonic() + timeout
        try:
            while len(outs) < n:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"a world of {n} outlasted {timeout} s")
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for i, p in enumerate(procs)
                            if i not in outs and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"a rank of a world of {n} died "
                                           f"(exit codes {dead})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
                outs[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10 if len(outs) == n else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [outs[r] for r in range(n)]


def _gap(a, b) -> float:
    return float((torch.as_tensor(a).double()
                  - torch.as_tensor(b).double()).abs().max())


def _params_gap(m1, m2) -> float:
    return max(_gap(p.detach(), q.detach())
               for p, q in zip(m1.parameters(), m2.parameters()))


def _numpy_params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def dryrun_case(n: int) -> dict:
    """The dry run's inputs for a world of n ranks, from fixed seeds: the
    model's widths and parameters (None: drawn from seed 0), a global
    batch of 2n rows whose longest row lies on rank 0, an HMM of 8n steps,
    and 2n ensemble members (init None: drawn from their seeds) over a
    host stream of a synthetic pool."""
    rng = np.random.default_rng(0)
    B, T, K, Tsp = 2 * n, 24, 3, 8 * n
    lengths = rng.integers(8, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return dict(
        widths=dict(input_dim=5, hidden_dim=16, K=K, hidden_dim2=8,
                    u_dim=4, trans_hidden=16),
        params=None,
        x=rng.normal(size=(B, 5, T)).astype(np.float32),
        u=rng.normal(size=(B, 4, T)).astype(np.float32),
        lengths=lengths, beta=0.7,
        hmm=(np.log(rng.dirichlet(np.ones(K))).astype(np.float32),
             np.log(rng.dirichlet(np.ones(K), size=(2, Tsp, K))
                    ).astype(np.float32),
             rng.normal(size=(2, Tsp, K)).astype(np.float32)),
        pool=dict(n_seq=4, length=48, seed=1),
        ensemble=dict(seeds=list(range(2 * n)), init=None,
                      data=dict(min_len=8, max_len=24,
                                samples_per_epoch=2 * B, seed=3),
                      kw=dict(num_epochs=2, lr=1e-3, batch_size=B,
                              gradient_clip=1.0, fused=True)))


def dryrun_checks(mesh, workdir: str, case: dict = None) -> dict:
    """The dry run's checks on this rank, on `case` (dryrun_case of the
    world's size by default).  Returns {"gaps": {check: gap}, each gap the
    largest absolute difference from the same computation in one process,
    "outputs": this rank's sharded results in numpy, for comparisons
    elsewhere}.  workdir: a directory every rank sees (the checkpoint)."""
    from ..data.checkpoint import load_checkpoint, save_checkpoint
    from ..data.dataset import RandomChunkDataset
    from ..data.device_sampler import DeviceEpochSampler
    from ..data.synthetic import synthetic_sequences
    from ..models.vae_hmm import make_model
    from ..ops import hmm as hmm_ops
    from ..train.ensemble import train_ensemble
    from ..train.trainer import TrainState, make_optimizer, train_step
    from .sharded_hmm import forward_sharded

    n = mesh.size
    case = dryrun_case(n) if case is None else case
    gaps, outputs = {}, {}

    def fresh():
        model = make_model(**case["widths"],
                           generator=torch.Generator().manual_seed(0))
        if case["params"] is not None:
            model.load_state_dict({k: torch.as_tensor(v) for k, v
                                   in case["params"].items()})
        return TrainState(model, make_optimizer(model, 1e-3,
                                                gradient_clip=1.0))

    x, u, lengths = (torch.from_numpy(case[k])
                     for k in ("x", "u", "lengths"))
    B, beta = x.shape[0], case["beta"]
    rows = mesh.rows(B)

    # the sharded step, plain and kernel C's plain version
    outputs["steps"] = {}
    for fused in (False, True):
        solo, shard = fresh(), fresh()
        want = train_step(solo.model, solo.optimizer, x, u, lengths, beta,
                          fused)
        got = train_step(shard.model, shard.optimizer, x[rows], u[rows],
                         lengths[rows], beta, fused, mesh)
        gaps[f"step_loss_fused{int(fused)}"] = _gap(got, want)
        gaps[f"step_params_fused{int(fused)}"] = _params_gap(shard.model,
                                                             solo.model)
        outputs["steps"][fused] = (float(got), _numpy_params(shard.model))

    # save on rank 0, resume on the first half of the ranks
    state = fresh()
    train_step(state.model, state.optimizer, x[rows], u[rows], lengths[rows],
               beta, False, mesh)
    ck = os.path.join(workdir, "dryrun_ck")
    if mesh.rank == 0:
        save_checkpoint(ck, state, metadata={"epoch": 1})
    mesh.barrier()
    whole = train_step(state.model, state.optimizer, x[rows], u[rows],
                       lengths[rows], 1.0, False, mesh)
    half = max(1, n // 2)
    group = dist.new_group(list(range(half)))
    if mesh.rank < half:
        hmesh = create_mesh(half, group=group, device="cpu")
        restored = load_checkpoint(ck, fresh())
        hrows = hmesh.rows(B)
        resumed = train_step(restored.model, restored.optimizer, x[hrows],
                             u[hrows], lengths[hrows], 1.0, False, hmesh)
        gaps["resume_half_loss"] = _gap(resumed, whole)
        gaps["resume_half_params"] = _params_gap(restored.model,
                                                 state.model)

    # the device sampler's epoch under the mesh
    pool = case["pool"]
    xs_pool, us_pool, _ = synthetic_sequences(pool["n_seq"], pool["length"],
                                              5, 4, 3, seed=pool["seed"])
    ds = RandomChunkDataset(xs_pool, us_pool, min_len=8, max_len=24,
                            samples_per_epoch=2 * B, seed=2)
    sampler = DeviceEpochSampler(ds, "cpu")
    triples = sampler.upload(*sampler.sample_indices_fast(B, 2))
    solo, shard = fresh(), fresh()
    want = sampler.make_epoch_step(solo.model, solo.optimizer, True)(
        *triples, beta)
    got = sampler.make_epoch_step(shard.model, shard.optimizer, True,
                                  mesh)(*triples, beta)
    gaps["sampler_epoch_loss"] = _gap(got, want)
    gaps["sampler_epoch_params"] = _params_gap(shard.model, solo.model)

    # the HMM forward with T over the ranks
    log_pi, log_A, log_obs = (torch.from_numpy(a) for a in case["hmm"])
    sp = forward_sharded(log_pi, log_A, log_obs, mesh)
    ref = hmm_ops.forward(log_pi, log_A, log_obs)
    gaps["forward_sharded_alpha"] = _gap(
        sp.log_alpha, ref.log_alpha[:, mesh.rows(log_obs.shape[1])])
    gaps["forward_sharded_ll"] = _gap(sp.log_likelihood, ref.log_likelihood)
    outputs["hmm"] = (sp.log_alpha.numpy(), sp.log_likelihood.numpy())

    # bulk inference over the ranks
    model = fresh().model
    with torch.no_grad():
        got = model.infer_forward(x, valid_to=lengths, mesh=mesh)
        want = model.infer_forward(x, valid_to=lengths)
    gaps["infer_sharded"] = max(_gap(g, w) for g, w in zip(got, want))
    outputs["infer"] = [a.numpy() for a in got]

    # the members over the ranks, then all of them in one process
    ens = case["ensemble"]
    kw = dict(seeds=ens["seeds"], init_states=ens["init"], device="cpu",
              device_data=False, log_fn=None, **ens["kw"])
    states, hist, best = train_ensemble(
        fresh().model, RandomChunkDataset(xs_pool, us_pool, **ens["data"]),
        mesh=mesh, **kw)
    solo_states, solo_hist, _ = train_ensemble(
        fresh().model, RandomChunkDataset(xs_pool, us_pool, **ens["data"]),
        **kw)
    gaps["ensemble_losses"] = _gap(hist, solo_hist)
    gaps["ensemble_params"] = max(_params_gap(a.model, b.model)
                                  for a, b in zip(states, solo_states))
    outputs["ensemble"] = (hist, best, [_numpy_params(s.model)
                                        for s in states])
    return {"gaps": gaps, "outputs": outputs}


# each check's bar: the steps and the resume at float32's 1e-5, the
# recursions and the ensemble's epochs of several steps at 1e-4
DRYRUN_BARS = {"forward_sharded_alpha": 1e-4, "forward_sharded_ll": 1e-4,
               "ensemble_losses": 1e-4, "ensemble_params": 1e-4}


def dryrun_failures(ranks) -> list:
    """Every check over its bar (1e-5, or DRYRUN_BARS) among the ranks'
    dryrun_checks results, as 'rank r check: gap'."""
    return [f"rank {r} {k}: {v:.3e}" for r, res in enumerate(ranks)
            for k, v in res["gaps"].items()
            if not v <= DRYRUN_BARS.get(k, 1e-5)]


def dryrun_multichip(n_devices: int) -> dict:
    """Run dryrun_checks on a world of n_devices gloo CPU processes and
    raise AssertionError naming every check over its bar; returns rank
    0's gaps."""
    with tempfile.TemporaryDirectory(prefix="vqhmm_dryrun_") as workdir:
        ranks = run_world(n_devices, dryrun_checks, (workdir,))
    bad = dryrun_failures(ranks)
    if bad:
        raise AssertionError("dryrun_multichip: " + "; ".join(bad))
    return ranks[0]["gaps"]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
