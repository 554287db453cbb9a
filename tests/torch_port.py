"""Shared set-up for the parity tests of the PyTorch port
(tests/test_torch_*.py): one set of numpy parameters, made by the JAX
package's init, loaded into both packages."""

import jax
import numpy as np
import torch

from vqvaehmm_tpu import make_model
from vqvaehmm_tpu_torch import VAEHMM, ModelConfig
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy

# the suite runs under xdist with several workers: one thread each
torch.set_num_threads(1)

SMALL = dict(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4, u_dim=4,
             trans_hidden=8)


def model_pair(seed: int = 0, **overrides):
    """(jax_model, jax_params, torch_model) sharing one parameter set."""
    cfg = {**SMALL, **overrides}
    jm = make_model(**cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = VAEHMM(ModelConfig(**cfg))
    tm.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm.eval()


def inputs(B: int, T: int, seed: int = 0, C: int = 5, U: int = 4):
    """(x, u, lengths) as numpy: non-zero everywhere (tails included),
    ragged lengths with one full-length row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    u = rng.normal(size=(B, U, T)).astype(np.float32)
    lengths = rng.integers(T // 3, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return x, u, lengths


def hmm_inputs(B: int, T: int, K: int, seed: int = 0):
    """(log_pi, log_A (B,T,K,K), log_obs (B,T,K), lengths) as numpy."""
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=(B, T, K))
                   ).astype(np.float32)
    log_obs = (2.0 * rng.normal(size=(B, T, K))).astype(np.float32)
    lengths = rng.integers(T // 3, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return log_pi, log_A, log_obs, lengths


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def write_serving_config(tmp, seed: int = 0, name: str = "cfg.json",
                         **extra) -> str:
    """A serving config for SMALL whose checkpoint is an `.npz` of the JAX
    package's init at `seed` (both packages' servers load it); `extra`
    adds or overrides top-level keys.  Returns the config's path."""
    import json

    from vqvaehmm_tpu.data.checkpoint import save_params_npz

    ckpt = tmp / f"model_{seed}.npz"
    save_params_npz(str(ckpt), make_model(**SMALL).init(
        jax.random.PRNGKey(seed)))
    cfg = {"model": SMALL, "checkpoint_path": str(ckpt), **extra}
    path = tmp / name
    path.write_text(json.dumps(cfg))
    return str(path)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post_json(url, payload=None, headers=None, timeout=60):
    """(status, JSON body, response headers) of a POST; HTTP errors are
    returned, not raised."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps({} if payload is None else payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def jax_mc_draws(key, K: int, A: int, n_sim: int, n_days: int, p0=None):
    """The random numbers vqvaehmm_tpu.backtest.montecarlo.
    monte_carlo_simulation draws from `key`, split exactly as it splits
    its keys (a key a path, split into the first regime's and the days';
    a key a day, split into the switch uniform's, the new regime's and the
    normals'), in the layout of the port's monte_carlo_draws: numpy z0
    (n_sim,), u_switch (n_sim, n_days), z_new (n_sim, n_days), eps (n_sim,
    n_days, A)."""
    import jax.numpy as jnp

    logp0 = jnp.log(jnp.asarray(np.full(K, 1.0 / K) if p0 is None
                                else np.asarray(p0), jnp.float32))

    def day(key_t):
        ks, kz, kn = jax.random.split(key_t, 3)
        return (jax.random.uniform(ks), jax.random.randint(kz, (), 0, K),
                jax.random.normal(kn, (A,)))

    def path(k):
        k0, kr = jax.random.split(k)
        return (jax.random.categorical(k0, logp0),
                *jax.vmap(day)(jax.random.split(kr, n_days)))

    z0, u, zn, eps = jax.vmap(path)(jax.random.split(key, n_sim))
    return {"z0": np.array(z0), "u_switch": np.array(u),
            "z_new": np.array(zn), "eps": np.array(eps)}


def jax_em_draws(seed: int, n_init: int, K: int, V: int):
    """The EM restarts' starting points fit_categorical_em draws from
    `seed` in the JAX package, stacked as the port's `init=`/`em_init=`:
    (log_pi (n_init, K), log_A (n_init, K, K), emission logits
    (n_init, K, V))."""
    import jax.numpy as jnp

    draws = []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_init):
        k1, k2, k3 = jax.random.split(key, 3)
        draws.append((
            jnp.log(jax.random.dirichlet(k1, jnp.ones(K))),
            jnp.log(jax.random.dirichlet(k2, jnp.full(K, 2.0), shape=(K,))),
            jnp.log(jax.random.dirichlet(k3, jnp.ones(V), shape=(K,)))))
    return tuple(np.stack([np.asarray(d[i]) for d in draws])
                 for i in range(3))


def jax_script(name: str):
    """scripts/<name>.py of the JAX package's studies, loaded by path."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ab_arm(port_dir, jax_dir, arm, epochs, spe=None, seed=42, nudge=None,
           tiled=False, with_jax=True):
    """One arm of throughput_quality_ab in both packages, each through its
    run_variant on the data stage in its own directory: the port's from
    JAX's initial parameters (nudge: a parameter's name, whose first entry
    is then one float32 ulp up; tiled: kernel C's plain version replaced
    by fused_loss_and_grads_tiled, csrc/fused_train.cu's order of the
    float32 sums), JAX's epoch losses in full precision off its epoch
    step; spe cuts the samples an epoch.  The bfloat16 arm runs on both
    sides as on the card and the TPU: the port's kernel C
    (training.fused=true; on the CPU its plain bfloat16-operand version),
    JAX's TPU kernel 5 in bf16_matmuls mode, forced (fused=True) and in
    interpret mode, where JAX's fused="auto" would take XLA's bfloat16
    path on the CPU, whose rounding points differ.  Returns (the port's
    (params, history, wall), JAX's or None, JAX's unrounded epoch losses,
    the JAX script, the JAX kernel's calls)."""
    import dataclasses

    import pytest

    import vqvaehmm_tpu.data.dataset as jds
    import vqvaehmm_tpu.data.device_sampler as jsampler
    import vqvaehmm_tpu.ops.pallas_train as jpt
    from vqvaehmm_tpu import VAEHMM as JVAEHMM
    from vqvaehmm_tpu.core.config import config_from_dict
    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.core.config import config_to_dict
    from vqvaehmm_tpu_torch.scripts import throughput_quality_ab
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    jab = jax_script("throughput_quality_ab")
    mp = pytest.MonkeyPatch()
    real_cfg, real_jcfg = recipe.recipe_config, jab._recipe_config

    def cut(cfg):
        if spe is None:
            return cfg
        return dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, samples_per_epoch=spe))

    mp.setattr(recipe, "recipe_config", lambda o, quality=False:
               cut(real_cfg(o, quality)))
    mp.setattr(jab, "_recipe_config", lambda o, quality=False:
               cut(real_jcfg(o, quality)))
    mp.setattr(jab, "OUTDIR", jax_dir)
    mp.setattr(jds, "_fastdata", None)
    mp.setenv("VQHMM_AB_EPOCHS", str(epochs))

    def jax_init(self):
        model = recipe.VAEHMM(self.cfg.model, device=self.device)
        jm = JVAEHMM(config_from_dict(config_to_dict(self.cfg)).model)
        state = params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(self.cfg.training.seed))))
        if nudge:
            w = state[nudge].reshape(-1)
            w[0] = torch.nextafter(w[0], torch.tensor(np.inf))
        model.load_state_dict(state)
        return model

    jax_losses, kernel_calls = [], []
    real_step = jsampler.DeviceEpochSampler.make_epoch_step

    def spy(self, *a, **k):
        step = real_step(self, *a, **k)

        def epoch(state, *args):
            state, loss = step(state, *args)
            jax_losses.append(float(loss))
            return state, loss
        return epoch

    real_kernel = jpt.fused_loss_and_grads

    def interpreted(*a, **k):
        kernel_calls.append(1)
        return real_kernel(*a, **dict(k, interpret=True))

    mp.setattr(TrainPipeline, "build_model", jax_init)
    mp.setattr(jsampler.DeviceEpochSampler, "make_epoch_step", spy)
    mp.setattr(jpt, "fused_loss_and_grads", interpreted)
    if tiled:
        import vqvaehmm_tpu_torch.train.trainer as trainer
        from vqvaehmm_tpu_torch.ops.fused_train import (
            fused_loss_and_grads_tiled, train_plan)

        def in_tiles(model, x, u, lengths, beta):
            plan = train_plan(model.cfg, x.shape[0], x.shape[-1])
            return fused_loss_and_grads_tiled(model, x, u, lengths, beta,
                                              tile=plan.tile)
        mp.setattr(trainer, "fused_loss_and_grads", in_tiles)
    try:
        mo, to = throughput_quality_ab.VARIANTS[arm]
        jmo, jto = jab.VARIANTS[arm]
        if arm == "throughput":
            to, jto = dict(to, fused=True), dict(jto, fused=True)
        got = throughput_quality_ab.run_variant(
            port_dir, arm, seed, mo, to, epochs, torch.device("cpu"))
        want = jab.run_variant(arm, seed, jmo, jto) if with_jax else None
        return got, want, jax_losses, jab, kernel_calls
    finally:
        mp.undo()


NUDGES = ("encoder.conv1.weight", "encoder.conv1.bias")


def bf16_trajectory(out_path, epochs=40, spe=None, seed=42, workdir=None,
                    gap_steps=30):
    """The throughput (bfloat16) arm of the A/B on the CPU, epoch by
    epoch from JAX's initial parameters on one sample stream: JAX's TPU
    kernel 5 in bf16_matmuls mode (interpret mode), the port's kernel C in
    its bfloat16-operand mode (the plain version), and three yardsticks of
    how far the chaos of training at lr 1e-3 alone moves a run: the port
    from one float32 ulp up in the first entry of each of NUDGES, and the
    port in kernel C's own order of the float32 sums.  Each run's weights
    are then scored under the float32 model as the study scores them, and
    bf16_step_gaps covers the first gap_steps steps (0: none).  Writes it
    all to out_path as JSON.

        python -c "from tests.torch_port import bf16_trajectory; \\
            bf16_trajectory('artifacts_torch/bf16_trajectory_cpu.json')"
    """
    import dataclasses
    import json
    import os
    import tempfile
    import time

    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.scripts import throughput_quality_ab as ab

    work = workdir or tempfile.mkdtemp(prefix="bf16_trajectory_")
    port_dir, jax_dir = (os.path.join(work, n) for n in ("port", "jax"))
    recipe.stage_data(port_dir)
    jax_script("full_recipe").stage_data(jax_dir)
    t0 = time.time()
    port, (jparams, jhist, _), jax_losses, _, calls = ab_arm(
        port_dir, jax_dir, "throughput", epochs, spe, seed)
    assert calls, "TPU kernel 5 was not called"
    runs = {"jax_kernel5_interpret": (params_from_numpy(jparams),
                                      jax_losses),
            "port_kernel_c_plain": port[:2]}
    walls = {"port_and_jax": round(time.time() - t0, 1)}
    # the yardsticks: the port's run again from one float32 ulp up in one
    # parameter (a product's operand, which bfloat16 rounds, and a bias,
    # added in float32), and in kernel C's own order of the float32 sums
    for name, kw in (("port_one_ulp_" + NUDGES[0], dict(nudge=NUDGES[0])),
                     ("port_one_ulp_" + NUDGES[1], dict(nudge=NUDGES[1])),
                     ("port_kernel_c_tiled", dict(tiled=True))):
        t0 = time.time()
        runs[name] = ab_arm(port_dir, jax_dir, "throughput", epochs, spe,
                            seed, with_jax=False, **kw)[0][:2]
        walls[name] = round(time.time() - t0, 1)

    def first_gap(a, b, tol):
        return next((i + 1 for i, (x, y) in enumerate(zip(a, b))
                     if abs(x - y) > tol * max(1.0, abs(y))), None)

    curves = {k: [float(v) for v in h] for k, (_, h) in runs.items()}
    base = curves["port_kernel_c_plain"]
    others = [k for k in curves if k != "port_kernel_c_plain"]
    out = {
        "what": "the throughput (bfloat16) arm of throughput_quality_ab "
                "on the CPU from JAX's initial parameters on one sample "
                "stream: JAX's TPU kernel 5 (bf16_matmuls, interpret mode) "
                "and the port's kernel C plain bfloat16-operand version; "
                "the yardsticks: the port from one float32 ulp up in the "
                f"first entry of {NUDGES[0]} and of {NUDGES[1]}, and the "
                "port in kernel C's own order of the float32 sums "
                "(fused_loss_and_grads_tiled)",
        "device": "cpu", "torch": torch.__version__, "jax": jax.__version__,
        "seed": seed, "epochs": epochs,
        "samples_per_epoch": spe or recipe.recipe_config(
            port_dir, True).data.samples_per_epoch,
        "widths": {k: v for k, v in dataclasses.asdict(
            recipe.recipe_config(port_dir, True).model).items()
            if isinstance(v, (int, float, str, bool))},
        "wall_seconds": walls,
        "jax_logged_history": [float(v) for v in jhist],
        "curves": curves,
        "abs_gap_to_port_kernel_c_plain": {
            k: [round(abs(a - b), 7) for a, b in zip(curves[k], base)]
            for k in others},
        "first_epoch_parting": {
            f"{tol:g}": {k: first_gap(curves[k], base, tol) for k in others}
            for tol in (1e-5, 1e-4, 1e-3, 1e-2)},
        "scored_f32": {k: ab.evaluate(port_dir, p, torch.device("cpu"))
                       for k, (p, _) in runs.items()},
    }
    if gap_steps:
        to_jax, own = bf16_step_gaps(port_dir, gap_steps, seed)
        out["step_gaps"] = {
            "what": "the port's run step by step (plain version): at each "
                    "step's parameters the worst leaf's gradient gap over "
                    "its largest entry, JAX's kernel 5 to the nearer of "
                    "the port's two orders of the float32 sums (plain, "
                    "tiled as csrc/fused_train.cu), and the port's two "
                    "orders to each other",
            "jax_to_port": to_jax, "port_plain_to_tiled": own}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def bf16_trajectory_seeds(out_path, paths):
    """Gathers bf16_trajectory's files of several seeds into one: each
    seed's file whole, and a row a seed of where JAX's kernel 5 ends
    against the port's two orders of the float32 sums (plain and tiled):
    each run's negative ELBO scored under the float32 model (the A/B's
    metric), its last epoch's loss and the mean of its last 10, whether
    JAX's is below both of the port's on each, and at how many epochs
    after the first JAX's loss is the lowest of the three.  If the three
    runs part by the sum order alone they are exchangeable, and JAX's is
    the lowest at about one seed or epoch in three.

        for s in 43 44 45 46; do python -c "from tests.torch_port import \\
            bf16_trajectory as b; b('s$s.json', seed=$s, gap_steps=0)"; done
        python -c "from tests.torch_port import bf16_trajectory_seeds as b; \\
            b('artifacts_torch/bf16_trajectory_cpu_seeds42-46.json', \\
              ['artifacts_torch/bf16_trajectory_cpu.json', 's43.json', \\
               's44.json', 's45.json', 's46.json'])"
    """
    import json

    orders = ("jax_kernel5_interpret", "port_kernel_c_plain",
              "port_kernel_c_tiled")
    runs, table = {}, {}
    for p in paths:
        with open(p) as f:
            run = json.load(f)
        runs[str(run["seed"])] = run
        c = {k: run["curves"][k] for k in orders}
        rows = {
            "scored_neg_elbo_f32": {k: run["scored_f32"][k][
                "final_neg_elbo_full_panel_f32"] for k in orders},
            "last_epoch_loss": {k: v[-1] for k, v in c.items()},
            "last_10_epochs_mean_loss": {k: float(np.mean(v[-10:]))
                                         for k, v in c.items()}}
        row = dict(rows)
        for name, r in rows.items():
            row[f"jax_below_both_{name}"] = all(
                r[orders[0]] < r[k] for k in orders[1:])
        row["epochs_jax_lowest"] = sum(
            c[orders[0]][e] < min(c[k][e] for k in orders[1:])
            for e in range(1, len(c[orders[0]])))
        row["epochs_after_the_first"] = len(c[orders[0]]) - 1
        table[str(run["seed"])] = row
    totals = {k: sum(r[k] for r in table.values())
              for k in next(iter(table.values())) if k.startswith(
                  ("jax_below_both", "epochs_"))}
    totals["seeds"] = len(table)
    out = {"what": "bf16_trajectory at several seeds: where JAX's kernel 5 "
                   "ends against the port's two orders of the float32 sums",
           "totals": totals, "table": table, "runs": runs}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def bf16_step_gaps(outdir, steps, seed=42, tiled_where=0.0):
    """The bfloat16 arm of the A/B (the quality recipe's widths, the data
    stage's windows in outdir) run `steps` steps from JAX's initial
    parameters by the port's plain kernel-C version; at each step's
    parameters, TPU kernel 5 in bf16_matmuls mode (interpret mode), and
    the port's tiled version (csrc/fused_train.cu's order of the float32
    sums, fused_loss_and_grads_tiled) where JAX's kernel parts from the
    plain version by more than tiled_where (0: at every step).  Returns
    two lists, a value a step, each the worst leaf's gap over its largest
    entry: JAX's kernel to the nearer of the port's orders, and the
    port's two orders to each other (None where the tiled version was
    not computed)."""
    import dataclasses

    import jax.numpy as jnp

    from vqvaehmm_tpu import VAEHMM as JVAEHMM
    from vqvaehmm_tpu.core.config import config_from_dict
    from vqvaehmm_tpu.ops.pallas_train import fused_loss_and_grads as jfused
    from vqvaehmm_tpu_torch import recipe
    from vqvaehmm_tpu_torch.core.config import config_to_dict
    from vqvaehmm_tpu_torch.data.checkpoint import params_to_numpy
    from vqvaehmm_tpu_torch.data.dataset import (RandomChunkDataset,
                                                 epoch_arrays)
    from vqvaehmm_tpu_torch.ops.fused_train import (
        fused_loss_and_grads, fused_loss_and_grads_tiled, train_plan)
    from vqvaehmm_tpu_torch.scripts import throughput_quality_ab
    from vqvaehmm_tpu_torch.scripts._common import load_windows
    from vqvaehmm_tpu_torch.train.trainer import make_optimizer

    cfg = recipe.recipe_config(outdir, quality=True)
    mo, _ = throughput_quality_ab.VARIANTS["throughput"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **mo))
    x, u, _ = load_windows(outdir)
    ds = RandomChunkDataset(list(x), list(u), min_len=cfg.data.min_len,
                            max_len=cfg.data.max_len,
                            samples_per_epoch=cfg.data.samples_per_epoch,
                            seed=seed)
    xs, us, ls = epoch_arrays(ds, cfg.training.batch_size)
    jm = JVAEHMM(config_from_dict(config_to_dict(cfg)).model)
    model = recipe.VAEHMM(cfg.model)
    model.load_state_dict(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed)))))
    opt = make_optimizer(model, cfg.training.learning_rate,
                         gradient_clip=cfg.training.gradient_clip)
    B, T = xs.shape[1], xs.shape[-1]
    tile = train_plan(cfg.model, B, T).tile
    kernel5 = jax.jit(lambda p, a, b, c: jfused(jm, p, a, b, c, 1.0,
                                                interpret=True))
    to_jax, own = [], []
    for i in range(steps):
        batch = [t(a[i % len(xs)]) for a in (xs, us, ls)]
        _, plain = fused_loss_and_grads(model, *batch, 1.0)
        for name, p in model.named_parameters():
            p.grad = plain[name]
        state = {k: v.detach() for k, v in model.state_dict().items()}
        _, jg = kernel5(jax.tree_util.tree_map(
            jnp.asarray, params_to_numpy(state)),
            *(jnp.asarray(a[i % len(xs)]) for a in (xs, us, ls)))
        want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jg))

        def gap(g, ref):
            return max(float((g[n] - ref[n]).abs().max())
                       / float(w.abs().max()) for n, w in want.items())
        to_jax.append(gap(plain, want))
        own.append(None)
        if to_jax[-1] > tiled_where:
            _, tiled = fused_loss_and_grads_tiled(model, *batch, 1.0,
                                                  tile=tile)
            to_jax[-1] = max(min(float((g[n] - w).abs().max())
                                 for g in (plain, tiled))
                             / float(w.abs().max()) for n, w in want.items())
            own[-1] = gap(plain, tiled)
        opt.update()
    return to_jax, own
