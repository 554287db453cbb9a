"""The port's studies and reference CLIs (vqvaehmm_tpu_torch/scripts/)
against the JAX package's scripts under scripts/, on the CPU at a tiny
size.

The JAX scripts are loaded with importlib, their OUTDIR and ARTIFACT
pointed at a temporary directory, on the data stage of the JAX recipe
(the port's on its own, both cut to the same N_WIN windows):
- the float32 arm of the quality A/B trained through each package's
  TrainPipeline for 2 epochs (2 steps an epoch) from JAX's initial
  parameters on one sample stream: the first epoch's loss within 1e-5;
  both scored on JAX's trained parameters: the ELBO within 1e-4
  relative, the decoded states equal except at ties (the Viterbi scores
  then within 1e-4 absolute or 32 float32 roundings), the accuracies and
  switch rates equal;
- the reference's own torch model (crash_regime's torch_ref stage) bit
  for bit, both being torch on the CPU;
- the pure helpers exactly equal on random inputs (majority_map, score,
  agg, score_stack, dist, the paired deltas, the aggregations of each
  stage on the same stand-in rows);
- each port main(["--device", "cpu", ...]) writes a JSON whose keys
  contain the JAX script's: the JAX mains run on stand-ins for their
  training, or the committed JAX artifact's keys, or for the scripts
  that print their JSON the keys of its dict literals;
- `--device cuda` without a card raises, and no module of the
  subpackage imports JAX, the JAX package or scripts/."""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import t
from vqvaehmm_tpu_torch import recipe
from vqvaehmm_tpu_torch.scripts import (backtest, crash_regime,
                                        ensemble_eval,
                                        fixture_model_compare, quality_eval,
                                        quality_sweep, throughput_quality_ab,
                                        train, vq_quality, vq_sweep)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N_WIN = 8            # the fixture windows the tests keep
SPE = 128            # samples an epoch: 2 steps of B=64
MODULES = [throughput_quality_ab, vq_sweep, crash_regime,
           fixture_model_compare, quality_eval, vq_quality, quality_sweep,
           ensemble_eval, train, backtest]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut_data(outdir):
    """The data stage's windows cut to N_WIN: the first half of them
    without a crash day and the first half with one, so that all three
    regimes are there."""
    d = os.path.join(outdir, "data")
    crash = (np.load(os.path.join(d, "z_windows.npy")) == 2).any(1)
    keep = np.sort(np.concatenate([np.flatnonzero(~crash)[:N_WIN // 2],
                                   np.flatnonzero(crash)[:N_WIN // 2]]))
    for name in ("x_sequences.npy", "u_sequences.npy", "z_windows.npy"):
        np.save(os.path.join(d, name), np.load(os.path.join(d, name))[keep])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Each recipe's data stage in a directory of its own, cut to the same
    N_WIN windows."""
    port, jax_dir = (str(tmp_path_factory.mktemp(n)) for n in ("port", "jax"))
    recipe.stage_data(port)
    _jax_script("full_recipe").stage_data(jax_dir)
    for d in (port, jax_dir):
        _cut_data(d)
    return port, jax_dir


def _json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def _keys_contain(got, want, path=""):
    """Every key of want is in got, recursively through dicts (and the
    first row of lists of dicts)."""
    for k, v in want.items():
        assert k in got, f"{path}{k} missing"
        if isinstance(v, dict) and isinstance(got[k], dict):
            _keys_contain(got[k], v, f"{path}{k}.")
        elif (isinstance(v, list) and v and isinstance(v[0], dict)
              and isinstance(got[k], list) and got[k]):
            _keys_contain(got[k][0], v[0], f"{path}{k}[0].")


# -- the float32 arm of the A/B, trained and scored -------------------------


@pytest.fixture(scope="module")
def ab_runs(dirs):
    """The parity arm at seed 42 for 2 epochs through each package's
    run_variant, the port's from JAX's initial parameters; JAX's epoch
    losses in full precision off its epoch step."""
    import vqvaehmm_tpu.data.dataset as jds
    import vqvaehmm_tpu.data.device_sampler as jsampler
    from vqvaehmm_tpu import VAEHMM as JVAEHMM
    from vqvaehmm_tpu.core.config import config_from_dict
    from vqvaehmm_tpu_torch.core.config import config_to_dict
    from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    port, jax_dir = dirs
    jab = _jax_script("throughput_quality_ab")
    mp = pytest.MonkeyPatch()
    real_cfg, real_jcfg = recipe.recipe_config, jab._recipe_config

    def cut(cfg):
        return dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, samples_per_epoch=SPE))

    mp.setattr(recipe, "recipe_config", lambda o, quality=False:
               cut(real_cfg(o, quality)))
    mp.setattr(jab, "_recipe_config", lambda o, quality=False:
               cut(real_jcfg(o, quality)))
    mp.setattr(jab, "OUTDIR", jax_dir)
    mp.setattr(jds, "_fastdata", None)
    mp.setenv("VQHMM_AB_EPOCHS", "2")

    def jax_init(self):
        model = recipe.VAEHMM(self.cfg.model, device=self.device)
        jm = JVAEHMM(config_from_dict(config_to_dict(self.cfg)).model)
        model.load_state_dict(params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(self.cfg.training.seed)))))
        return model

    jax_losses = []
    real_step = jsampler.DeviceEpochSampler.make_epoch_step

    def spy(self, *a, **k):
        step = real_step(self, *a, **k)

        def epoch(state, *args):
            state, loss = step(state, *args)
            jax_losses.append(float(loss))
            return state, loss
        return epoch

    mp.setattr(TrainPipeline, "build_model", jax_init)
    mp.setattr(jsampler.DeviceEpochSampler, "make_epoch_step", spy)
    try:
        mo, to = throughput_quality_ab.VARIANTS["parity"]
        got = throughput_quality_ab.run_variant(port, "parity", 42, mo, to,
                                                2, CPU)
        want = jab.run_variant("parity", 42, *jab.VARIANTS["parity"])
        return got, want, jax_losses, jab
    finally:
        mp.undo()


def test_ab_float32_arm_trains_as_jax(ab_runs):
    """The same first epoch: the arm's loss within 1e-5 (JAX's from its
    epoch step, unrounded), the second within JAX's logged 4 places."""
    (params, history, _), (_, jax_history, _), jax_losses, _ = ab_runs
    assert len(history) == len(jax_history) == len(jax_losses) == 2
    assert abs(history[0] - jax_losses[0]) <= 1e-5 * max(1.0,
                                                         abs(jax_losses[0]))
    assert abs(history[1] - jax_history[1]) <= 1e-4 * max(
        1.0, abs(jax_history[1])) + 5e-5


def test_ab_scoring_matches_jax_on_shared_parameters(dirs, ab_runs):
    """evaluate() on JAX's trained parameters in both packages: the ELBO
    within 1e-4 relative; each decode's states equal except at ties;
    the accuracies and switch rates then equal."""
    from vqvaehmm_tpu import VAEHMM as JVAEHMM
    from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy

    port, jax_dir = dirs
    _, (jparams, _, _), _, jab = ab_runs
    mp = pytest.MonkeyPatch()
    mp.setattr(jab, "OUTDIR", jax_dir)
    try:
        want = jab.evaluate(jparams)
    finally:
        mp.undo()
    got = throughput_quality_ab.evaluate(port, params_from_numpy(jparams),
                                         CPU)
    assert list(got) == list(want)
    e = want["final_neg_elbo_full_panel_f32"]
    assert abs(got["final_neg_elbo_full_panel_f32"] - e) <= 1e-4 * abs(e)
    # the states the two decodes give, ties told apart by their scores
    x, u, _ = (np.load(os.path.join(port, "data", n)) for n in
               ("x_sequences.npy", "u_sequences.npy", "z_windows.npy"))
    model = recipe.VAEHMM(recipe.recipe_config(port, True).model)
    model.load_state_dict(params_from_numpy(jparams))
    ours = recipe._decodes(model.eval(), x, u, CPU, meanfield=False)
    jm = JVAEHMM(jab._recipe_config(jax_dir, quality=True).model)
    theirs = {"smoothed_argmax": np.asarray(jm.smoothed_posterior(
                  jparams, jnp.asarray(x), jnp.asarray(u))).argmax(1),
              "viterbi": np.asarray(jm.viterbi_decode(
                  jparams, jnp.asarray(x), jnp.asarray(u)))}
    assert np.array_equal(ours["smoothed_argmax"], theirs["smoothed_argmax"])
    if not np.array_equal(ours["viterbi"], theirs["viterbi"]):
        _same_viterbi_scores(model, x, u, ours["viterbi"], theirs["viterbi"])
    else:
        for k in want:
            if k != "final_neg_elbo_full_panel_f32":
                assert got[k] == want[k], k


def _same_viterbi_scores(model, x, u, a, b):
    """Two Viterbi paths of one evidence: their scores within 1e-4
    absolute or 32 float32 roundings (ROADMAP "Viterbi ties")."""
    with torch.no_grad():
        log_pi, log_A, log_obs = model._evidence_inputs(t(x), t(u), None,
                                                        False)
    for states in (a, b):
        assert states.shape == x.shape[::2]

    def score(s):
        s = torch.as_tensor(s).long()
        lo = torch.gather(log_obs, 2, s[..., None])[..., 0].sum(1)
        la = log_A if log_A.dim() == 4 else log_A.expand(
            log_obs.shape[0], log_obs.shape[1], *log_A.shape[-2:])
        tr = la[torch.arange(s.shape[0])[:, None],
                torch.arange(1, s.shape[1])[None], s[:, :-1], s[:, 1:]]
        return log_pi[s[:, 0]] + lo + tr.sum(1)
    sa, sb = score(a), score(b)
    tol = torch.maximum(torch.full_like(sa, 1e-4),
                        32 * torch.finfo(torch.float32).eps * sb.abs())
    assert bool(((sa - sb).abs() <= tol).all())


def test_ab_main_aggregates_as_jax(dirs, tmp_path, monkeypatch):
    """Both mains on the same stand-in arms (each seed's row from a seeded
    draw): per-seed rows, distributions, paired deltas and the ground
    truth's switch rate exactly equal, the port's keys containing JAX's,
    JAX's distributions beside them."""
    port, jax_dir = dirs
    jab = _jax_script("throughput_quality_ab")
    monkeypatch.setattr(jab, "OUTDIR", jax_dir)

    def fake_rows(tag, seed):
        rng = np.random.default_rng(seed + (tag == "throughput") * 100)
        return {"final_neg_elbo_full_panel_f32": round(float(rng.normal()),
                                                       6),
                **{f"{k}_{m}": round(float(rng.uniform()), 4)
                   for m in ("smoothed_argmax", "viterbi")
                   for k in ("regime_acc", "regime_bal_acc",
                             "switch_rate")}}

    seen = {}

    def jax_run(tag, seed, mo, to):
        seen["seed"] = seed
        return {"tag": tag}, [1.0 + seed, 0.5 + seed], 1.25

    def port_run(outdir, tag, seed, mo, to, epochs, device):
        seen["seed"] = seed
        return {"tag": tag}, [1.0 + seed, 0.5 + seed], 1.25

    monkeypatch.setattr(jab, "run_variant", jax_run)
    monkeypatch.setattr(jab, "evaluate",
                        lambda p: fake_rows(p["tag"], seen["seed"]))
    monkeypatch.setattr(throughput_quality_ab, "run_variant", port_run)
    monkeypatch.setattr(throughput_quality_ab, "evaluate",
                        lambda o, p, d: fake_rows(p["tag"], seen["seed"]))
    seeds = [42, 43, 44]
    monkeypatch.setattr(sys, "argv", ["x", "--seeds", *map(str, seeds)])
    jab.main()
    want = _json(jax_dir, "throughput_quality_ab.json")
    assert throughput_quality_ab.main(
        ["--device", "cpu", "--outdir", port, "--seeds",
         *map(str, seeds)]) == 0
    got = _json(port, "throughput_quality_ab.json")
    _keys_contain(got, want)
    for arm in ("parity", "throughput"):
        assert got[arm]["distributions"] == want[arm]["distributions"]
        for g, w in zip(got[arm]["per_seed"], want[arm]["per_seed"]):
            assert {k: v for k, v in g.items() if k in w} == w
    assert got["deltas_throughput_minus_parity"] == \
        want["deltas_throughput_minus_parity"]
    assert got["switch_rate_ground_truth"] == want["switch_rate_ground_truth"]
    assert got["seeds"] == seeds and got["backend"] == "cpu"
    committed = _json(os.path.join(ROOT, "artifacts"),
                      "throughput_quality_ab.json")
    assert got["jax_artifact"]["distributions"]["parity"] == \
        committed["parity"]["distributions"]
    spread = got["jax_artifact"]["port_median_vs_jax_spread"]["parity"]
    assert spread["regime_bal_acc_viterbi"]["inside"] == (
        committed["parity"]["distributions"]["regime_bal_acc_viterbi"][0]
        <= got["parity"]["distributions"]["regime_bal_acc_viterbi"][1]
        <= committed["parity"]["distributions"]["regime_bal_acc_viterbi"][2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dist_equals_jax(seed):
    jab = _jax_script("throughput_quality_ab")
    rng = np.random.default_rng(seed)
    rows = [{"a": float(v), "b": int(w)} for v, w in
            zip(rng.normal(size=5), rng.integers(0, 9, size=5))]
    for key in ("a", "b"):
        assert throughput_quality_ab.dist(rows, key) == jab.dist(rows, key)


# -- crash_regime -----------------------------------------------------------


@pytest.mark.parametrize("n_states", [3, 5])
def test_crash_helpers_equal_jax(n_states):
    """majority_map, score and agg on random decodes with crash runs."""
    jcr = _jax_script("crash_regime")
    rng = np.random.default_rng(n_states)
    z = rng.choice(3, p=[0.8, 0.15, 0.05], size=(6, 40))
    z[2, 10:15] = 2
    rows = []
    for seed in range(3):
        pred = np.random.default_rng(seed).integers(0, n_states, size=z.shape)
        assert np.array_equal(
            crash_regime.majority_map(pred.reshape(-1), z.reshape(-1),
                                      n_states),
            jcr.majority_map(pred.reshape(-1), z.reshape(-1), n_states))
        got, want = (m.score(pred, z, n_states) for m in (crash_regime, jcr))
        assert got == want and list(got) == list(want)
        rows.append({"seed": seed, "wall_seconds": 1.0, **got})
    assert crash_regime.agg(rows) == jcr.agg(rows)


def test_crash_torch_ref_bit_equal_to_jax_script(dirs, monkeypatch):
    """The reference's own model, one epoch on each script's windows:
    the same rows (both are torch on the CPU, from one seed)."""
    port, jax_dir = dirs
    jcr = _jax_script("crash_regime")
    monkeypatch.setattr(jcr, "OUTDIR", jax_dir)
    monkeypatch.setenv("VQHMM_CR_EPOCHS", "1")
    want = jcr.stage_torch_ref([42])
    got = crash_regime.stage_torch_ref(port, [42], 1, CPU)
    for g, w in zip(got["per_seed"], want["per_seed"]):
        g.pop("wall_seconds"), w.pop("wall_seconds")
        assert g == w
    assert got["summary"] == want["summary"]


def test_crash_main_and_arms_aggregate_as_jax(dirs, monkeypatch):
    """Every stage on stand-in training and decodes (each seed's states a
    seeded draw, scored by each script's own score): the per-seed rows,
    summaries by mode and pools equal, the port's keys containing JAX's."""
    port, jax_dir = dirs
    jcr = _jax_script("crash_regime")
    monkeypatch.setattr(jcr, "OUTDIR", jax_dir)
    monkeypatch.setattr(jcr, "ARTIFACT",
                        os.path.join(jax_dir, "crash_regime.json"))

    def decodes(seed, z, n_states, score):
        rng = np.random.default_rng(seed)
        return {m: score(rng.integers(0, n_states, size=z.shape), z,
                         n_states) for m in crash_regime.MODES}

    monkeypatch.setattr(jcr, "train_variant",
                        lambda tag, seed, xp, up, model_over=None:
                        (SimpleNamespace(model=SimpleNamespace(
                            K=(model_over or {}).get("K", 3))),
                         SimpleNamespace(params=seed), 2.0))
    monkeypatch.setattr(jcr, "eval_all_modes",
                        lambda cfg, params, x, u, z: decodes(
                            params, z, cfg.model.K, jcr.score))
    monkeypatch.setattr(crash_regime, "train_variant",
                        lambda outdir, tag, seed, xp, up, epochs, device,
                        model_over=None:
                        (SimpleNamespace(model=SimpleNamespace(
                            K=(model_over or {}).get("K", 3))), seed, 2.0))
    monkeypatch.setattr(crash_regime, "eval_all_modes",
                        lambda cfg, params, x, u, z, device: decodes(
                            params, z, cfg.model.K, crash_regime.score))
    ref = {"decode": "d", "config": "c", "per_seed": [], "summary": {}}
    monkeypatch.setattr(jcr, "stage_torch_ref", lambda seeds: ref)
    monkeypatch.setitem(crash_regime.RUNNERS, "torch_ref",
                        lambda o, s, e, d: ref)
    monkeypatch.setattr(crash_regime, "RUNNERS", {
        **crash_regime.RUNNERS,
        **{k: getattr(crash_regime, "stage_" + k) for k in
           ("current", "oversample_gt", "oversample_vol", "k5_merge")}})
    monkeypatch.setattr(sys, "argv", ["x", "--seeds", "42", "43"])
    jcr.main()
    assert crash_regime.main(["--device", "cpu", "--outdir", port,
                              "--seeds", "42", "43", "--epochs", "1"]) == 0
    want, got = (_json(d, "crash_regime.json") for d in (jax_dir, port))
    _keys_contain(got, want)
    for s in crash_regime.STAGES[1:]:
        assert got[s] == want[s], s
    assert got["crash_day_share"] == want["crash_day_share"]
    assert got["jax_artifact"]["k5_merge"] == _json(
        os.path.join(ROOT, "artifacts"),
        "crash_regime.json")["k5_merge"]["summary_by_mode"]


# -- vq_sweep ---------------------------------------------------------------


class _Stack:
    """A stand-in VQ stack: fixed marginals and paths (both packages'
    score_stack take them)."""

    def __init__(self, seed, N=5, T=30):
        rng = np.random.default_rng(seed)
        self.gamma = torch.from_numpy(rng.dirichlet(np.ones(3),
                                                    size=(N, T)))
        self.vit = torch.from_numpy(rng.integers(0, 3, size=(N, T)))
        self.usage = [round(float(v), 4) for v in rng.dirichlet(np.ones(8))]
        self.model = SimpleNamespace(device=CPU)

    def regime_marginals(self, x, lens):
        return self.gamma

    def viterbi(self, x, lens):
        return self.vit


@pytest.mark.parametrize("seed", [0, 1])
def test_score_stack_equals_jax(seed):
    jvs = _jax_script("vq_sweep")
    stack = _Stack(seed)
    x = np.zeros((5, 5, 30), np.float32)
    z = np.random.default_rng(seed + 10).integers(0, 3, size=(5, 30))
    got = vq_sweep.score_stack(stack, x, z)
    want = jvs.score_stack(stack, jnp.asarray(x), z)
    assert got == want and list(got) == list(want)


def _fake_row(seed, nc, cb, ls):
    rng = np.random.default_rng(hash((seed, nc, cb, ls)) % 2 ** 32)
    return {"num_codes": nc, "commitment_beta": cb, "codebook_lr_scale": ls,
            "seed": seed, "wall_seconds": 1.0, "final_vq_loss": 0.5,
            **{k: round(float(rng.uniform()), 4)
               for k in vq_sweep.SCORE_KEYS},
            "codebook_usage": [round(float(v), 4)
                               for v in rng.dirichlet(np.ones(nc))]}


def test_vq_sweep_stages_aggregate_as_jax(dirs, monkeypatch):
    """sweep, joint and seeds on stand-in points and joint iterations:
    the grids, the best point, the seeds' distributions and paired
    deltas exactly equal, the port's keys containing JAX's."""
    port, jax_dir = dirs
    jvs = _jax_script("vq_sweep")
    monkeypatch.setattr(jvs, "OUTDIR", jax_dir)
    monkeypatch.setattr(jvs, "ARTIFACT", os.path.join(jax_dir,
                                                      "vq_sweep.json"))

    def joint(epochs, outer_iters=2, finetune_epochs=10, lam=1.0, seed=42):
        last = {"iter": 2, "vq_loss": 0.1, "hmm_ce": 0.2,
                **_fake_row(seed, 8, lam, 9.0)}
        return {"base": _fake_row(seed, 8, 0.25, 1.0), "lam": lam,
                "tau": "median d^2 per iter", "outer_iters": outer_iters,
                "seed": seed, "finetune_epochs": finetune_epochs,
                "iterations": [last]}

    monkeypatch.setattr(jvs, "run_point",
                        lambda e, nc, cb, ls, tag, seed=42:
                        (_fake_row(seed, nc, cb, ls),))
    monkeypatch.setattr(jvs, "stage_joint", joint)
    monkeypatch.setattr(vq_sweep.Study, "run_point",
                        lambda self, e, nc, cb, ls, tag, seed=42:
                        (_fake_row(seed, nc, cb, ls),))
    monkeypatch.setattr(vq_sweep.Study, "stage_joint",
                        lambda self, *a, **k: joint(*a, **k))
    for stage, extra in (("all", []), ("seeds", ["--seeds", "42", "43",
                                                 "44", "45"])):
        monkeypatch.setattr(sys, "argv", ["x", "--stage", stage, *extra])
        jvs.main()
        assert vq_sweep.main(["--device", "cpu", "--outdir", port,
                              "--stage", stage, *extra]) == 0
    want, got = (_json(d, "vq_sweep.json") for d in (jax_dir, port))
    _keys_contain(got, want)
    for k in ("sweep", "joint_lam0.3", "joint_lam1.0", "seeds"):
        assert got[k] == want[k], k
    assert got["jax_artifact"]["seeds"] == _json(
        os.path.join(ROOT, "artifacts"), "vq_sweep.json")["seeds"]


def _cut_vq(cfg):
    """A sweep point cut to one step an epoch and 2 EM iterations."""
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, samples_per_epoch=64),
        vq=dataclasses.replace(cfg.vq, hmm_iters=2))


def test_vq_joint_stage_follows_jax(dirs, tmp_path, monkeypatch):
    """stage_joint at 1 outer iteration of 2 finetune steps from JAX's
    trained default point (1 epoch, its archive loaded by the port): the
    code targets p_code within 1e-5 and tau, the last step's VQ loss and
    cross-entropy within 1e-5 relative, the refit's codes equal, and
    from JAX's EM restarts every row of the stage equal."""
    import vqvaehmm_tpu.data.dataset as jds
    import vqvaehmm_tpu.models.hmm as jhmm
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
    from vqvaehmm_tpu_torch.train.vq_pipeline import VQStack

    port, jax_dir = dirs
    jvs = _jax_script("vq_sweep")
    monkeypatch.setattr(jds, "_fastdata", None)
    monkeypatch.setattr(jvs, "OUTDIR", jax_dir)
    real_jcfg, real_cfg = jvs.base_config, vq_sweep.base_config
    monkeypatch.setattr(jvs, "base_config",
                        lambda *a, **k: _cut_vq(real_jcfg(*a, **k)))
    monkeypatch.setattr(vq_sweep, "base_config",
                        lambda *a, **k: _cut_vq(real_cfg(*a, **k)))
    row0, jstack, _, _, _ = jvs.run_point(1, 8, 0.25, 1.0, "base", seed=42)
    archive = str(tmp_path / "vq_stack.npz")
    jstack.save(archive)

    def port_point(self, epochs, nc, cb, ls, tag, seed=42):
        cfg = vq_sweep.base_config(self.outdir, epochs, nc, cb, ls, seed)
        dataset = TrainPipeline(cfg, device=CPU).load_data()
        return row0, VQStack.load(archive, device="cpu"), None, cfg, dataset

    monkeypatch.setattr(vq_sweep.Study, "run_point", port_point)

    # what each side computes inside the stage
    seen = {"jax": {}, "port": {}}
    real_jit, real_jem = jax.jit, jhmm.fit_categorical_em

    def jit(fn, *a, **k):
        compiled = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "finetune_step":
            return compiled

        def step(params, opt_state, p_code, tau):
            out = compiled(params, opt_state, p_code, tau)
            seen["jax"].update(p_code=np.asarray(p_code), tau=float(tau),
                               base=float(out[2]), ce=float(out[3]))
            return out
        return step

    def jax_em(codes, *a, **k):
        seen["jax"]["codes"] = np.asarray(codes)
        return real_jem(codes, *a, **k)

    real_targets, real_finetune = vq_sweep.code_targets, vq_sweep.finetune
    real_em = vq_sweep.fit_categorical_em

    def targets(*a):
        p_code, tau = real_targets(*a)
        seen["port"].update(p_code=p_code.numpy(), tau=tau)
        return p_code, tau

    def finetune(*a):
        base, ce = real_finetune(*a)
        seen["port"].update(base=float(base), ce=float(ce))
        return base, ce

    def port_em(codes, K, V, n_iters, seed, lengths, n_init, sticky):
        seen["port"]["codes"] = codes.numpy()
        draws = []
        for key in jax.random.split(jax.random.PRNGKey(seed), n_init):
            k1, k2, k3 = jax.random.split(key, 3)
            draws.append((
                jnp.log(jax.random.dirichlet(k1, jnp.ones(K))),
                jnp.log(jax.random.dirichlet(k2, jnp.full(K, 2.0),
                                             shape=(K,))),
                jnp.log(jax.random.dirichlet(k3, jnp.ones(V), shape=(K,)))))
        init = tuple(np.stack([np.asarray(d[i]) for d in draws])
                     for i in range(3))
        return real_em(codes, K, V, n_iters, seed, lengths, n_init=n_init,
                       sticky=sticky, init=init)

    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(jhmm, "fit_categorical_em", jax_em)
    monkeypatch.setattr(vq_sweep, "code_targets", targets)
    monkeypatch.setattr(vq_sweep, "finetune", finetune)
    monkeypatch.setattr(vq_sweep, "fit_categorical_em",
                        lambda codes, K, V, n_iters, seed, lengths, n_init,
                        sticky: port_em(codes, K, V, n_iters, seed, lengths,
                                        n_init, sticky))
    kw = dict(outer_iters=1, finetune_epochs=2, lam=0.3, seed=42)
    want = jvs.stage_joint(1, **kw)
    monkeypatch.setattr(jax, "jit", real_jit)
    got = vq_sweep.Study(port, CPU).stage_joint(1, **kw)

    j, p = seen["jax"], seen["port"]
    np.testing.assert_allclose(p["p_code"], j["p_code"], rtol=0, atol=1e-5)
    for k in ("tau", "base", "ce"):
        assert abs(p[k] - j[k]) <= 1e-5 * max(1.0, abs(j[k])), k
    assert np.array_equal(p["codes"], j["codes"])
    assert got == want


# -- quality_eval -----------------------------------------------------------


def test_quality_eval_member_follows_jax(tmp_path, monkeypatch, capsys):
    """quality_eval at 2 epochs, the port's member from JAX's initial
    parameters over the same numpy stream: each epoch's loss within 1e-5
    relative of JAX's unrounded, the test ELBO and reconstruction MSE
    within 1e-4 relative, the three decodes' accuracies equal."""
    import vqvaehmm_tpu as vt
    import vqvaehmm_tpu.data.dataset as jds
    from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
    from vqvaehmm_tpu_torch.train.trainer import TrainState, make_optimizer

    jq = _jax_script("quality_eval")
    monkeypatch.setattr(jds, "_fastdata", None)
    jax_hist, real_jtrain = [], vt.train_model

    def jtrain(model, ds, **kw):
        state, hist = real_jtrain(model, ds, **kw)
        jax_hist.extend(hist)
        return state, hist

    monkeypatch.setattr(vt, "train_model", jtrain)
    monkeypatch.setattr(sys, "argv", ["x", "--epochs", "2"])
    jq.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    init = jax.tree_util.tree_map(np.asarray, vt.make_model(
        5, 64, 3, 32, u_dim=4, trans_hidden=64).init(jax.random.PRNGKey(0)))
    real_train = quality_eval.train_model

    def from_jax_init(model, ds, lr, **kw):
        model.load_state_dict(params_from_numpy(init))
        return real_train(model, ds, lr=lr, state=TrainState(
            model, make_optimizer(model, lr)), **kw)

    monkeypatch.setattr(quality_eval, "train_model", from_jax_init)
    assert quality_eval.main(["--device", "cpu", "--outdir", str(tmp_path),
                              "--epochs", "2"]) == 0
    got = _json(str(tmp_path), "quality_eval.json")
    assert len(got["train_history"]) == len(jax_hist) == 2
    for g, w in zip(got["train_history"], jax_hist):
        assert abs(g - w) <= 1e-5 * max(1.0, abs(w))
    for k in ("test_elbo", "test_recon_mse"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])) \
            + 5e-5, k
    for k in want:
        if k.startswith("regime_acc_"):
            assert got[k] == want[k], k


# -- fixture_model_compare --------------------------------------------------


@pytest.mark.parametrize("K", [2, 3])
def test_fixture_compare_helpers_equal_jax(K):
    jfc = _jax_script("fixture_model_compare")
    rng = np.random.default_rng(K)
    pred, true = rng.integers(0, K, size=300), rng.integers(0, K, size=300)
    assert recipe._best_perm_acc(pred, true, K)[0] == \
        jfc.best_perm_accuracy(pred, true, K)
    assert fixture_model_compare.best_perm_balanced(pred, true, K) == \
        jfc.best_perm_balanced(pred, true, K)
    assert fixture_model_compare.switch_rate(pred) == jfc.switch_rate(pred)


def test_fixture_compare_main_writes_jax_keys(dirs, monkeypatch):
    """The port's run on the fixture (EM cut to 2 iterations) holds the keys of
    the committed JAX artifact, with the port's own VAE-HMM window rows
    from the outdir and JAX's beside them."""
    port, _ = dirs
    rows = {"regime_acc_viterbi": 0.9, "switch_rate_viterbi": 0.01}
    with open(os.path.join(port, "quality_fixture.json"), "w") as f:
        json.dump(rows, f)
    with open(os.path.join(port, "vq_quality_fixture.json"), "w") as f:
        json.dump({**rows, "codebook_usage": [1.0], "epochs": 1}, f)
    monkeypatch.setattr(fixture_model_compare, "EM_ITERS", 2)
    assert fixture_model_compare.main(["--device", "cpu", "--outdir",
                                       port]) == 0
    got = _json(port, "fixture_model_compare.json")
    want = _json(os.path.join(ROOT, "artifacts"),
                 "fixture_model_compare.json")
    assert set(got) >= set(want)
    assert got["days"] == want["days"] and got["K"] == want["K"]
    assert got["majority_share"] == want["majority_share"]
    assert got["switch_rate_ground_truth"] == \
        want["switch_rate_ground_truth"]
    assert got["vae_hmm_windows"] == rows
    assert got["vqvae_hmm_windows"] == {**rows, "codebook_usage": [1.0]}
    assert got["jax_artifact"]["fixture_model_compare"] == want


def test_fixture_gmm_on_jax_restarts_is_jax_fit():
    """The GMM row of fixture_model_compare on the whole fixture: from
    JAX's ten restarts the port's detector lands on JAX's fit (its
    log-likelihood within 1e-5 relative, the same decode); the port's own
    ten restarts reach a higher log-likelihood than JAX's fit."""
    from vqvaehmm_tpu.models import gmm as jgmm
    from vqvaehmm_tpu_torch.models import gmm

    returns, truth = fixture_model_compare.fixture_returns()
    feats = gmm.prepare_regime_features(returns.astype(np.float32))
    jd = jgmm.SimpleRegimeDetector(n_regimes=3, seed=0).fit(feats)
    own = gmm.SimpleRegimeDetector(n_regimes=3, seed=0, device="cpu")
    own.fit(feats)
    x = own._norm(feats)
    inits = jax.vmap(lambda k: jd.gmm._init_params(k, jnp.asarray(x)))(
        jax.random.split(jax.random.PRNGKey(0), 10))
    port = gmm.SimpleRegimeDetector(n_regimes=3, seed=0, device="cpu")
    port.feature_mu, port.feature_sd = own.feature_mu, own.feature_sd
    port.gmm.fit(x, init=[np.asarray(a) for a in inits])
    port.fitted = True
    assert port.gmm.log_likelihood_ == pytest.approx(
        jd.gmm.log_likelihood_, rel=1e-5)
    assert np.array_equal(port.predict_regime(feats),
                          np.asarray(jd.predict_regime(feats)))
    assert own.gmm.log_likelihood_ > jd.gmm.log_likelihood_


# -- the scripts that print their JSON --------------------------------------


def _literal_keys(name):
    """The string keys of the dict literals in the JAX script's main (its
    printed JSON)."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", f"{name}.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                   str)}
    return keys


def test_printed_json_scripts_write_jax_keys(tmp_path, monkeypatch):
    """quality_eval, vq_quality, quality_sweep (one cell) and
    ensemble_eval at 1-2 epochs on the CPU: each JSON holds the keys of
    the JAX script's printed dicts (and the device), its helpers equal
    JAX's on random inputs."""
    out = str(tmp_path)
    cpu = ["--device", "cpu", "--outdir", out]
    monkeypatch.setattr(quality_sweep, "CELLS", quality_sweep.CELLS[:1])
    monkeypatch.setattr(vq_quality, "EM_ITERS", 2)
    runs = {"quality_eval": (quality_eval, ["--epochs", "1"],
                             "quality_eval.json"),
            "vq_quality": (vq_quality, ["--epochs", "2"], "vq_quality.json"),
            "quality_sweep": (quality_sweep, ["--epochs", "1"],
                              "quality_sweep.json"),
            "ensemble_eval": (ensemble_eval, ["--seeds", "2", "--epochs",
                                              "1"], "ensemble_eval.json")}
    for name, (mod, args, fname) in runs.items():
        assert mod.main(cpu + args) == 0
        got = _json(out, fname)
        keys = set(got) | (set(got["cells"][0]) if "cells" in got else set())
        for v in got.values():
            if isinstance(v, dict):
                keys |= set(v)
        assert keys >= _literal_keys(name), (name, _literal_keys(name) - keys)
        assert got["backend"] == "cpu" and got["device"] == "cpu"
        json.dumps(got, allow_nan=False)
    rng = np.random.default_rng(0)
    pred, true = rng.integers(0, 3, size=(2, 50)), rng.integers(0, 3,
                                                                size=(2, 50))
    for name in ("quality_eval", "quality_sweep"):
        assert recipe._best_perm_acc(pred, true, 3)[0] == \
            _jax_script(name).best_perm_accuracy(pred, true, 3)
    assert quality_sweep.switches_per_100(pred) == \
        _jax_script("quality_sweep").switches_per_100(pred)


def test_reference_clis_write_their_files(tmp_path):
    """train --synthetic at 1 epoch and backtest --synthetic on the CPU: the JAX script's files (the .npz pair JAX's loaders read, the .pt
    twins) and a summary JSON of finite numbers."""
    from vqvaehmm_tpu.data.checkpoint import load_params_npz as jload
    from vqvaehmm_tpu_torch.data.checkpoint import load_state_dict_file

    out = str(tmp_path)
    cpu = ["--device", "cpu", "--outdir", out, "--synthetic"]
    assert train.main(cpu + ["--epochs", "1", "--port-epochs", "1"]) == 0
    assert set(jload(os.path.join(out, "portfolio.npz"))) == {"fc1", "fc2",
                                                              "fc3"}
    assert "encoder" in jload(os.path.join(out, "vae_hmm.npz"))
    assert set(load_state_dict_file(os.path.join(out, "portfolio.pt"))) == {
        f"net.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")}
    s = _json(out, "train_summary.json")
    assert np.isfinite([s["final_vae_loss"], s["final_portfolio_loss"]]).all()
    assert backtest.main(cpu + ["--n-sim", "8", "--n-days", "5"]) == 0
    b = _json(out, "backtest_summary.json")
    assert np.isfinite(list(b["monte_carlo"].values())).all()
    assert np.isfinite(list(b["equal_weight"].values())).all()
    json.dumps(b, allow_nan=False)


# -- refusals and imports ---------------------------------------------------


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__.split(".")[-1])
def test_cuda_without_a_card_raises(mod, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--device", "cuda", "--outdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_studies_import_no_jax_and_no_scripts():
    """A source scan of the subpackage, and its ten modules imported in a
    fresh interpreter: no JAX, no JAX package, no scripts/, no pandas
    (the card's machine has neither)."""
    pkg = os.path.join(ROOT, "vqvaehmm_tpu_torch", "scripts")
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        for node in ast.walk(ast.parse(open(os.path.join(pkg, name)).read())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""])
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in ("jax", "jaxlib", "vqvaehmm_tpu",
                                       "scripts", "optax", "pandas"), \
                        (name, m)
    code = ("import sys; "
            + "; ".join(f"import {m.__name__}" for m in MODULES)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'vqvaehmm_tpu', 'scripts', 'pandas')]; "
              "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
