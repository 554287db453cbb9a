"""The port's recipe (python -m vqvaehmm_tpu_torch.recipe) on the fixture
panel with the quality checkpoint, --device cpu, against the JAX functions
that scripts/full_recipe.py calls, from the same inputs: the data stage's
files equal, the head stage's loss history within 1e-4 relative from the
same initial head, and the Monte Carlo statistics within 1e-5 on the same
draws; the train, quality, vq and eval stages against JAX's from JAX's
initial parameters, the report, --stage all and the SIGTERM exit.  Epoch
and path counts are cut by setting the recipe's constants."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqvaehmm_tpu_torch.backtest.montecarlo as tmc
from tests.torch_port import jax_mc_draws, t
from vqvaehmm_tpu import VAEHMM as JVAEHMM
from vqvaehmm_tpu.backtest import montecarlo as jmc
from vqvaehmm_tpu.core.config import load_config as jload_config
from vqvaehmm_tpu.data.checkpoint import load_params_npz as jload_npz
from vqvaehmm_tpu.models.portfolio import HeadConfig as JHeadConfig
from vqvaehmm_tpu.models.portfolio import \
    ImprovedPortfolioOptimizer as JImproved
from vqvaehmm_tpu.train.heads import train_portfolio_fused as jfused
from vqvaehmm_tpu_torch import recipe
from vqvaehmm_tpu_torch.data.checkpoint import (head_params_to_numpy,
                                                load_improved_head)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
CPU = torch.device("cpu")


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "full_recipe", os.path.join(ROOT, "scripts", "full_recipe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The data stage of both recipes, each in its own directory."""
    port, jax_dir = (str(tmp_path_factory.mktemp(n)) for n in ("port", "jax"))
    recipe.stage_data(port)
    _jax_recipe().stage_data(jax_dir)
    return port, jax_dir


@pytest.fixture(scope="module")
def jax_model():
    model = JVAEHMM(jload_config(recipe.CONFIG).model)
    params = jload_npz(os.path.join(recipe.CHECKPOINT_DIR,
                                    "vae_hmm_trained.npz"))
    return model, params


@pytest.fixture(scope="module")
def head_run(dirs):
    """The port's head stage, cut to EPOCHS epochs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(recipe, "HEAD_EPOCHS", EPOCHS)
    try:
        return recipe.stage_head(dirs[0], CPU)
    finally:
        mp.undo()


def test_data_stage_writes_what_the_jax_recipe_writes(dirs):
    import pandas as pd

    from vqvaehmm_tpu_torch.data import market

    _, _, returns, prices = market.prepare_sequences(
        *market.load_fixture_frames(recipe.FIXTURE)[:2])
    exact = {"returns.csv": returns.values, "prices.csv": prices.values}
    port, jax_dir = (os.path.join(d, "data") for d in dirs)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for name in sorted(os.listdir(jax_dir)):
        a, b = (os.path.join(d, name) for d in (port, jax_dir))
        if name.endswith(".npy"):
            got, want = np.load(a), np.load(b)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            got, want = (pd.read_csv(p, index_col=0) for p in (a, b))
            assert list(got.columns) == list(want.columns), name
            assert list(got.index) == list(want.index), name
            assert np.array_equal(got.values, want.values), name
            # the port reads its CSVs back exactly; pandas' default parser
            # is not correctly rounded, so the JAX recipe reads values that
            # differ from those written by up to 1e-12 relative, and not at
            # all in float32
            ours = recipe._read_values(a)
            assert np.array_equal(ours, exact[name]), name
            np.testing.assert_allclose(ours, want.values, rtol=1e-11, atol=0,
                                       err_msg=name)
            assert np.array_equal(ours.astype(np.float32),
                                  want.values.astype(np.float32)), name


def test_head_stage_matches_jax(dirs, jax_model, head_run):
    """The port's head stage against JAX's train_portfolio_fused on JAX's
    own batches (equal to the port's) from the port's initial head."""
    port, jax_dir = dirs
    batches, rets = recipe.head_batches(port)
    jb, jr = _jax_recipe()._head_batches(jax_dir)
    assert len(batches) == len(jb) > 0
    for (x, u, ln), (jx, ju, jln), r, jrr in zip(batches, jb, rets, jr):
        for a, b in ((x, jx), (u, ju), (ln, jln), (r, jrr)):
            assert np.array_equal(a, b)
    start = head_params_to_numpy(recipe.initial_head(CPU).state_dict())
    model, params = jax_model
    want = jfused(JImproved(JHeadConfig(K=3, n_assets=10, hidden_dim=64)),
                  start, model, params, jb, jr, num_epochs=EPOCHS,
                  lr=recipe.HEAD_LR)
    assert len(head_run.history) == EPOCHS
    np.testing.assert_allclose(head_run.history, want.history, rtol=1e-4,
                               atol=0)
    got = head_params_to_numpy(head_run.params)
    for layer in got:
        for leaf in got[layer]:
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(want.params[layer][leaf]),
                                       rtol=0, atol=1e-4)
    with open(os.path.join(port, "head_history.json")) as f:
        assert json.load(f) == {"loss": head_run.history}


def test_written_head_loads_back_bit_for_bit(dirs, head_run):
    path = os.path.join(dirs[0], "portfolio_head.npz")
    head = load_improved_head(path, device="cpu")
    assert not head.training
    for k, v in head.state_dict().items():
        assert torch.equal(v, head_run.params[k]), k
    tree = jload_npz(path)
    for k, v in head_run.params.items():
        layer, leaf = k.split(".")
        assert tree[layer][leaf].dtype == np.float32
        assert np.array_equal(tree[layer][leaf], v.numpy()), k


def test_montecarlo_stage_on_jax_draws(dirs, jax_model, head_run,
                                       monkeypatch):
    """The stage's Viterbi decode equals JAX's, and on the draws JAX's
    simulation makes from the same seed, its statistics are JAX's within
    1e-5."""
    port, jax_dir = dirs
    n_sim, n_days = 64, 40
    draws = jax_mc_draws(jax.random.PRNGKey(recipe.MC_SEED), 3, 10, n_sim,
                         n_days)
    monkeypatch.setattr(recipe, "MC_PATHS", n_sim)
    monkeypatch.setattr(recipe, "MC_DAYS", n_days)
    monkeypatch.setattr(tmc, "monte_carlo_draws",
                        lambda *a, **k: {n: t(v) for n, v in draws.items()})
    decoded = []
    real_stats = tmc.regime_statistics

    def spy(rets, regimes, K):
        decoded.append(regimes)
        return real_stats(rets, regimes, K)

    monkeypatch.setattr(tmc, "regime_statistics", spy)
    with pytest.warns(UserWarning, match="regime 2 has only"):
        mc, stats = recipe.stage_montecarlo(port, CPU)

    model, params = jax_model
    x = jnp.asarray(np.transpose(np.load(os.path.join(
        jax_dir, "data", "x_panel.npy")))[None])
    u = jnp.asarray(np.transpose(np.load(os.path.join(
        jax_dir, "data", "u_panel.npy")))[None])
    regimes = np.asarray(model.viterbi_decode(params, x, u))[0]
    assert np.array_equal(decoded[0], regimes)
    import pandas as pd
    rets = pd.read_csv(os.path.join(jax_dir, "data", "returns.csv"),
                       index_col=0).values
    with pytest.warns(UserWarning, match="regime 2 has only"):
        means, covs = jmc.regime_statistics(rets.astype(np.float32),
                                            regimes, K=3)
    head = JImproved(JHeadConfig(K=3, n_assets=10, hidden_dim=64))
    hp = jload_npz(os.path.join(port, "portfolio_head.npz"))
    want = jmc.monte_carlo_simulation(lambda oh: head(hp, oh[None])[0],
                                      means, covs,
                                      jax.random.PRNGKey(recipe.MC_SEED),
                                      n_sim=n_sim, n_days=n_days)
    np.testing.assert_allclose(mc["final_values"].numpy(),
                               np.asarray(want["final_values"]), rtol=1e-5)
    want_stats = jmc.analyze_monte_carlo(want)
    assert stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        assert abs(stats[k] - v) <= 1e-5, (k, stats[k], v)
    with open(os.path.join(port, "monte_carlo_stats.json")) as f:
        assert json.load(f) == stats


def test_backtest_and_walkforward_stages(dirs, head_run, monkeypatch):
    """The stages in between run on the CPU and write their files: the
    walk-forward retrains the head on each of its 16 windows."""
    port = dirs[0]
    monkeypatch.setattr(recipe, "WF_EPOCHS", 2)
    calls = []
    real = recipe.train_portfolio_fused

    def counting(*args, **kw):
        calls.append(kw["num_epochs"])
        return real(*args, **kw)

    monkeypatch.setattr(recipe, "train_portfolio_fused", counting)
    bt = recipe.stage_backtest(port, CPU)
    assert set(bt) == {"regime_portfolio", "equal_weight"}
    assert all(np.isfinite(v) for m in bt.values() for v in m.values())
    wf = recipe.stage_walkforward(port, CPU)
    assert wf["walk_forward"]["n_windows"] == 16 and calls == [2] * 16
    assert set(wf["per_regime"]) == {"argmax", "viterbi"}
    assert wf["crash_cost"]["n_crash_days"] > 0
    for name in ("backtest_metrics.json", "walkforward_metrics.json"):
        assert os.path.exists(os.path.join(port, name))


def test_main_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recipe.main(["--stage", "data", "--device", "cuda",
                     "--outdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_recipe_imports_no_jax_and_no_pandas():
    """The card's machine has neither: the recipe and the modules of its
    stages load without them."""
    import subprocess
    import sys

    code = ("import sys; import vqvaehmm_tpu_torch.recipe; "
            "import vqvaehmm_tpu_torch.train.heads; "
            "import vqvaehmm_tpu_torch.models.hedging; "
            "import vqvaehmm_tpu_torch.losses; "
            "import vqvaehmm_tpu_torch.backtest.montecarlo; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vqvaehmm_tpu', 'pandas')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the training, quality, VQ, eval and report stages ---------------------

TRAIN_CUT = 1          # epochs of the train and quality stages in the tests
VQ_CUT = "1"           # VQHMM_VQ_EPOCHS, the JAX recipe's own knob
EM_CUT = 10            # the code-HMM's EM iterations (50 in the recipe)
MODES = ("meanfield_argmax", "smoothed_argmax", "viterbi")


def _jax_vq_draws(jcfg):
    """What JAX's train_vq_stack draws inside: the initial VQ parameters
    and the EM restarts' starting points (tests/test_torch_vq_pipeline.py)."""
    from vqvaehmm_tpu.train import vq_pipeline as jvq

    seed, K, V = jcfg.training.seed, jcfg.model.K, jcfg.vq.num_codes
    init = jvq.make_vq_model(jcfg).init(jax.random.PRNGKey(seed))
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(seed),
                                jcfg.vq.hmm_restarts):
        k1, k2, k3 = jax.random.split(key, 3)
        draws.append((
            jnp.log(jax.random.dirichlet(k1, jnp.ones(K))),
            jnp.log(jax.random.dirichlet(k2, jnp.full(K, 2.0), shape=(K,))),
            jnp.log(jax.random.dirichlet(k3, jnp.ones(V), shape=(K,)))))
    em_init = tuple(np.stack([np.asarray(d[i]) for d in draws])
                    for i in range(3))
    return jax.tree_util.tree_map(np.asarray, init), em_init


@pytest.fixture(scope="module")
def trained(dirs):
    """The train, quality, vq and eval stages of both recipes on their
    data stage's windows, epochs cut (TRAIN_EPOCHS and QUALITY_EPOCHS in
    the port, _recipe_config's in JAX's, VQHMM_VQ_EPOCHS in both; the
    code-HMM's EM iterations cut in both configurations), each
    training run of the port starting from the parameters (and EM
    restarts) that JAX draws inside, both sampling with numpy."""
    import dataclasses
    import functools

    import vqvaehmm_tpu.core.config as jconfig

    import vqvaehmm_tpu.data.dataset as jds
    import vqvaehmm_tpu_torch.train.vq_pipeline as tvq
    from vqvaehmm_tpu.core.config import config_from_dict
    from vqvaehmm_tpu_torch.core.config import config_to_dict
    from vqvaehmm_tpu_torch.data.checkpoint import (params_from_numpy,
                                                    vq_params_from_numpy)
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    port, jax_dir = dirs
    jr = _jax_recipe()
    real_cfg, real_vq = jr._recipe_config, tvq.train_vq_stack
    mp = pytest.MonkeyPatch()
    mp.setattr(jds, "_fastdata", None)
    mp.setenv("VQHMM_VQ_EPOCHS", VQ_CUT)
    mp.setattr(recipe, "TRAIN_EPOCHS", TRAIN_CUT)
    mp.setattr(recipe, "QUALITY_EPOCHS", TRAIN_CUT)
    # fewer EM iterations in both (the port's EM is a Python loop over T)
    mp.setattr(recipe, "VQConfig", functools.partial(recipe.VQConfig,
                                                     hmm_iters=EM_CUT))
    mp.setattr(jconfig, "VQConfig", functools.partial(jconfig.VQConfig,
                                                      hmm_iters=EM_CUT))
    mp.setattr(jr, "_recipe_config", lambda outdir, quality=False:
               dataclasses.replace(real_cfg(outdir, quality),
                                   training=dataclasses.replace(
                                       real_cfg(outdir, quality).training,
                                       num_epochs=TRAIN_CUT)))

    def jax_init(self):
        model = recipe.VAEHMM(self.cfg.model, device=self.device)
        jm = JVAEHMM(config_from_dict(config_to_dict(self.cfg)).model)
        model.load_state_dict(params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(self.cfg.training.seed)))))
        return model

    def vq_with_jax_draws(cfg, dataset, **kw):
        init, em_init = _jax_vq_draws(config_from_dict(config_to_dict(cfg)))
        return real_vq(cfg, dataset, init_state=vq_params_from_numpy(init),
                       em_init=em_init, **kw)

    mp.setattr(TrainPipeline, "build_model", jax_init)
    mp.setattr(tvq, "train_vq_stack", vq_with_jax_draws)
    try:
        out = {}
        for stage in ("train", "quality", "vq", "eval"):
            out[stage] = getattr(recipe, "stage_" + stage)(port, CPU)
            getattr(jr, "stage_" + stage)(jax_dir)
        return out
    finally:
        mp.undo()


def _json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("tag", ["published", "quality"])
def test_training_stages_match_jax(dirs, trained, tag):
    """config_{tag}.json equal to JAX's; the history (full precision in the
    port, JAX's read back from its 4-decimal log lines) within 1e-4
    relative (floor 1) plus JAX's half unit of rounding; the .npz holds
    JAX's paths and agrees with JAX's trained parameters within 1e-4."""
    port, jax_dir = dirs
    assert _json(port, f"config_{tag}.json")["training"] == {
        **_json(jax_dir, f"config_{tag}.json")["training"],
        "checkpoint_dir": os.path.join(port, f"checkpoints_{tag}")}
    got = _json(port, f"train_history_{tag}.json")
    want = _json(jax_dir, f"train_history_{tag}.json")
    assert sorted(got) == sorted(want)
    assert (got["epochs"], got["lr"]) == (want["epochs"], want["lr"])
    assert len(got["loss"]) == len(want["loss"]) == TRAIN_CUT
    for g, w in zip(got["loss"], want["loss"]):
        assert abs(g - w) <= 1e-4 * max(1.0, abs(w)) + 5e-5, (g, w)
    a = jload_npz(os.path.join(port, f"checkpoints_{tag}",
                               "vae_hmm_trained.npz"))
    b = jload_npz(os.path.join(jax_dir, f"checkpoints_{tag}",
                               "vae_hmm_trained.npz"))
    flat_a, tree_a = jax.tree_util.tree_flatten(a)
    flat_b, tree_b = jax.tree_util.tree_flatten(b)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)


def test_reference_pt_round_trips_through_jax_loader(dirs, trained):
    """checkpoints_*/vae_hmm.pt read by the JAX package's torch_interop
    loader gives the port's trained arrays bit for bit."""
    from vqvaehmm_tpu.utils.torch_interop import (
        load_torch_file, vae_hmm_params_from_state_dict)

    for tag in ("published", "quality"):
        ck = os.path.join(dirs[0], f"checkpoints_{tag}")
        got = vae_hmm_params_from_state_dict(load_torch_file(
            os.path.join(ck, "vae_hmm.pt")))
        want = jload_npz(os.path.join(ck, "vae_hmm_trained.npz"))
        flat_g, tree_g = jax.tree_util.tree_flatten(got)
        flat_w, tree_w = jax.tree_util.tree_flatten(want)
        assert tree_g == tree_w
        for x, y in zip(flat_g, flat_w):
            assert x.dtype == np.float32 and np.array_equal(x, y)


def _jax_decodes(jax_dir, tag, meanfield=True):
    model = JVAEHMM(jload_config(os.path.join(jax_dir, f"config_{tag}.json"))
                    .model)
    params = jload_npz(os.path.join(jax_dir, f"checkpoints_{tag}",
                                    "vae_hmm_trained.npz"))
    x = jnp.asarray(np.load(os.path.join(jax_dir, "data", "x_sequences.npy")))
    u = jnp.asarray(np.load(os.path.join(jax_dir, "data", "u_sequences.npy")))
    out = {}
    if meanfield:
        out["meanfield_argmax"] = np.asarray(model.posterior(params, x)) \
            .argmax(1)
    out["smoothed_argmax"] = np.asarray(
        model.smoothed_posterior(params, x, u)).argmax(1)
    out["viterbi"] = np.asarray(model.viterbi_decode(params, x, u))
    return out


def _same_scores(got, want, ours, theirs):
    """Keys equal; each decode's accuracies and switch rate equal where
    the two decode the same states (all three decodes must here)."""
    assert list(got) == list(want)
    for mode, states in theirs.items():
        assert np.array_equal(ours[mode], states), mode
        for key in want:
            if key.endswith(mode):
                assert got[key] == want[key], key
    for key in want:
        if not key.endswith(tuple(MODES)):
            assert got[key] == want[key], key


def test_quality_stage_matches_jax(dirs, trained):
    port, jax_dir = dirs
    x = np.load(os.path.join(port, "data", "x_sequences.npy"))
    u = np.load(os.path.join(port, "data", "u_sequences.npy"))
    got = _json(port, "quality_fixture.json")
    assert got == trained["quality"]
    _same_scores(got, _json(jax_dir, "quality_fixture.json"),
                 recipe._decodes(recipe.recipe_model(port, CPU), x, u, CPU),
                 _jax_decodes(jax_dir, "quality"))
    _same_scores(_json(port, "quality_fixture_published.json"),
                 _json(jax_dir, "quality_fixture_published.json"),
                 recipe._decodes(recipe.recipe_model(port, CPU, False), x, u,
                                 CPU, meanfield=False),
                 _jax_decodes(jax_dir, "published", meanfield=False))


def test_vq_stage_matches_jax(dirs, trained):
    """Through TrainPipeline's vqvae branch on both sides: the same keys,
    epochs and final loss, the archive's history within 1e-4 relative,
    and the codebook usage, accuracies and switch rates equal where the
    codes and decodes are."""
    from vqvaehmm_tpu.train.vq_pipeline import VQStack as JStack
    from vqvaehmm_tpu_torch.train.vq_pipeline import VQStack

    port, jax_dir = dirs
    got = _json(port, "vq_quality_fixture.json")
    want = _json(jax_dir, "vq_quality_fixture.json")
    assert got == trained["vq"] and list(got) == list(want)
    assert got["epochs"] == want["epochs"] == int(VQ_CUT)
    assert got["final_vq_loss"] == want["final_vq_loss"]
    stack = VQStack.load(os.path.join(port, "checkpoints_vq", "vq_stack.npz"),
                         device=CPU)
    jstack = JStack.load(os.path.join(jax_dir, "checkpoints_vq",
                                      "vq_stack.npz"))
    np.testing.assert_allclose(stack.history, jstack.history, rtol=1e-4)
    x = np.load(os.path.join(port, "data", "x_sequences.npy"))
    lens = np.full(len(x), x.shape[2], np.int32)
    with torch.inference_mode():
        codes = stack.codes(t(x)).numpy()
        ours = {"smoothed_argmax": stack.regime_marginals(
                    t(x), torch.from_numpy(lens)).argmax(-1).numpy(),
                "viterbi": stack.viterbi(t(x), torch.from_numpy(lens))
                .numpy()}
    assert np.array_equal(codes, np.asarray(jstack.codes(jnp.asarray(x))))
    theirs = {"smoothed_argmax": np.asarray(jstack.regime_marginals(
                  jnp.asarray(x), jnp.asarray(lens))).argmax(-1),
              "viterbi": np.asarray(jstack.viterbi(jnp.asarray(x),
                                                   jnp.asarray(lens)))}
    assert got["codebook_usage"] == want["codebook_usage"]
    _same_scores({k: v for k, v in got.items()
                  if k.startswith(("regime_", "switch_"))},
                 {k: v for k, v in want.items()
                  if k.startswith(("regime_", "switch_"))}, ours, theirs)


def test_eval_stage_matches_jax(dirs, trained):
    port, jax_dir = dirs
    assert sorted(trained["eval"]) == ["published", "quality"]
    for tag, mse in trained["eval"].items():
        with open(os.path.join(jax_dir, f"eval_results_{tag}.txt")) as f:
            want = float(f.read().split(":")[1])
        with open(os.path.join(port, f"eval_results_{tag}.txt")) as f:
            assert float(f.read().split(":")[1]) == mse
        assert abs(mse - want) <= 1e-4 * want, (tag, mse, want)


def test_report_names_the_device_and_no_tpu(dirs, trained):
    """RECIPE_REPORT.md from the outdir's files alone: the stage log's
    device and power limit, the training and quality numbers, and no
    "TPU"."""
    port = dirs[0]
    for s in ("train", "quality", "vq", "eval"):
        recipe._log_stage(port, s, 1.5, CPU)
    path = recipe.stage_report(port)
    with open(path) as f:
        text = f.read()
    assert "TPU" not in text
    assert "every stage below ran on the host CPU" in text
    assert str(_json(port, "train_history_quality.json")["loss"][-1]) in text
    assert f"| vq | cpu | cpu | - | 1.5 |" in text
    log = _json(port, "stage_log.json")
    assert log["train"]["power_limit"] is None


def test_stage_all_reads_its_own_quality_checkpoint(tmp_path, monkeypatch):
    """--stage all runs JAX's ten stages in JAX's order, the downstream
    ones on this run's <outdir>/checkpoints_quality (which its quality
    stage wrote); a stage alone reads that checkpoint too, as JAX's
    recipe does, and --checkpoint-dir overrides it."""
    calls = []
    own = os.path.join(str(tmp_path), "checkpoints_quality")

    def stage(o, d, c, s):
        calls.append((s, c))
        if s == "quality":
            os.makedirs(own, exist_ok=True)
            open(os.path.join(own, "vae_hmm_trained.npz"), "w").close()

    for s in recipe.STAGES:
        monkeypatch.setattr(recipe, "stage_" + s,
                            lambda o, d, c, s=s: stage(o, d, c, s))
    monkeypatch.setattr(recipe, "_log_stage", lambda *a: None)
    out = str(tmp_path)
    assert recipe.main(["--stage", "all", "--outdir", out,
                        "--device", "cpu"]) == 0
    assert [s for s, _ in calls] == _jax_recipe().STAGES
    assert all(c == own for s, c in calls if s in recipe.READS_CHECKPOINT)
    calls.clear()
    recipe.main(["--stage", "head", "--outdir", out, "--device", "cpu"])
    recipe.main(["--stage", "backtest", "--outdir", out, "--device", "cpu",
                 "--checkpoint-dir", "elsewhere"])
    assert calls == [("head", own), ("backtest", "elsewhere")]


@pytest.mark.parametrize("history", [None, []])
def test_training_stage_after_sigterm_and_after_a_finished_run(
        tmp_path, monkeypatch, history):
    """A run stopped by SIGTERM exits 75 and publishes nothing; an
    auto-resume of a finished run (no epoch left) refreshes vae_hmm.pt
    and leaves the history file alone."""
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    out = str(tmp_path)
    hist_path = os.path.join(out, "train_history_published.json")
    with open(hist_path, "w") as f:
        f.write("{}")

    class Stopped(TrainPipeline):
        def train(self, log_fn=print, resume=True):
            model = self.build_model()
            self.preempted, self.history = history is None, history or []
            return type("S", (), {"model": model})()

    monkeypatch.setattr(recipe, "TrainPipeline", Stopped)
    pt = os.path.join(out, "checkpoints_published", "vae_hmm.pt")
    os.makedirs(os.path.dirname(pt))
    if history is None:
        with pytest.raises(SystemExit) as stop:
            recipe.stage_train(out, CPU)
        assert stop.value.code == 75 and not os.path.exists(pt)
    else:
        recipe.stage_train(out, CPU)
        assert os.path.exists(pt)
    with open(hist_path) as f:
        assert f.read() == "{}"
