"""The port's recipe (python -m vqvaehmm_tpu_torch.recipe) on the fixture
panel with the quality checkpoint, --device cpu, against the JAX functions
that scripts/full_recipe.py calls, from the same inputs: the data stage's
files equal, the head stage's loss history within 1e-4 relative from the
same initial head, and the Monte Carlo statistics within 1e-5 on the same
draws.  Epoch and path counts are cut by setting the recipe's constants."""

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
