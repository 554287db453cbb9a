"""The port's public surface against the JAX package's: the top-level
exports, `make_model`, `data/market.py::load_portfolio_data` (the
committed fixture within 1e-9, the bar of tests/test_torch_market.py; the
synthetic fallback; the raise on a bad fixture), `create_dataloader` and
`DEFAULT_TICKERS`; and the recipe's quality checkpoint for a stage run
alone in a fresh outdir."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import vqvaehmm_tpu
import vqvaehmm_tpu_torch
from vqvaehmm_tpu.data import market as jax_market
from vqvaehmm_tpu_torch import recipe
from vqvaehmm_tpu_torch.data import market as port_market
from vqvaehmm_tpu_torch.data.checkpoint import (load_params_npz,
                                                params_from_numpy,
                                                save_params_npz)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "market_fixture.csv")
# the JAX package's functional trainer API, not ported by decision
NOT_PORTED = {"create_train_state", "make_train_step"}


def test_exports_are_jaxs():
    """Every top-level name of the JAX package but its functional trainer
    API, under the same names and in the same order, and __version__."""
    want = [n for n in vqvaehmm_tpu.__all__ if n not in NOT_PORTED]
    assert vqvaehmm_tpu_torch.__all__ == want
    assert all(hasattr(vqvaehmm_tpu_torch, n) for n in want)
    assert not any(hasattr(vqvaehmm_tpu_torch, n) for n in NOT_PORTED)
    assert vqvaehmm_tpu_torch.__version__ == vqvaehmm_tpu.__version__
    cfg = vqvaehmm_tpu_torch.MeshConfig()
    assert cfg.num_devices is None


@pytest.mark.parametrize("args,kw", [((), {}), ((5, 16, 3, 8, 4, 16), {}),
                                     ((7,), dict(K=4, compute_dtype="float32"))])
def test_make_model_matches_jax(args, kw):
    """make_model's positional order and keywords give JAX's configuration,
    and JAX's parameters load into it and give its forward within 1e-5."""
    jm = vqvaehmm_tpu.make_model(*args, **kw)
    tm = vqvaehmm_tpu_torch.make_model(*args, **kw)
    assert tm.cfg.__dict__ == jm.cfg.__dict__
    params = jm.init(jax.random.PRNGKey(0))
    tm.load_state_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    x = np.random.default_rng(0).normal(size=(2, tm.cfg.input_dim, 16)
                                        ).astype(np.float32)
    (jmu, jlv), jq = jm(params, x)
    with torch.no_grad():
        (mu, lv), q = tm(torch.from_numpy(x))
    for got, want in ((mu, jmu), (lv, jlv), (q, jq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("dates", [("2015-01-01", "2024-01-01"),
                                   ("2018", "2020-06"),
                                   ("2019-03-05", "2021-12-31")])
def test_load_portfolio_data_matches_jax(dates, monkeypatch):
    """The fixture through both pipelines, cut to the same dates (pandas'
    .loc slicing): the windows, returns and prices within 1e-9, the same
    dates and tickers; the fixture named by VQHMM_MARKET_FIXTURE the
    same."""
    kw = dict(start_date=dates[0], end_date=dates[1], log_fn=None)
    want = jax_market.load_portfolio_data(fixture_path=FIXTURE, **kw)
    monkeypatch.setenv("VQHMM_MARKET_FIXTURE", FIXTURE)
    got = port_market.load_portfolio_data(**kw)
    assert got["tickers"] == want["tickers"] == port_market.DEFAULT_TICKERS
    for key in ("x_sequences", "u_sequences"):
        assert got[key].dtype == np.float32
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=1e-9, rtol=0)
    for key in ("returns", "prices"):
        np.testing.assert_allclose(got[key].values, want[key].values,
                                   atol=1e-9, rtol=0)
        assert list(got[key].index) == [str(d)[:10]
                                        for d in want[key].index]


def test_fallback_and_refusals(tmp_path, monkeypatch):
    """Without a fixture: JAX's 32 synthetic windows of 100 steps (JAX
    falls back as its download fails here), or a raise under
    fallback_synthetic=False, as JAX's; a fixture that fails raises in
    both, never falling back."""
    monkeypatch.delenv("VQHMM_MARKET_FIXTURE", raising=False)
    want = jax_market.load_portfolio_data(log_fn=None)
    got = port_market.load_portfolio_data(log_fn=None)
    assert got["x_sequences"].shape == (32, 5, 100)
    for key in ("x_sequences", "u_sequences"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["returns"] is got["prices"] is want["returns"] is None
    with pytest.raises(Exception):
        jax_market.load_portfolio_data(fallback_synthetic=False, log_fn=None)
    with pytest.raises(RuntimeError, match="no market data"):
        port_market.load_portfolio_data(fallback_synthetic=False,
                                        log_fn=None)
    bad = tmp_path / "bad.csv"
    bad.write_text("Day,AAPL\n2020-01-01,1.0\n")
    for path in (str(bad), str(tmp_path / "missing.csv")):
        with pytest.raises(Exception):
            jax_market.load_portfolio_data(fixture_path=path, log_fn=None)
        with pytest.raises((OSError, ValueError)):
            port_market.load_portfolio_data(fixture_path=path, log_fn=None)


def test_create_dataloader_matches_jax():
    """create_dataloader: JAX's fixed-shape batches of one epoch (the
    draws are unseeded in both, so their count, shapes and dtypes)."""
    xs = np.random.default_rng(0).normal(size=(3, 5, 150)).astype(np.float32)
    us = np.random.default_rng(1).normal(size=(3, 4, 150)).astype(np.float32)
    got = list(port_market.create_dataloader(xs, us, batch_size=100))
    want = list(jax_market.create_dataloader(xs, us, batch_size=100))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert [(a.shape, a.dtype) for a in g] == \
            [(np.asarray(a).shape, np.asarray(a).dtype) for a in w]


def test_stage_alone_reads_the_outdirs_quality_checkpoint(tmp_path,
                                                          monkeypatch):
    """A downstream stage run alone in a fresh outdir reads the committed
    quality checkpoint; once the outdir holds its own (the quality stage
    wrote it), the stage reads that one, through load_trained with the
    recipe's own quality configuration; stage_log.json names the
    checkpoint each read."""
    read = []
    monkeypatch.setattr(recipe, "stage_head", lambda o, d, c: read.append(
        recipe.load_trained(d, c)))
    out = str(tmp_path)
    assert recipe.main(["--stage", "head", "--outdir", out,
                        "--device", "cpu"]) == 0
    committed = os.path.join(recipe.CHECKPOINT_DIR, "vae_hmm_trained.npz")
    with open(os.path.join(out, "stage_log.json")) as f:
        assert json.load(f)["head"]["checkpoint"] == committed
    own = os.path.join(out, "checkpoints_quality")
    os.makedirs(own)
    params = load_params_npz(committed)
    shifted = jax.tree_util.tree_map(lambda a: a + 0.5, params)
    save_params_npz(os.path.join(own, "vae_hmm_trained.npz"), shifted)
    assert recipe.main(["--stage", "head", "--outdir", out,
                        "--device", "cpu"]) == 0
    with open(os.path.join(out, "stage_log.json")) as f:
        assert json.load(f)["head"]["checkpoint"] == os.path.join(
            own, "vae_hmm_trained.npz")
    first, second = (dict(m.named_parameters()) for m in read)
    for name, p in first.items():
        assert torch.allclose(second[name], p + 0.5)
    assert read[1].cfg == recipe.recipe_config(out, quality=True).model
