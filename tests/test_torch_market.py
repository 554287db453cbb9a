"""The port's numpy feature recipe (vqvaehmm_tpu_torch/data/market.py)
against the JAX package's pandas recipe on the committed fixture panel:
the same rows, and x, u, returns and prices within 1e-9 (float64 on both
sides; pandas' rolling statistics are running sums, numpy's are per
window)."""

import os

import numpy as np
import pytest

from vqvaehmm_tpu.data import market as jax_market
from vqvaehmm_tpu_torch.data import market as port_market

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "market_fixture.csv")


@pytest.fixture(scope="module")
def both():
    jp, jr, jreg = jax_market.load_fixture_frames(FIXTURE)
    pp, pr, preg = port_market.load_fixture_frames(FIXTURE)
    return (jp, jr, jreg), (pp, pr, preg)


def test_fixture_frames_match_pandas(both):
    (jp, jr, jreg), (pp, pr, preg) = both
    assert list(jp.columns) == pp.columns and len(pp) == len(jp) == 2347
    assert list(jr.columns) == pr.columns == ["^VIX", "^TNX", "SPY"]
    np.testing.assert_array_equal(pp.values, jp.values)
    np.testing.assert_array_equal(pr.values, jr.values)
    np.testing.assert_array_equal(preg, jreg.values)
    assert [str(d)[:10] for d in jp.index[:3]] == list(pp.index[:3])
    np.testing.assert_array_equal(pr["SPY"], jr["SPY"].values)


def test_prepare_sequences_matches_pandas(both):
    (jp, jr, _), (pp, pr, _) = both
    jx, ju, jret, jprices = jax_market.prepare_sequences(jp, jr)
    x, u, ret, prices = port_market.prepare_sequences(pp, pr)
    assert x.shape == jx.shape == (2327, 5) and u.shape == ju.shape
    for got, want, name in ((x, jx, "x"), (u, ju, "u"),
                            (ret.values, jret.values, "returns"),
                            (prices.values, jprices.values, "prices")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                   err_msg=name)
    assert [str(d)[:10] for d in jprices.index] == list(prices.index)
    assert list(ret.index) == list(prices.index)
    xs, us = port_market.create_sequences(x, u)
    jxs, jus = jax_market.create_sequences(jx, ju)
    assert xs.shape == jxs.shape == (112, 100, 5)
    np.testing.assert_allclose(xs, jxs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(us, jus, rtol=0, atol=1e-9)


def test_recipe_with_missing_prices_matches_pandas(both):
    """A missing price drops its two return rows before the rolling
    windows run, as pandas' dropna does."""
    import pandas as pd

    (jp, jr, _), (pp, pr, _) = both
    n = 80
    jp2, jr2 = jp.iloc[:n].copy(), jr.iloc[:n].copy()
    jp2.iloc[30, 2] = np.nan
    vals = pp.values[:n].copy()
    vals[30, 2] = np.nan
    prices2 = port_market.Frame(pp.index[:n], pp.columns, vals)
    regime2 = pr.rows(np.arange(len(pr)) < n)
    jx, ju, jret, _ = jax_market.prepare_sequences(jp2, jr2)
    x, u, ret, _ = port_market.prepare_sequences(prices2, regime2)
    assert isinstance(jret, pd.DataFrame) and x.shape == jx.shape
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ret.values, jret.values, rtol=0, atol=1e-9)


def test_mismatched_index_and_short_panel():
    idx = np.array(["2020-01-01", "2020-01-02", "2020-01-03"])
    prices = port_market.Frame(idx, ["A"], np.array([[1.0], [2.0], [3.0]]))
    regime = port_market.Frame(idx[::-1].copy(), ["^VIX", "^TNX", "SPY"],
                               np.ones((3, 3)))
    with pytest.raises(ValueError, match="date index"):
        port_market.prepare_sequences(prices, regime)
    regime = port_market.Frame(idx, ["^VIX", "^TNX", "SPY"], np.ones((3, 3)))
    x, u, ret, kept = port_market.prepare_sequences(prices, regime)
    assert x.shape == (0, 5) and u.shape == (0, 4) and len(kept) == 0
