"""The data and draws a run makes are the seed's: the same seed gives the
same, another seed another; every seed asks the same work."""

import numpy as np
import pytest
import torch

from portbench.harness import data
from portbench.harness.core import Context
from portbench.reference.vaehmm import Dims

D = Dims(C=5, U=4, H1=64, H2=32, K=3, HP=128)
BIG = 2 ** 31 + 12345


def test_sub_seeds_are_the_seeds():
    assert data.sub_seed(BIG, "pool") == data.sub_seed(BIG, "pool")
    assert data.sub_seed(BIG, "pool") != data.sub_seed(BIG, "weights")
    assert data.sub_seed(BIG, "pool") != data.sub_seed(BIG + 1, "pool")
    assert 0 <= data.sub_seed(2 ** 40, "x") < 2 ** 63


@pytest.mark.parametrize("seed", [0, BIG])
def test_panels_and_weights_repeat_by_seed(seed):
    def make(s):
        g = data.generator(torch, "cpu", s, "pool")
        x, u = data.regime_panels(torch, 6, 300, D.C, D.U, D.K, g)
        return x, u, data.make_weights(torch, D, s, "cpu")

    a, b, c = make(seed), make(seed), make(seed + 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[2]["encoder.conv1.weight"],
                           c[2]["encoder.conv1.weight"])


def test_panels_follow_the_sticky_chain():
    g = data.generator(torch, "cpu", 7, "pool")
    x, u = data.regime_panels(torch, 64, 2000, D.C, D.U, D.K, g,
                              stickiness=0.95)
    assert x.shape == (64, 5, 2000) and u.shape == (64, 4, 2000)
    # a step of u moves by about 0.2 sqrt(2) within a regime, by the gap
    # of two regimes' means at a switch: about 5% of steps jump
    jumps = ((u[:, :, 1:] - u[:, :, :-1]).abs().max(dim=1).values > 1.0)
    assert 0.02 < float(jumps.float().mean()) < 0.06


def test_weights_follow_torch_defaults():
    w = data.make_weights(torch, D, 3, "cpu")
    assert float(w["encoder.conv1.weight"].abs().max()) <= 15 ** -0.5
    assert float(w["decoder.conv1.weight"].abs().max()) <= 192 ** -0.5
    assert float(w["decoder.conv1.weight"].abs().max()) > 0.9 * 192 ** -0.5
    assert float(w["prior.log_prior"].abs().max()) == 0.0
    assert abs(float(w["decoder.embeddings.weight"].std()) - 1.0) < 0.2


def _loop(small, cell, seed):
    w = small.workload(cell)
    traffic = small.traffic(w["traffic"])
    ctx = Context(torch, torch.device("cpu"), seed, w,
                  small.config(w["config"]), traffic, small.cell(cell))
    return small.loop(traffic).Loop(ctx)


def test_books_repeat_by_seed_and_ask_the_same_work(small):
    a, b, c = (_loop(small, "f32.score-books", s) for s in (BIG, BIG,
                                                            BIG + 1))
    for (xa, ua, la), (xb, ub, lb) in zip(a.books, b.books):
        assert torch.equal(xa, xb) and torch.equal(ua, ub)
        assert torch.equal(la, lb)
    assert not torch.equal(a.books[0][0], c.books[0][0])
    # the same listed lengths in every book of every seed, in other orders
    for loop in (a, c):
        for _, _, ln in loop.books:
            assert sorted(ln.tolist()) == sorted(a.books[0][2].tolist())
    assert a.books[0][2].tolist() != c.books[0][2].tolist() \
        or a.books[1][2].tolist() != c.books[1][2].tolist()
    assert a.steps == c.steps
    # each panel is zero past its length
    x, _, ln = a.books[0]
    for row, n in enumerate(ln.tolist()):
        assert float(x[row, :, n:].abs().sum()) == 0.0


def test_training_draws_repeat_by_seed(small):
    a, b, c = (_loop(small, "f32.train-b1024", s) for s in (BIG, BIG,
                                                           BIG + 1))
    for (sa, ta, la), (sb, tb, lb) in zip(a.checked, b.checked):
        assert np.array_equal(sa, sb) and np.array_equal(ta, tb)
        assert np.array_equal(la, lb)
    assert not all(np.array_equal(x[2], y[2])
                   for x, y in zip(a.checked, c.checked))
    assert torch.equal(a.px, b.px) and not torch.equal(a.px, c.px)
    lo, hi = 20, 200
    for _, _, ln in a.checked:
        assert lo <= ln.min() and ln.max() <= hi


def test_stratified_lengths(small):
    loop_mod = small.loop(small.traffic("score-books"))
    lens = loop_mod.stratified_lengths(256, 252, 2327)
    assert lens[0] == 252 and lens[-1] == 2327 and len(set(lens)) == 256
    assert np.all(np.diff(lens) > 0)
