"""The port's examples (vqvaehmm_tpu_torch/examples/) and notebooks
(notebooks/*_torch.ipynb) on the CPU, against the JAX package's examples/
and notebooks/.

Each example's run(device="cpu") at the example's own widths and data,
from JAX's initial parameters (carried across by data/checkpoint.py's
converters) and JAX's draws, against the JAX example's main() run in this
process with the JAX calls it makes wrapped to record their results:
- deterministic outputs (a backtest's metrics, the walk-forward windows,
  the Monte Carlo summary, the stream's posteriors) within 1e-4;
- a training's first epoch or step within 1e-5 relative; later epochs of
  the training at lr 1e-3 are chaotic (ROADMAP "The quality run at lr
  1e-3 is chaotic") and are held only to be finite; the two trainings of
  train_example are cut to 1 epoch each, in both packages, to keep the
  test short;
- calibration_example's output equal to JAX's, character for character.
Each notebook has JAX's code cells and picks "cuda" where there is a card
(tests/test_notebooks.py runs its cells on the CPU); the examples refuse
--device cuda without a card; nothing under examples/ and
no *_torch.ipynb imports JAX or the JAX package."""

import ast
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import jax_em_draws, jax_mc_draws
from vqvaehmm_tpu_torch.data.checkpoint import (params_from_numpy,
                                                vq_params_from_numpy)
from vqvaehmm_tpu_torch.examples import (backtest_example,
                                         calibration_example,
                                         device_pipeline_example,
                                         streaming_example, train_example,
                                         vqvae_example)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [train_example, backtest_example, calibration_example,
            device_pipeline_example, streaming_example, vqvae_example]
NOTEBOOKS = ["visualize", "vqvaehmm_walkthrough"]


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def test_train_example_first_epoch_follows_jax(monkeypatch):
    import vqvaehmm_tpu as vt
    import vqvaehmm_tpu.data.dataset as jds
    from vqvaehmm_tpu.models import HeadConfig as JHeadConfig
    from vqvaehmm_tpu.models import RegimePortfolioOptimizer as JHead

    jex = _jax_example("train_example")
    seen = {}
    real_train, real_head = vt.train_model, jex.train_portfolio_optimizer

    def train(model, dataset, num_epochs, **kw):
        seen["init"] = _np(model.init(jax.random.PRNGKey(0)))
        state, hist = real_train(model, dataset, num_epochs=1, **kw)
        seen["history"] = [float(h) for h in hist]
        return state, hist

    def head(*a, num_epochs, **kw):
        result = real_head(*a, num_epochs=1, **kw)
        seen["head_history"] = [float(h) for h in result.history]
        return result

    # the numpy sample stream on the JAX side too (its C sampler, where it
    # is built, draws another)
    monkeypatch.setattr(jds, "_fastdata", None)
    monkeypatch.setattr(vt, "train_model", train)
    monkeypatch.setattr(jex, "train_portfolio_optimizer", head)
    jex.main()
    head_init = _np(JHead(JHeadConfig(K=3, n_assets=10)).init(
        jax.random.PRNGKey(1)))
    got = train_example.run("cpu", init=params_from_numpy(seen["init"]),
                            head_init=params_from_numpy(head_init),
                            epochs=1, head_epochs=1, log_fn=None)
    assert _rel(got["history"][0], seen["history"][0]) <= 1e-5
    assert np.isfinite(got["history"]).all()
    assert np.isfinite(got["head_history"]).all()
    w = got["allocation"]
    assert w.shape == (10,) and np.isfinite(w).all()
    assert abs(float(w.sum()) - 1.0) <= 1e-5


def test_backtest_example_matches_jax(monkeypatch):
    import vqvaehmm_tpu.backtest as jbt
    from vqvaehmm_tpu import make_model as jmake
    from vqvaehmm_tpu.models import HeadConfig as JHeadConfig
    from vqvaehmm_tpu.models import RegimePortfolioOptimizer as JHead
    from vqvaehmm_tpu_torch.backtest import montecarlo

    jex = _jax_example("backtest_example")
    seen = {}

    def record(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(name, out)
            return out
        return wrapped

    monkeypatch.setattr(jex.Backtester, "run",
                        record("bt", jex.Backtester.run))
    monkeypatch.setattr(jex.WalkForwardBacktest, "run",
                        record("wf", jex.WalkForwardBacktest.run))
    monkeypatch.setattr(jex, "analyze_monte_carlo",
                        record("mc", jbt.analyze_monte_carlo))
    jex.main()
    init = _np(jmake(5, 16, 3, 8, u_dim=4, trans_hidden=16).init(
        jax.random.PRNGKey(0)))
    head = _np(JHead(JHeadConfig(K=3, n_assets=10)).init(
        jax.random.PRNGKey(1)))
    draws = jax_mc_draws(jax.random.PRNGKey(2), 3, 10, 200, 126)
    monkeypatch.setattr(montecarlo, "monte_carlo_draws",
                        lambda *a, **k: {k: torch.from_numpy(v)
                                         for k, v in draws.items()})
    got = backtest_example.run("cpu", init=params_from_numpy(init),
                               head_init=params_from_numpy(head))
    for k, v in seen["bt"].metrics.items():
        assert abs(got["metrics"][k] - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), k
    assert got["walk_forward_windows"] == len(seen["wf"])
    for k, v in seen["mc"].items():
        assert abs(got["monte_carlo"][k] - float(v)) <= 1e-4, k


def test_calibration_example_prints_what_jax_prints(capsys):
    _jax_example("calibration_example").main()
    want = capsys.readouterr().out
    assert calibration_example.main([]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("\n") > 10


def _losses(text):
    return [float(m) for m in re.findall(r"loss (-?\d+\.\d+)", text)]


def test_device_pipeline_example_matches_jax(capsys):
    from vqvaehmm_tpu import make_model as jmake

    _jax_example("device_pipeline_example").main()
    want = capsys.readouterr().out
    init = _np(jmake(5, 8, 3, 4, u_dim=4, trans_hidden=8).init(
        jax.random.PRNGKey(0)))
    got = device_pipeline_example.run("cpu", init=params_from_numpy(init))
    # one epoch of 4 steps each, printed to 6 places by JAX
    for g, w in zip((got["host"], got["device"], got["gather_in_step"]),
                    _losses(want)):
        assert abs(g - w) <= 1e-5 * max(1.0, abs(w)) + 5e-7
    assert got["same"] and "matches host path: True" in want


def test_streaming_example_matches_jax(monkeypatch, capsys):
    import vqvaehmm_tpu.models.online as jonline
    from vqvaehmm_tpu import make_model as jmake

    jex = _jax_example("streaming_example")
    seen = {"settled": [], "peek": [], "end": []}

    class Recording(jonline.OnlineFilter):
        def update(self, x_t, u_t):
            out = super().update(x_t, u_t)
            seen["settled"] += [np.asarray(q) for _, q in out]
            return out

        def peek(self):
            q = super().peek()
            seen["peek"].append(np.asarray(q))
            return q

        def finish(self):
            out = super().finish()
            seen["end"] += [np.asarray(q) for _, q in out]
            return out

    monkeypatch.setattr(jex, "OnlineFilter", Recording)
    jex.main()
    assert "matches batch filtered_posterior: True" in capsys.readouterr().out
    init = _np(jmake(5, 32, 3, 16, u_dim=4, trans_hidden=32).init(
        jax.random.PRNGKey(0)))
    got = streaming_example.run("cpu", init=params_from_numpy(init),
                                log_fn=None)
    settled = [q for _, _, q, _ in got["ticks"]]
    assert len(settled) == len(seen["settled"]) == 58
    np.testing.assert_allclose(settled, seen["settled"], rtol=0, atol=1e-4)
    np.testing.assert_allclose([q for _, q in got["end"]], seen["end"],
                               rtol=0, atol=1e-4)
    # peeks are taken every tick; those of the ticks that settle a column
    np.testing.assert_allclose([p for _, _, _, p in got["ticks"]],
                               seen["peek"][2:], rtol=0, atol=1e-4)
    assert got["matches"]


def test_vqvae_example_follows_jax(monkeypatch, capsys):
    import vqvaehmm_tpu.models.vqvae_hmm as jvq
    from vqvaehmm_tpu.data.synthetic import synthetic_sequences
    from vqvaehmm_tpu_torch.models import vqvae_hmm

    jex = _jax_example("vqvae_example")
    jex.main()
    want = capsys.readouterr().out
    cfg = jvq.VQVAEConfig(input_dim=5, hidden_dim=32, hidden_dim2=16,
                          num_codes=4, latent_dim=8)
    jm = jvq.VQVAEHMM(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    xs, _, _ = synthetic_sequences(8, 128, seed=0, stickiness=0.96)
    lengths = jnp.full((8,), 128, jnp.int32)
    first = float(jm.compute_loss(params, jnp.asarray(xs), lengths).total)
    real_em = vqvae_hmm.fit_categorical_em
    seen = {}

    def em(codes, K, V, n_iters, seed, lengths):
        seen["codes"] = codes.numpy()
        return real_em(codes, K, V, n_iters, seed, lengths,
                       init=jax_em_draws(seed, 4, K, V))

    monkeypatch.setattr(vqvae_hmm, "fit_categorical_em",
                        lambda codes, K, V, n_iters, seed, lengths:
                        em(codes, K, V, n_iters, seed, lengths))
    got = vqvae_example.run("cpu", init=vq_params_from_numpy(_np(params)),
                            log_fn=print)
    out = capsys.readouterr().out
    assert _rel(got["history"][0], first) <= 1e-5
    assert np.isfinite(got["history"]).all()
    # the loss parts every 50 steps as chaos allows (full-batch Adam at lr
    # 2e-3: measured 3.0e-4 relative at step 100), against JAX's 4 places
    steps = re.findall(r"step (\d+): total=(\S+) recon=(\S+) commit=(\S+)",
                       want)
    assert [int(n) for n, *_ in steps] == sorted(got["parts"]) == [50, 100,
                                                                  150]
    for n, *vals in steps:
        for g, w in zip(got["parts"][int(n)], map(float, vals)):
            assert abs(g - w) <= 1e-3 * abs(w) + 5e-5, (n, g, w)
    # the codes, the EM fit (from JAX's restarts) and the generated shape
    # as JAX prints them
    for what in ("codebook usage", "EM final log-likelihood",
                 "learned transition diagonal", "generated sequences"):
        assert re.findall(what + ".*", out) == re.findall(what + ".*", want)
    assert got["generated_finite"]
    assert seen["codes"].shape == (8, 128)


def _notebook_cells(name):
    with open(os.path.join(ROOT, "notebooks", f"{name}_torch.ipynb")) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_has_jax_cells_on_the_card(name):
    """The port's notebook has as many code cells as JAX's, and its first
    cell picks "cuda" where there is a card.  tests/test_notebooks.py runs
    every notebook's cells, the port's among them, on the CPU."""
    cells = _notebook_cells(name)
    with open(os.path.join(ROOT, "notebooks", f"{name}.ipynb")) as f:
        jax_cells = [c for c in json.load(f)["cells"]
                     if c["cell_type"] == "code"]
    assert len(cells) == len(jax_cells)
    assert 'device = "cuda"' in cells[0]


@pytest.mark.parametrize("mod", EXAMPLES[:2] + EXAMPLES[3:],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_refuse_cuda_without_a_card(mod):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--device", "cuda"])


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_examples_and_notebooks_import_no_jax():
    sources = {m.__file__: open(m.__file__).read() for m in EXAMPLES}
    pkg = os.path.dirname(train_example.__file__)
    sources[os.path.join(pkg, "__init__.py")] = open(
        os.path.join(pkg, "__init__.py")).read()
    for name in NOTEBOOKS:
        sources[f"{name}_torch.ipynb"] = "\n".join(_notebook_cells(name))
    for where, src in sources.items():
        for mod in _imports(ast.parse(src)):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "vqvaehmm_tpu",
                                             "optax", "scripts"), (where, mod)
