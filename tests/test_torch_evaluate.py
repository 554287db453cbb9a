"""The port's evaluation entry point (vqvaehmm_tpu_torch/eval/evaluate.py)
against the JAX package's on the same `.npz` checkpoint and the same data:
the masked reconstruction MSE within 1e-5 relative (float32 on both sides;
the two datasets draw the same chunks from the same seed)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import inputs, model_pair, t
from vqvaehmm_tpu.eval.evaluate import evaluate as jax_evaluate
from vqvaehmm_tpu.eval.evaluate import masked_recon_mse as jax_mse
from vqvaehmm_tpu_torch.data import market
from vqvaehmm_tpu_torch.data.checkpoint import save_checkpoint
from vqvaehmm_tpu_torch.eval.evaluate import (evaluate, load_model_state,
                                              masked_recon_mse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "artifacts", "config_quality.json")
NPZ = os.path.join(ROOT, "artifacts", "checkpoints_quality",
                   "vae_hmm_trained.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "market_fixture.csv")


@pytest.fixture(scope="module")
def fixture_sequences():
    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    x, u, _, _ = market.prepare_sequences(prices, regime)
    xs, us = market.create_sequences(x, u)
    return (np.transpose(xs, (0, 2, 1)).astype(np.float32),
            np.transpose(us, (0, 2, 1)).astype(np.float32))


def test_masked_recon_mse_matches_jax():
    jm, params, tm = model_pair(seed=41)
    x, _, lengths = inputs(4, 37, seed=42)
    lengths = np.minimum(lengths, 30)      # max(lengths) < T
    got = masked_recon_mse(tm, x, lengths)
    want = jax_mse(jm, params, jnp.asarray(x), jnp.asarray(lengths))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert masked_recon_mse(tm, t(x), t(lengths)) == got


def test_evaluate_matches_jax_on_the_quality_checkpoint(tmp_path,
                                                        fixture_sequences):
    out = tmp_path / "port" / "eval.txt"
    got = evaluate(CONFIG, NPZ, fixture_sequences, batch_size=8,
                   output=str(out), log_fn=None, device="cpu")
    want = jax_evaluate(CONFIG, NPZ, fixture_sequences, batch_size=8,
                        output=str(tmp_path / "jax.txt"), log_fn=None)
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
    assert out.read_text() == f"Mean Recon MSE: {got}\n"
    assert np.isnan(evaluate(CONFIG, NPZ, None, output=str(out),
                             log_fn=None, device="cpu"))


def test_checkpoint_kinds_load_the_same_weights(tmp_path):
    """`.npz`, a reference `.pt` state_dict and the port's own training
    checkpoint (with and without its suffix)."""
    from vqvaehmm_tpu_torch.train.trainer import TrainState, make_optimizer

    quality_pt = os.path.join(ROOT, "artifacts", "checkpoints_quality",
                              "vae_hmm.pt")
    a, b = load_model_state(NPZ), load_model_state(quality_pt)
    assert a.keys() == b.keys()
    _, _, tm = model_pair(seed=43)
    state = TrainState(tm, make_optimizer(tm, 1e-3))
    save_checkpoint(str(tmp_path / "own"), state)
    for path in (tmp_path / "own", tmp_path / "own.pt"):
        got = load_model_state(str(path))
        assert got.keys() == tm.state_dict().keys()
        assert all(torch.equal(got[k], v)
                   for k, v in tm.state_dict().items())


def test_cli_on_cpu(tmp_path, fixture_sequences):
    xs, us = fixture_sequences
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "u.npy", us)
    out = tmp_path / "report" / "eval_results.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "vqvaehmm_tpu_torch.eval.evaluate",
         "--config", CONFIG, "--checkpoint", NPZ, "--data",
         str(tmp_path / "x.npy"), str(tmp_path / "u.npy"), "--batch-size",
         "8", "--output", str(out), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    mse = float(out.read_text().split(":")[1])
    want = evaluate(CONFIG, NPZ, fixture_sequences, batch_size=8,
                    output=str(tmp_path / "again.txt"), log_fn=None,
                    device="cpu")
    # the CLI's process runs torch with its own thread count
    assert abs(mse - want) <= 1e-6 * want


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate(CONFIG, NPZ, None, output=str(tmp_path / "e.txt"),
                 log_fn=None)


def test_bulk_entry_points_import_no_jax():
    code = ("import sys; import vqvaehmm_tpu_torch.eval.evaluate; "
            "import vqvaehmm_tpu_torch.backtest; "
            "import vqvaehmm_tpu_torch.data.market; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'vqvaehmm_tpu' or "
            "m.startswith('vqvaehmm_tpu.') or m == 'pandas']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
