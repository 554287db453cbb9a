"""The port's CLI report (vqvaehmm_tpu_torch.serve.cli), its reference
`.pt` heads and its foreground server's SIGTERM on the CPU, held against
the JAX package on the same files (after the CLI, head and SIGTERM cases
of tests/test_serve.py)."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.torch_port import SMALL, free_port, write_serving_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTFOLIO = {"n_assets": 4, "hidden_dim": 6}


def _close_report(got, want, atol=1e-5):
    assert got["current_regime"] == want["current_regime"]
    for key in ("regime_probs", "regime_distribution", "last_allocations"):
        np.testing.assert_allclose(np.array(got[key]), np.array(want[key]),
                                   rtol=0, atol=atol, err_msg=key)
    assert list(got["allocation"]) == list(want["allocation"])
    np.testing.assert_allclose(list(got["allocation"].values()),
                               list(want["allocation"].values()), rtol=0,
                               atol=atol)


def _jax_head(family, seed, K=3):
    from vqvaehmm_tpu.models.portfolio import (HeadConfig,
                                               ImprovedPortfolioOptimizer,
                                               RegimePortfolioOptimizer)

    cls = {"regime": RegimePortfolioOptimizer,
           "improved": ImprovedPortfolioOptimizer}[family]
    head = cls(HeadConfig(K=K, **PORTFOLIO))
    return head, head.init(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("head_format", ["npz", "pt-regime", "pt-improved"])
def test_cli_vae_report_matches_jax(tmp_path, head_format, capsys):
    """--stack vae on a `.npz` checkpoint with a `.npz` head or a
    reference `.pt` head of either family: the report equals JAX's
    `report` on the same files within 1e-5."""
    from vqvaehmm_tpu import make_model
    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu.serve.cli import report as jax_report
    from vqvaehmm_tpu.utils.torch_interop import save_head_torch_file
    from vqvaehmm_tpu_torch.serve.cli import main

    jm = make_model(**SMALL)
    params = jm.init(jax.random.PRNGKey(0))
    save_params_npz(str(tmp_path / "m.npz"), params)
    family = "improved" if head_format == "pt-improved" else "regime"
    head, head_params = _jax_head(family, seed=1)
    head_path = str(tmp_path / ("head.npz" if head_format == "npz"
                                else "head.pt"))
    if head_format == "npz":
        save_params_npz(head_path, head_params)
    else:
        save_head_torch_file(head_params, head_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": SMALL,
                                    "portfolio": PORTFOLIO}))
    x = np.random.default_rng(0).normal(size=(1, 5, 30)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)

    got = main(["--config", str(cfg_path), "--checkpoint",
                str(tmp_path / "m.npz"), "--head-checkpoint", head_path,
                "--data", str(tmp_path / "x.npy"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Current regime:" in out and "Allocation:" in out
    want = jax_report(lambda a: jm.posterior(params, a),
                      lambda q: head(head_params, q), x, log_fn=None)
    _close_report(got, want)


def test_cli_vq_report_matches_jax(tmp_path, capsys):
    """--stack vq on the committed VQ archive against JAX's CLI."""
    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu.serve.cli import main as jax_main
    from vqvaehmm_tpu_torch.serve.cli import main

    archive = os.path.join(ROOT, "artifacts", "checkpoints_vq",
                           "vq_stack.npz")
    _, head_params = _jax_head("regime", seed=2)
    save_params_npz(str(tmp_path / "head.npz"), head_params)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": dict(SMALL, family="vqvae"),
                                    "portfolio": PORTFOLIO}))
    x = np.random.default_rng(3).normal(size=(5, 40)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    argv = ["--config", str(cfg_path), "--checkpoint", archive,
            "--stack", "vq", "--data", str(tmp_path / "x.npy"),
            "--head-checkpoint", str(tmp_path / "head.npz")]
    got = main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    want = jax_main(argv)
    jax_out = capsys.readouterr().out
    _close_report(got, want)
    codes = [line for line in port_out.splitlines() if "Codes" in line]
    assert codes == [line for line in jax_out.splitlines() if "Codes" in line]


def test_cli_vae_reference_pt_checkpoint_and_gmm(tmp_path, capsys):
    """A reference `.pt` model checkpoint runs end to end (synthetic data,
    random head); --stack gmm reports from a port-written ImprovedSystem
    archive as JAX's report_gmm does from the same file."""
    from vqvaehmm_tpu import make_model
    from vqvaehmm_tpu.utils.torch_interop import save_torch_file
    from vqvaehmm_tpu_torch.serve.cli import main

    save_torch_file(make_model(**SMALL).init(jax.random.PRNGKey(5)),
                    str(tmp_path / "m.pt"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": SMALL,
                                    "portfolio": PORTFOLIO}))
    out = main(["--config", str(cfg_path), "--checkpoint",
                str(tmp_path / "m.pt"), "--device", "cpu"])
    assert len(out["allocation"]) == 4 and len(out["last_allocations"]) == 5
    assert "Current regime:" in capsys.readouterr().out
    from vqvaehmm_tpu.serve.cli import report_gmm as jax_report_gmm
    from vqvaehmm_tpu.train.gmm_pipeline import load_improved_system
    from vqvaehmm_tpu_torch.train.gmm_pipeline import train_improved_system

    returns = np.random.default_rng(3).normal(5e-4, 0.01, size=(300, 4))
    train_improved_system(returns, hidden_dim=6, num_epochs=5, log_fn=None,
                          device="cpu").save(str(tmp_path / "gmm.npz"))
    np.save(tmp_path / "r.npy", returns)
    out = main(["--checkpoint", str(tmp_path / "gmm.npz"), "--stack", "gmm",
                "--data", str(tmp_path / "r.npy"), "--device", "cpu"])
    assert "Current regime:" in capsys.readouterr().out
    _close_report(out, jax_report_gmm(load_improved_system(
        str(tmp_path / "gmm.npz")), returns, log_fn=None))


@pytest.mark.parametrize("family", ["regime", "improved"])
def test_pt_head_predict_matches_jax(tmp_path, family):
    """A reference-format `.pt` head, written by the JAX package's
    save_head_torch_file, behind /predict: the weights equal the JAX
    server's within 1e-5; a head of another K is refused."""
    from vqvaehmm_tpu.serve.app import InferenceModel as JaxModel
    from vqvaehmm_tpu.utils.torch_interop import save_head_torch_file
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    _, head_params = _jax_head(family, seed=6)
    save_head_torch_file(head_params, str(tmp_path / "head.pt"))
    cfg_path = write_serving_config(
        tmp_path, seed=7, portfolio=PORTFOLIO,
        head_checkpoint_path=str(tmp_path / "head.pt"))
    x = np.random.default_rng(8).normal(size=(5, 26)).tolist()
    got = InferenceModel(cfg_path, device="cpu").predict(x)
    want = JaxModel(cfg_path).predict(x)
    for key in ("weights", "regime_probs"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)

    _, bad = _jax_head(family, seed=6, K=4)
    save_head_torch_file(bad, str(tmp_path / "bad.pt"))
    cfg_path = write_serving_config(
        tmp_path, seed=7, name="bad.json", portfolio=PORTFOLIO,
        head_checkpoint_path=str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="K=4"):
        InferenceModel(cfg_path, device="cpu").predict(x)


def test_head_checkpoint_loads_with_explicit_npz_suffix(tmp_path):
    """head_checkpoint_path with its `.npz` suffix loads (the served
    weights come from the saved head), and a mismatched head fails at the
    first /predict."""
    import jax.numpy as jnp

    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    head, head_params = _jax_head("regime", seed=7)
    save_params_npz(str(tmp_path / "head.npz"), head_params)
    cfg_path = write_serving_config(
        tmp_path, seed=1, portfolio=PORTFOLIO,
        head_checkpoint_path=str(tmp_path / "head.npz"))
    m = InferenceModel(cfg_path, device="cpu")
    x = np.random.default_rng(0).normal(size=(5, 30)).astype(np.float32)
    q = np.array(m.infer(x.tolist())["regime_probs"])[None]
    want = np.asarray(head(head_params, jnp.asarray(q)))[0]
    np.testing.assert_allclose(m.predict(x.tolist())["weights"], want,
                               rtol=0, atol=1e-5)

    _, bad = _jax_head("regime", seed=0, K=3)
    bad["fc3"] = {k: np.concatenate([v, v]) for k, v in bad["fc3"].items()}
    save_params_npz(str(tmp_path / "bad.npz"), bad)
    cfg_path = write_serving_config(
        tmp_path, seed=1, name="bad.json", portfolio=PORTFOLIO,
        head_checkpoint_path=str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="head checkpoint"):
        InferenceModel(cfg_path, device="cpu").predict(x.tolist())


def test_sigterm_graceful_shutdown(tmp_path):
    """The foreground server, micro-batching, exits 0 on SIGTERM after
    draining."""
    cfg_path = write_serving_config(tmp_path, seed=2)
    port = free_port()
    err_path = tmp_path / "server.err"
    with open(err_path, "wb") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vqvaehmm_tpu_torch.serve.httpd",
             "--config", cfg_path, "--host", "127.0.0.1", "--port",
             str(port), "--device", "cpu", "--batch"],
            stdout=subprocess.DEVNULL, stderr=err_f, cwd=ROOT)
    try:
        deadline = time.monotonic() + 120
        up = False
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=1) as r:
                    up = r.status == 200
                    break
            except OSError:
                if proc.poll() is not None:
                    break
                time.sleep(0.25)
        assert up, (proc.poll(), err_path.read_bytes()[-500:])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, err_path.read_bytes()[-500:]
        assert b"SIGTERM: draining" in err_path.read_bytes()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
