"""The port's deployment surface on the CPU: the MODE switch
(vqvaehmm_tpu_torch/entrypoint.py, entrypoint_torch.sh) against
entrypoint.sh's table, a wheel of the port that carries its kernel sources,
and where an installed port builds its kernels (ops/_build.py::build_dir).
Dockerfile.torch, docker-compose.torch.yml and
deploy/k8s/deployment_torch.yaml need Docker or a cluster and are not run
here."""

import os
import shutil
import subprocess
import sys
import zipfile

import pytest

from vqvaehmm_tpu_torch import entrypoint
from vqvaehmm_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"TRAIN_CONFIG": "cfg/t.json", "VQHMM_INFERENCE_CONFIG": "i.json",
       "PORT": "9001", "WORKERS": "3"}


@pytest.mark.parametrize("mode,env,want", [
    ("train", {}, ["python", "-m", "vqvaehmm_tpu_torch.train.pipeline",
                   "configs/train_config.json", "--device", "cuda"]),
    ("train", ENV, ["python", "-m", "vqvaehmm_tpu_torch.train.pipeline",
                    "cfg/t.json", "--device", "cuda"]),
    ("serve", {}, ["python", "-m", "vqvaehmm_tpu_torch.serve.httpd",
                   "--config", "inference_config.json", "--port", "8000",
                   "--device", "cuda"]),
    ("serve", ENV, ["python", "-m", "vqvaehmm_tpu_torch.serve.httpd",
                    "--config", "i.json", "--port", "9001", "--device",
                    "cuda"]),
    ("serve-prod", {}, ["gunicorn", "-k", "uvicorn.workers.UvicornWorker",
                        "-w", "4", "-b", "0.0.0.0:8000",
                        "vqvaehmm_tpu_torch.serve.app:create_app()"]),
    ("serve-prod", ENV, ["gunicorn", "-k", "uvicorn.workers.UvicornWorker",
                         "-w", "3", "-b", "0.0.0.0:9001",
                         "vqvaehmm_tpu_torch.serve.app:create_app()"]),
    ("serve-asgi", {}, ["uvicorn", "--host", "0.0.0.0", "--port", "8000",
                        "--factory",
                        "vqvaehmm_tpu_torch.serve.asgi:create_asgi_app"]),
    ("serve-asgi", ENV, ["uvicorn", "--host", "0.0.0.0", "--port", "9001",
                         "--factory",
                         "vqvaehmm_tpu_torch.serve.asgi:create_asgi_app"]),
])
def test_command_maps_each_mode(mode, env, want):
    assert entrypoint.command(mode, env) == want


def test_extra_arguments_go_before_trains_device():
    got = entrypoint.command("train", {}, ["training.num_epochs=2"])
    assert got[-3:] == ["training.num_epochs=2", "--device", "cuda"]
    assert entrypoint.command("serve", {}, ["--batch"])[-1] == "--batch"


def test_unknown_mode_exits_1_with_jaxs_message(monkeypatch, capsys):
    """The module under an unknown MODE and entrypoint.sh: exit 1 and the
    same message on standard error."""
    jax = subprocess.run(["sh", os.path.join(ROOT, "entrypoint.sh")],
                         env=dict(os.environ, MODE="bogus"), cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    monkeypatch.setenv("MODE", "bogus")
    monkeypatch.setattr(entrypoint.os, "execvp", None)   # never reached
    assert entrypoint.main([]) == jax.returncode == 1
    assert capsys.readouterr().err.strip() == jax.stderr.strip() == (
        "unknown MODE=bogus (train|serve|serve-prod|serve-asgi)")


def test_shell_wrapper_execs_the_module():
    with open(os.path.join(ROOT, "entrypoint_torch.sh")) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    assert lines == ['exec python3 -m vqvaehmm_tpu_torch.entrypoint "$@"\n']


def test_main_execs_the_command(monkeypatch):
    seen = []
    monkeypatch.setenv("MODE", "serve")
    monkeypatch.setenv("PORT", "8123")
    monkeypatch.setattr(entrypoint.os, "execvp",
                        lambda f, argv: seen.append((f, argv)))
    entrypoint.main(["--batch"])
    (f, argv), = seen
    assert f == argv[0] == sys.executable
    assert argv[1:] == ["-m", "vqvaehmm_tpu_torch.serve.httpd", "--config",
                        "inference_config.json", "--port", "8123",
                        "--device", "cuda", "--batch"]


def _port_copy(dst):
    """What Dockerfile.torch copies to install the port."""
    for name in ("pyproject.toml", "MANIFEST.in"):
        shutil.copy(os.path.join(ROOT, name), dst)
    shutil.copytree(os.path.join(ROOT, "vqvaehmm_tpu_torch"),
                    os.path.join(dst, "vqvaehmm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_wheel_carries_the_kernel_sources(tmp_path):
    src, out = tmp_path / "src", tmp_path / "wheel"
    src.mkdir()
    _port_copy(src)
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    wheel, = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    want = {f"vqvaehmm_tpu_torch/csrc/{p.name}"
            for p in _build.sources() + _build.headers()}
    assert len(want) >= 11 and want <= names
    assert "vqvaehmm_tpu_torch/ops/_build.py" in names
    assert "vqvaehmm_tpu_torch/entrypoint.py" in names


def test_build_dir_in_a_checkout_and_installed(tmp_path, monkeypatch):
    """build/torch_kernels/ beside a source checkout (the parent holds
    pyproject.toml and the package its csrc/), the user's cache directory
    for a package anywhere else."""
    assert _build.BUILD_DIR == _build.build_dir(_build.PACKAGE) == (
        _build.PACKAGE.parent / "build" / "torch_kernels")
    assert str(_build.BUILD_DIR) == os.path.join(ROOT, "build",
                                                 "torch_kernels")
    site = tmp_path / "site-packages"
    site.mkdir()
    _port_copy(site)
    (site / "pyproject.toml").unlink()
    pkg = site / "vqvaehmm_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(pkg) == tmp_path / "cache" / "vqvaehmm_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir(pkg) == (tmp_path / "home" / ".cache"
                                     / "vqvaehmm_tpu_torch")
    # a checkout copied anywhere keeps its own build/torch_kernels
    (site / "pyproject.toml").write_text("")
    assert _build.build_dir(pkg) == site / "build" / "torch_kernels"


def test_factories_read_the_inference_config_variable(monkeypatch):
    from vqvaehmm_tpu_torch.serve.app import default_config_path

    monkeypatch.delenv("VQHMM_INFERENCE_CONFIG", raising=False)
    assert default_config_path() == "inference_config.json"
    monkeypatch.setenv("VQHMM_INFERENCE_CONFIG", "/x/cfg.json")
    assert default_config_path() == "/x/cfg.json"
