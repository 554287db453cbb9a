"""Nothing under portbench/ imports JAX or the JAX package (whole
top-level names: `vqvaehmm_tpu_torch` is the port), and the reference
imports nothing of the port."""

from pathlib import Path

import pytest

from portbench.harness import guard

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not guard.imported_tops(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert guard.PROGRAM not in guard.imported_tops(path)


def test_whole_names_compare(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vqvaehmm_tpu_torch.ops\nfrom jaxlib import x\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert guard.imported_tops(f) == {"vqvaehmm_tpu_torch", "jaxlib",
                                      "importlib", "jax"}
    assert guard.imported_tops(f) & guard.FORBIDDEN == {"jaxlib", "jax"}


def test_a_run_leaves_no_jax_loaded():
    """A dry run of a cell in a fresh process loads no forbidden module."""
    import subprocess
    import sys

    code = (
        "import sys, time, torch\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[1] + '/portbench/tests']\n"
        "from conftest import SmallManifest\n"
        "from portbench.harness import core, guard\n"
        "core.run(SmallManifest(), 'f32.score-books', 1, 0.1, True,\n"
        "         torch.device('cpu'), time.perf_counter())\n"
        "print(guard.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code, str(PKG.parent)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
