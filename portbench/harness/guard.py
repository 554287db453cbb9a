"""What a run may not load: JAX, its libraries, and the JAX package the
port was made from.  Names compare whole, by the part before the first
dot (`vqvaehmm_tpu_torch` is the port, not `vqvaehmm_tpu`)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vqvaehmm_tpu"})
PROGRAM = "vqvaehmm_tpu_torch"


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & FORBIDDEN)


def imported_tops(path: Path) -> Set[str]:
    """The top-level names of the absolute modules a Python file imports
    (`import a.b`, `from a.b import c`)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            tops.add(node.args[0].value.split(".")[0])
    return tops
