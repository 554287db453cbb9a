"""The port's messages and docstrings name ROADMAP.md's items by their
titles, never by a number: a re-anchor renumbers the queues, and a number
then points at another item."""

import os
import re

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vqvaehmm_tpu_torch")
NUMBERED = re.compile(r"\b(item|slice)s?\s*#?\d+", re.IGNORECASE)


def _sources():
    for root, _, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, name)


def test_no_roadmap_item_named_by_number():
    bad = []
    for path in _sources():
        with open(path) as f:
            # join the lines, so that a reference broken over two lines of
            # a docstring or of adjacent string literals is read whole
            text = re.sub(r"[\s\"'#]+", " ", f.read())
        for m in re.finditer("ROADMAP", text):
            near = text[max(0, m.start() - 60):m.end() + 80]
            if NUMBERED.search(near):
                bad.append(f"{os.path.relpath(path, PORT)}: ...{near}...")
    assert not bad, "\n".join(bad)
    assert len(list(_sources())) > 40
