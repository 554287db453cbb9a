"""CPU tests of the port's benchmark: `python -m pytest portbench/tests -q`
from the repository's root.  Tests marked `cuda` need the card and skip
without one (decided inside the `card` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness.manifest import Manifest  # noqa: E402

# each loop's traffic cut to a size a CPU test holds
SMALL = {
    "train_epochs": {"pool": {"sequences": 12, "steps": 240}, "batch": 8,
                     "batches_per_epoch": 2, "warmup_epochs": 1,
                     "slice_epochs": 1},
    "score_requests": {"books": 2, "assets": 6,
                       "panel": {"steps_min": 30, "steps_max": 90},
                       "warmup_passes": 1, "checked_requests": 2,
                       "slice_requests": 2},
}


class SmallManifest(Manifest):
    """The benchmark's manifest with every traffic mix cut to SMALL."""

    def traffic(self, name):
        t = super().traffic(name)
        for k, v in SMALL[t["loop"]].items():
            if isinstance(v, dict):
                t[k] = {**t[k], **v}
            else:
                t[k] = v
        return t


@pytest.fixture
def small():
    return SmallManifest()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
