"""The card: the chips a cell needs, the caches' directories, the
published peaks and the power limit they assume.

Peaks are NVIDIA's published figures for one H100 SXM (dense, without
sparsity), at the full 700 W; `power_limit` reads the card's own limit,
which the run prints beside them."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "fp8": 1979e12}
PEAK_BYTES = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense rates, 700 W"


def use_checkout_caches(root: Path) -> None:
    """Point every kernel cache a run might fill at a fixed directory of
    the checkout (the program builds its own library into the checkout's
    build/torch_kernels/), before torch starts.  USE_FLAX=0 keeps a
    library that could load JAX from doing so."""
    base = Path(root) / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def require_chips(torch, chips: int) -> None:
    """Exit with code 2 and no result unless `chips` CUDA devices are
    there."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s), found "
              f"{have}; nothing was measured", file=sys.stderr)
        raise SystemExit(2)


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them, or None
    where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}
