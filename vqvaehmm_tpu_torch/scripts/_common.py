"""What the studies share: the CLI's --device and --outdir, the device
record every JSON carries, the committed JAX artifacts, the fixture
windows and the seed-distribution summaries."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from .. import recipe
from ..core.device import resolve_device

OUTDIR = os.path.join(recipe.ROOT, "artifacts_torch")
JAX_ARTIFACTS = os.path.join(recipe.ROOT, "artifacts")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parser(prog: str, description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m vqvaehmm_tpu_torch.scripts.{prog}",
        description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--outdir", default=OUTDIR,
                    help="where the JSON goes, and <outdir>/data the "
                         "fixture windows (default: artifacts_torch/)")
    return ap


def device_record(device) -> dict:
    """The device a JSON's numbers come from: its type, its name, and for
    a card the name and power limit nvidia-smi gives."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {"backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "power_limit": recipe._power_limit(dev) if cuda else None}


def jax_artifact(name: str) -> Optional[dict]:
    """A committed JAX artifact (artifacts/<name>), read, never
    recomputed; None where it is not there."""
    path = os.path.join(JAX_ARTIFACTS, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_json(outdir: str, name: str, out: dict) -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {path}")
    return path


def data_dir(outdir: str) -> str:
    """<outdir>/data, written by the recipe's data stage where it is not
    there yet."""
    d = os.path.join(outdir, "data")
    if not os.path.exists(os.path.join(d, "z_windows.npy")):
        log(f"no fixture windows under {d}: running the recipe's data stage")
        recipe.stage_data(outdir)
    return d


def load_windows(outdir: str):
    """The fixture's windows (x (N, C, T), u (N, U, T)) and their
    ground-truth regimes z (N, T)."""
    d = data_dir(outdir)
    return tuple(np.load(os.path.join(d, n)) for n in
                 ("x_sequences.npy", "u_sequences.npy", "z_windows.npy"))


def dist(rows, key):
    """[min, median, max] of rows[i][key], each rounded to 4 places."""
    vals = [r[key] for r in rows]
    return [round(float(np.min(vals)), 4),
            round(float(np.median(vals)), 4),
            round(float(np.max(vals)), 4)]


def decode_scores(preds: dict, z: np.ndarray) -> dict:
    """regime_acc_, regime_bal_acc_ and switch_rate_ of each decode in
    preds ((N, T) states) against z, in the order of preds."""
    out = {}
    for name, pred in preds.items():
        recipe._accuracies(out, {name: pred}, z)
        out["switch_rate_" + name] = recipe._switch_rate(pred)
    return out


def inside(port, jax) -> Optional[dict]:
    """Port median against JAX's seed distribution, both [min, median,
    max]: whether the port's median lies inside JAX's [min, max], the gap
    between the medians, and whether that gap is larger than JAX's spread
    max - min (`parts`: a difference, by the rule that only medians
    parting by more than the seeds' spread are one)."""
    if port is None or jax is None:
        return None
    gap = round(port[1] - jax[1], 4)
    return {"port_median": port[1], "jax_min_max": [jax[0], jax[2]],
            "inside": bool(jax[0] <= port[1] <= jax[2]),
            "median_gap": gap,
            "parts": bool(abs(gap) > round(jax[2] - jax[0], 4))}
