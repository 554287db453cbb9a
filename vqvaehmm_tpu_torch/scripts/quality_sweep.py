"""Where does exact HMM inference beat the mean-field argmax?
(counterpart of scripts/quality_sweep.py)

Sweeps the synthetic generator over regime stickiness (0.90, 0.97,
0.99) x emission noise (1, 2, 3), trains the VAE-HMM in each cell
(train_model: kernels C and D on the card) and scores regime recovery
under the three decodes (the encoder kernel; the evidence kernel and the
plain recursions; the evidence and Viterbi kernels), with the switches
per 100 steps of each.  The hypothesis: smoothing wins where per-step
evidence is weak and the dynamics informative.

JAX's script also measures decode stability on the reference's shipped
checkpoint where it finds one; that checkpoint is not in this
repository, and that part waits for it.  Output
<outdir>/quality_sweep.json, one JSON line a cell on stdout and a table
on stderr.

    python -m vqvaehmm_tpu_torch.scripts.quality_sweep [--epochs 40]
        [--seed 0] [--device cuda]
"""

from __future__ import annotations

import json

import numpy as np

from .. import recipe
from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset
from ..data.synthetic import synthetic_sequences
from ..models.vae_hmm import make_model
from ..train.trainer import train_model
from ._common import device_record, log, parser, write_json

ARTIFACT = "quality_sweep.json"
K = 3
CELLS = [(s, n) for s in (0.90, 0.97, 0.99) for n in (1.0, 2.0, 3.0)]


def switches_per_100(states: np.ndarray) -> float:
    """recipe._switch_rate per 100 steps, unrounded: JAX's JSON rounds
    the scaled rate to 2 places, not the rate to 4."""
    d = (np.diff(states, axis=-1) != 0).mean()
    return float(d * 100)


def run_cell(stickiness, noise_scale, epochs, seed, device):
    """(accuracy a decode, switches per 100 steps a decode and of the
    truth) of one cell."""
    xs, us, zs = synthetic_sequences(12, 200, 5, 4, K, seed=seed,
                                     stickiness=stickiness,
                                     noise_scale=noise_scale)
    train_x, train_u = xs[:8], us[:8]
    test_x, test_u, test_z = xs[8:], us[8:], zs[8:]
    ds = RandomChunkDataset(train_x, train_u, min_len=20, max_len=100,
                            samples_per_epoch=256, seed=seed)
    model = make_model(5, 64, 3, 32, u_dim=4, trans_hidden=64, device=device)
    train_model(model, ds, num_epochs=epochs, lr=1e-3, batch_size=32,
                device=device, log_fn=None)
    preds = recipe._decodes(model.eval(), test_x, test_u, device)
    names = {"argmax": "meanfield_argmax", "smoothed": "smoothed_argmax",
             "viterbi": "viterbi"}
    acc = {k: recipe._best_perm_acc(preds[m], test_z, K)[0]
           for k, m in names.items()}
    sw = {**{k: switches_per_100(preds[m]) for k, m in names.items()},
          "truth": switches_per_100(test_z)}
    return acc, sw


def main(argv=None) -> int:
    ap = parser("quality_sweep", "Stickiness x noise grid of the decode "
                "modes on synthetic data.")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    log(f"{'stick':>6} {'noise':>6} | {'argmax':>7} {'smooth':>7} "
        f"{'viterbi':>7} | best gain")
    cells = []
    for stickiness, noise in CELLS:
        acc, sw = run_cell(stickiness, noise, args.epochs, args.seed, dev)
        gain = max(acc["smoothed"], acc["viterbi"]) - acc["argmax"]
        row = {"stickiness": stickiness, "noise_scale": noise,
               "acc": {k: round(v, 4) for k, v in acc.items()},
               "switches_per_100": {k: round(v, 2) for k, v in sw.items()},
               "gain_pts": round(gain * 100, 1)}
        print(json.dumps(row), flush=True)
        cells.append(row)
        log(f"{stickiness:6.2f} {noise:6.1f} | {acc['argmax']:7.3f} "
            f"{acc['smoothed']:7.3f} {acc['viterbi']:7.3f} | "
            f"{gain * 100:+5.1f} pts")
    out = {"epochs": args.epochs, "seed": args.seed, "cells": cells,
           "reference_checkpoint_stability":
               "not run: the reference's shipped checkpoint is not in this "
               "repository",
           **device_record(dev)}
    write_json(args.outdir, ARTIFACT, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
