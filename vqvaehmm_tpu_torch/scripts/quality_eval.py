"""Regime recovery on synthetic ground truth, by decode mode: the
mean-field argmax, the smoothed posterior's argmax and the Viterbi path,
with the test ELBO and the masked reconstruction MSE (counterpart of
scripts/quality_eval.py).

Ten synthetic sequences of 200 steps (stickiness 0.96): eight train the
VAE-HMM (train_model: kernels C and D on the card), two are scored (the
encoder kernel; the evidence kernel and the plain recursions; the
evidence and Viterbi kernels; the serving forward for the MSE).  Output
<outdir>/quality_eval.json, and the same JSON on stdout.

    python -m vqvaehmm_tpu_torch.scripts.quality_eval [--epochs 30]
        [--seed 0] [--device cuda]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import recipe
from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset
from ..data.synthetic import synthetic_sequences
from ..eval.evaluate import masked_recon_mse
from ..models.vae_hmm import make_model
from ..train.trainer import train_model
from ._common import device_record, parser, write_json

ARTIFACT = "quality_eval.json"
K = 3


def main(argv=None) -> int:
    ap = parser("quality_eval", "Regime recovery by decode mode on "
                "synthetic ground truth.")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    xs, us, zs = synthetic_sequences(10, 200, 5, 4, K, seed=args.seed,
                                     stickiness=0.96)
    train_x, train_u = xs[:8], us[:8]
    test_x, test_u, test_z = xs[8:], us[8:], zs[8:]
    ds = RandomChunkDataset(train_x, train_u, min_len=20, max_len=100,
                            samples_per_epoch=256, seed=args.seed)
    model = make_model(5, 64, 3, 32, u_dim=4, trans_hidden=64, device=dev)
    _, hist = train_model(model, ds, num_epochs=args.epochs, lr=1e-3,
                          batch_size=32, device=dev, log_fn=None)
    model.eval()
    lengths = np.full((test_x.shape[0],), test_x.shape[2], np.int32)
    with torch.no_grad():
        elbo = float(model.compute_loss(
            *(torch.as_tensor(a, device=dev) for a in (test_x, test_u,
                                                       lengths)), 1.0))
    preds = recipe._decodes(model, test_x, test_u, dev)
    out = {
        "final_train_loss": round(hist[-1], 4),
        "test_elbo": round(elbo, 4),
        "test_recon_mse": round(masked_recon_mse(model, test_x, lengths), 4),
        **{f"regime_acc_{m}": round(recipe._best_perm_acc(p, test_z, K)[0],
                                     4)
           for m, p in preds.items()},
        "epochs": args.epochs, "seed": args.seed,
        "train_history": hist,
        **device_record(dev),
    }
    write_json(args.outdir, ARTIFACT, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
