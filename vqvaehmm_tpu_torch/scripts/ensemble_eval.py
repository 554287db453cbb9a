"""Seed ensembles: the quality spread over seeds and what picking the best
member buys (counterpart of scripts/ensemble_eval.py).

train/ensemble.py::train_ensemble trains N seeds over one shared epoch
stream: on the card one gather-kernel launch an epoch, and each member's
step through kernel C.  Each member is then scored: on synthetic data
by the mean-field argmax (the encoder kernel, one launch a member over
all sequences: a row does not depend on its batch), with --fixture on
the held-out last 20% of the fixture windows by the Viterbi path (the
evidence and Viterbi kernels).  Output <outdir>/ensemble_eval.json
(ensemble_eval_fixture.json with --fixture), and the same JSON on
stdout.

    python -m vqvaehmm_tpu_torch.scripts.ensemble_eval [--seeds 8]
        [--epochs 15] [--fixture] [--fused] [--device cuda]
"""

from __future__ import annotations

import json
import time
from itertools import permutations

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset
from ..data.synthetic import synthetic_sequences
from ..models.vae_hmm import make_model
from ..train.ensemble import ensemble_member, train_ensemble
from ._common import device_record, load_windows, parser, write_json


def best_perm_mean_accuracy(preds, zs) -> float:
    """The best permutation's accuracy, averaged over sequences."""
    K = int(max(z.max() for z in zs)) + 1
    best = 0.0
    for perm in permutations(range(K)):
        acc = np.mean([np.mean(np.array([perm[p] for p in pr]) == z)
                       for pr, z in zip(preds, zs)])
        best = max(best, float(acc))
    return best


def regime_accuracy(model, xs, zs) -> float:
    """Best-permutation mean-field argmax accuracy against the ground
    truth, all sequences in one call."""
    with torch.inference_mode():
        q = model.posterior(torch.as_tensor(np.stack(xs), dtype=torch.float32,
                                            device=model.device))
    return best_perm_mean_accuracy(list(q.argmax(1).cpu().numpy()), zs)


def viterbi_accuracy(model, x, u, z) -> float:
    """Best-permutation Viterbi accuracy over windows x, u against z."""
    with torch.inference_mode():
        vit = model.viterbi_decode(
            *(torch.as_tensor(a, dtype=torch.float32, device=model.device)
              for a in (x, u))).cpu().numpy()
    pred, zf = vit.reshape(-1), np.asarray(z).reshape(-1)
    return max(float((np.asarray(p)[pred] == zf).mean())
               for p in permutations(range(3)))


def main(argv=None) -> int:
    ap = parser("ensemble_eval", "Seed ensembles: the spread of final "
                "losses and regime accuracy, and the best member.")
    ap.add_argument("--seeds", type=int, default=8,
                    help="the number of members (seeds 0 .. N-1)")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--fixture", action="store_true",
                    help="train on the first 80%% of the fixture windows "
                         "and score the rest's Viterbi paths, in place of "
                         "synthetic sequences")
    ap.add_argument("--fused", action="store_true",
                    help="require the fused train step (the default, "
                         "'auto', takes it on a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.fixture:
        xw, uw, zw = load_windows(args.outdir)
        n_train = int(0.8 * len(xw))
        xs, us = list(xw[:n_train]), list(uw[:n_train])
        eval_x, eval_u, eval_z = xw[n_train:], uw[n_train:], zw[n_train:]
    else:
        xs, us, zs = synthetic_sequences(6, 150, seed=0)
        eval_x, eval_u, eval_z = xs, us, zs
    ds = RandomChunkDataset(xs, us, min_len=20, max_len=64,
                            samples_per_epoch=128, seed=0)
    model = make_model(5, 32, 3, 16, u_dim=4, trans_hidden=32, device=dev)

    t0 = time.perf_counter()
    states, hist, best = train_ensemble(
        model, ds, seeds=range(args.seeds), num_epochs=args.epochs,
        batch_size=32, fused=True if args.fused else "auto", device=dev,
        log_fn=None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    finals = hist[:, -1]
    members = [ensemble_member(states, i).model.eval()
               for i in range(args.seeds)]
    if args.fixture:
        accs = [viterbi_accuracy(m, eval_x, eval_u, eval_z) for m in members]
    else:
        accs = [regime_accuracy(m, eval_x, eval_z) for m in members]
    out = {
        "data": "market_fixture_heldout" if args.fixture else "synthetic",
        "n_seeds": args.seeds,
        "seeds": list(range(args.seeds)),
        "epochs": args.epochs,
        "wall_seconds": round(wall, 1),
        "final_loss": {"min": float(finals.min()),
                       "median": float(np.median(finals)),
                       "max": float(finals.max())},
        "regime_acc": {"min": round(min(accs), 4),
                       "median": round(float(np.median(accs)), 4),
                       "max": round(max(accs), 4)},
        "best_member": best,
        "best_member_acc": round(accs[best], 4),
        "loss_history": hist.tolist(),
        **device_record(dev),
    }
    write_json(args.outdir, "ensemble_eval_fixture.json" if args.fixture
               else "ensemble_eval.json", out)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
