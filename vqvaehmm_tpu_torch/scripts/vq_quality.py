"""The true-VQ stack on synthetic regime-switching data (counterpart of
scripts/vq_quality.py): train the VQ-VAE full-batch (the quantizer's
forward and backward kernels a step on the card), fit the categorical
HMM over the held-out code indices by Baum-Welch (the nearest-code
kernel for the codes), decode (the Viterbi kernel) and score against the
ground truth under the best permutation; a generative round trip from
the fitted HMM checks the samples' scale.  Output
<outdir>/vq_quality.json, and the same JSON on stdout.

    python -m vqvaehmm_tpu_torch.scripts.vq_quality [--epochs 300]
        [--seed 0] [--device cuda]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.synthetic import synthetic_sequences
from ..models.vqvae_hmm import VQVAEConfig, VQVAEHMM
from ..train.trainer import ClippedAdam
from .. import recipe
from ._common import device_record, parser, write_json

ARTIFACT = "vq_quality.json"
K = 3
EM_ITERS = 50          # the code-HMM's Baum-Welch iterations


def main(argv=None) -> int:
    ap = parser("vq_quality", "The VQ stack's regime recovery on synthetic "
                "data.")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    xs, us, zs = synthetic_sequences(10, 200, 5, 4, K, seed=args.seed,
                                     stickiness=0.96)
    train_x = torch.as_tensor(xs[:8], device=dev)
    test_x, test_z = torch.as_tensor(xs[8:], device=dev), zs[8:]

    cfg = VQVAEConfig(input_dim=5, hidden_dim=32, hidden_dim2=16,
                      num_codes=K, latent_dim=16)
    model = VQVAEHMM(cfg, device=dev,
                     generator=torch.Generator().manual_seed(args.seed))
    opt = ClippedAdam(model.parameters(), 3e-3)
    history = []
    for _ in range(args.epochs):
        opt.zero_grad(set_to_none=True)
        parts = model.compute_loss(train_x)
        parts.total.backward()
        opt.update()
        history.append(parts.total.detach())
    history = [float(h) for h in torch.stack(history).cpu()] \
        if history else []

    # codebook usage on held-out data (a collapsed codebook cannot regime)
    codes = model.codes(test_x)
    usage = np.bincount(codes.cpu().numpy().reshape(-1),
                        minlength=K) / codes.numel()
    em = model.fit_hmm(test_x, n_iters=EM_ITERS, seed=args.seed)
    with torch.inference_mode():
        states = em.model.posterior_mode(codes).cpu().numpy().reshape(-1)
    best = recipe._best_perm_acc(states, test_z.reshape(-1), K)[0]

    # generative round trip: samples of finite, data-scale statistics
    samp = model.sample(em.model, torch.Generator().manual_seed(1),
                        seq_len=64, batch=4).cpu().numpy()
    out = {
        "final_total_loss": round(float(parts.total.detach()), 4),
        "final_recon": round(float(parts.recon.detach()), 4),
        "codebook_usage": [round(float(v), 3) for v in usage],
        "regime_acc_code_hmm": round(best, 4),
        "em_final_loglik": round(float(em.log_likelihoods[-1]), 2),
        "sample_std": round(float(samp.std()), 3),
        "epochs": args.epochs, "seed": args.seed,
        "train_history": history,
        **device_record(dev),
    }
    write_json(args.outdir, ARTIFACT, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
