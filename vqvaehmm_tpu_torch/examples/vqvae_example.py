"""True VQ-VAE + HMM example (the JAX package's examples/vqvae_example.py
on the port): train the quantized autoencoder, fit the regime HMM over the
discrete code indices by EM, generate new sequences by ancestral
sampling.

The quantizer is kernel 9's straight-through pair on the card (one
forward and one backward launch a step, one forward launch a loss
evaluation; the codes one nearest-code launch).  The optimizer is plain
Adam without clipping, the counterpart of optax.adam.

    python -m vqvaehmm_tpu_torch.examples.vqvae_example [--device cpu]
"""

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.synthetic import synthetic_sequences
from ..models.vqvae_hmm import VQVAEConfig, VQVAEHMM
from . import parser

STEPS = 150


def run(device="cuda", init: Optional[dict] = None, steps: int = STEPS,
        log_fn=print) -> dict:
    """The example on `device` from the parameters init (a state_dict) or
    drawn from seed 0.  Returns each step's loss, the loss parts every
    50th step, the codebook usage, the EM fit's final log-likelihood and
    transition diagonal, and the generated sequences' shape."""
    log_fn = log_fn or (lambda *a: None)
    dev = resolve_device(device)
    xs, _, _ = synthetic_sequences(8, 128, seed=0, stickiness=0.96)
    x = torch.as_tensor(xs, device=dev)
    lengths = torch.full((xs.shape[0],), xs.shape[2], dtype=torch.int32,
                         device=dev)

    cfg = VQVAEConfig(input_dim=5, hidden_dim=32, hidden_dim2=16,
                      num_codes=4, latent_dim=8)
    model = VQVAEHMM(cfg, device=dev,
                     generator=torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(init)
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)

    history, parts = [], {}
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = model.compute_loss(x, lengths).total
        loss.backward()
        opt.step()
        history.append(loss.detach())
        if (i + 1) % 50 == 0:
            with torch.no_grad():
                p = model.compute_loss(x, lengths)
            parts[i + 1] = (float(p.total), float(p.recon),
                            float(p.commitment))
            log_fn(f"step {i + 1}: total={parts[i + 1][0]:.4f} "
                   f"recon={parts[i + 1][1]:.4f} "
                   f"commit={parts[i + 1][2]:.4f}")

    # discrete codes and an EM HMM over them
    codes = model.codes(x)
    used = len(np.unique(codes.cpu().numpy()))
    log_fn(f"codebook usage: {used}/{cfg.num_codes} codes")
    em = model.fit_hmm(x, n_iters=30)
    ll = float(em.log_likelihoods[-1])
    log_fn(f"EM final log-likelihood: {ll:.1f}")
    diag = np.diag(np.exp(em.model.log_A.cpu().numpy()))
    log_fn(f"learned transition diagonal: {np.round(diag, 3)}")

    # ancestral generation
    gen = model.sample(em.model, torch.Generator().manual_seed(1),
                       seq_len=64, batch=2)
    log_fn(f"generated sequences: {tuple(gen.shape)}")
    return {"history": [float(h) for h in history], "parts": parts,
            "usage": used,
            "em_log_likelihood": ll, "transition_diag": diag,
            "generated_shape": tuple(gen.shape),
            "generated_finite": bool(torch.isfinite(gen).all())}


def main(argv=None) -> int:
    args = parser("vqvae_example", __doc__.splitlines()[0]).parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
