"""End-to-end training example (the JAX package's
examples/train_example.py on the port).

Trains the VAE-HMM on synthetic regime-switching data (kernels C and D on
the card: one fused loss-and-gradients launch a step, one gather an
epoch), then a portfolio head on the frozen posteriors (kernel 8, one
launch a batch), and prints the resulting allocation.

    python -m vqvaehmm_tpu_torch.examples.train_example [--device cpu]
"""

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset
from ..data.synthetic import synthetic_returns, synthetic_sequences
from ..models.portfolio import HeadConfig, RegimePortfolioOptimizer
from ..models.vae_hmm import make_model
from ..train.heads import train_portfolio_optimizer
from ..train.trainer import TrainState, make_optimizer, train_model
from . import parser

EPOCHS = 15
HEAD_EPOCHS = 10


def run(device="cuda", init: Optional[dict] = None,
        head_init: Optional[dict] = None, epochs: int = EPOCHS,
        head_epochs: int = HEAD_EPOCHS, log_fn=print) -> dict:
    """The example on `device`.  init / head_init: state_dicts to start
    the VAE-HMM and the head from (default: drawn from seeds 0 and 1).
    Returns the epoch losses of both trainings and the allocation."""
    dev = resolve_device(device)
    # 1. data
    xs, us, _ = synthetic_sequences(n_sequences=8, seq_len=200, seed=0)
    dataset = RandomChunkDataset(xs, us, min_len=20, max_len=100,
                                 samples_per_epoch=256, seed=0)

    # 2. VAE-HMM (the reference README's recipe, smaller)
    model = make_model(5, 32, 3, 16, u_dim=4, trans_hidden=32, device=dev)
    state = None
    if init is not None:
        model.load_state_dict(init)
        state = TrainState(model, make_optimizer(model, 1e-3))
    state, history = train_model(model, dataset, num_epochs=epochs, lr=1e-3,
                                 batch_size=32, state=state, device=dev,
                                 log_fn=log_fn)

    # 3. portfolio head on frozen posteriors
    head = RegimePortfolioOptimizer(
        HeadConfig(K=3, n_assets=10), device=dev,
        generator=torch.Generator().manual_seed(1))
    if head_init is not None:
        head.load_state_dict(head_init)
    batches = [(xs[:4, :, :64], us[:4, :, :64], np.full(4, 64, np.int32))
               for _ in range(4)]
    returns = synthetic_returns(4, 4, horizon=20, n_assets=10, seed=1)
    result = train_portfolio_optimizer(head, model, batches, returns,
                                       num_epochs=head_epochs, lr=1e-3,
                                       log_fn=log_fn)

    # 4. allocate
    with torch.no_grad():
        q = model.posterior(torch.as_tensor(xs[:1], device=dev))
        weights = head(q)
    return {"history": [float(h) for h in history],
            "head_history": [float(h) for h in result.history],
            "allocation": weights[0].cpu().numpy()}


def main(argv=None) -> int:
    args = parser("train_example", __doc__.splitlines()[0]).parse_args(argv)
    out = run(args.device)
    print("allocation:", np.round(out["allocation"], 3))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
