"""Device-side input pipeline example (the JAX package's
examples/device_pipeline_example.py on the port).

Shows the three feeding strategies sharing one contract: host-assembled
epochs, the epoch gathered on the device (DeviceEpochSampler.epoch, one
kernel-D launch), and the gather in the epoch trainer
(sampler.make_epoch_step: the host ships three (batches, B) index arrays
an epoch) - and that the device gather reproduces the host path's
training exactly.  On the card each step is one kernel-C launch.

    python -m vqvaehmm_tpu_torch.examples.device_pipeline_example [--device cpu]
"""

from typing import Optional

import torch

from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset, epoch_arrays
from ..data.device_sampler import DeviceEpochSampler
from ..data.synthetic import synthetic_sequences
from ..models.vae_hmm import make_model
from ..train.trainer import make_epoch_step, make_optimizer, resolve_fused
from . import parser

B, NB = 8, 4


def run(device="cuda", init: Optional[dict] = None) -> dict:
    """The example on `device`, each strategy one epoch from the same
    parameters (init, a state_dict, or drawn from seed 0) and a fresh
    optimizer.  Returns the three epoch losses and whether the device
    gather's equals the host path's."""
    dev = resolve_device(device)
    xs, us, _ = synthetic_sequences(6, 120, 5, 4, 3, seed=0)
    model = make_model(5, 8, 3, 4, u_dim=4, trans_hidden=8, device=dev,
                       generator=torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(init)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    fused = resolve_fused("auto", model.cfg, B, 48, dev, log_fn=None)

    def fresh():
        model.load_state_dict(start)
        return make_optimizer(model, 1e-3)

    def dataset():
        return RandomChunkDataset(xs, us, min_len=16, max_len=48,
                                  samples_per_epoch=NB * B, seed=3)

    # 1. host path: epochs assembled on the host (the reference
    #    DataLoader's shape), shipped whole
    x, u, lens = epoch_arrays(dataset(), B)
    loss_host = make_epoch_step(model, fresh(), fused)(x, u, lens, 1.0)

    # 2. device gather: the same seed gives the same epoch, assembled on
    #    the device in one launch
    sampler = DeviceEpochSampler(dataset(), dev)
    xd, ud, ld = sampler.epoch(B)              # the host path's stream
    loss_dev = make_epoch_step(model, fresh(), fused)(xd, ud, ld, 1.0)

    # 3. the gather in the epoch trainer: the host ships only three
    #    (batches, B) int32 index arrays
    gstep = sampler.make_epoch_step(model, fresh(), fused)
    si, st, ln = sampler.upload(*sampler.sample_indices_fast(B, NB))
    loss_scan = gstep(si, st, ln, 1.0)
    out = {"host": float(loss_host), "device": float(loss_dev),
           "gather_in_step": float(loss_scan)}
    out["same"] = abs(out["host"] - out["device"]) < 1e-7
    return out


def main(argv=None) -> int:
    args = parser("device_pipeline_example",
                  __doc__.splitlines()[0]).parse_args(argv)
    out = run(args.device)
    print(f"host-assembled epoch:      loss {out['host']:.6f}")
    print(f"on-device gathered epoch:  loss {out['device']:.6f}")
    print(f"gather-in-scan epoch:      loss {out['gather_in_step']:.6f} "
          f"(fresh index stream)")
    print(f"device gather matches host path: {out['same']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
