"""Evaluation CLI: masked reconstruction MSE over a dataset (counterpart
of vqvaehmm_tpu/eval/evaluate.py).

Rebuilds the model from the config, loads a checkpoint (the JAX
package's `.npz` export, a reference `.pt` state_dict, or one of the
port's own training checkpoints), evaluates the masked reconstruction MSE
batch by batch and writes `evaluation_reports/eval_results.txt`.

    python -m vqvaehmm_tpu_torch.eval.evaluate --config CONFIG \\
        --checkpoint CKPT --data X.npy U.npy --device cuda

It runs on the card unless `--device cpu` is given; a CUDA device on a
machine without a GPU raises.  On the card each batch's forward is the
fused serving kernel (ops/fused_infer.py).
"""

from __future__ import annotations

import argparse
import os
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Optional

import torch

from ..core.masking import length_mask


def masked_recon_mse(model, x, lengths) -> float:
    """Masked reconstruction MSE of one batch: the squared error of the
    decoder mean over the valid steps, the encoder and decoder bounded at
    max(lengths).  x (B, C, T) and lengths (B,) may be numpy arrays or
    tensors; they are moved to the model's device."""
    dev = model.device
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    lengths = torch.as_tensor(lengths).to(dev)
    with torch.inference_mode():
        mu, _, _ = model.infer_forward(x, valid_to=lengths.max())
        mask = length_mask(lengths, x.shape[2]).to(x.dtype)
        recon = ((mu - x) ** 2) * mask[:, None, :]
        denom = torch.clamp(mask.sum() * x.shape[1], min=1.0)
        return float(recon.sum() / denom)


def load_model_state(checkpoint: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict from a `.npz` parameter file, a reference
    `.pt`/`.pth` state_dict, or a training checkpoint of the port (named
    with or without its `.pt` suffix)."""
    from ..data.checkpoint import (load_params_npz, load_state_dict_file,
                                   params_from_numpy)

    if checkpoint.endswith(".npz"):
        return params_from_numpy(load_params_npz(checkpoint))
    path = checkpoint if checkpoint.endswith((".pt", ".pth")) \
        else checkpoint + ".pt"
    blob = load_state_dict_file(path)
    if isinstance(blob.get("model"), Mapping) and "optimizer" in blob:
        return dict(blob["model"])
    return blob


def evaluate(config: str, checkpoint: str, data=None, batch_size: int = 32,
             output: str = "evaluation_reports/eval_results.txt",
             log_fn=print, device="cuda") -> float:
    """Mean masked reconstruction MSE over 4 batches of random chunks of
    `data` = (x_sequences, u_sequences) (NaN without data), written to
    `output`."""
    from ..core.config import load_config
    from ..core.device import resolve_device
    from ..data.checkpoint import validate_params_for
    from ..data.dataset import RandomChunkDataset, batch_iterator
    from ..models.vae_hmm import VAEHMM

    cfg = load_config(config)
    model = VAEHMM(cfg.model, device=resolve_device(device))
    state = load_model_state(checkpoint)
    validate_params_for(model, state, what=f"checkpoint {checkpoint!r}")
    model.load_state_dict(state)
    model.eval()

    if data is not None:
        x_seq, u_seq = data
        ds = RandomChunkDataset(x_seq, u_seq, min_len=20,
                                max_len=cfg.data.max_len,
                                samples_per_epoch=batch_size * 4, seed=0)
        total, batches = 0.0, 0
        for x, _, lengths in batch_iterator(ds, batch_size):
            total += masked_recon_mse(model, x, lengths)
            batches += 1
        mean_mse = total / batches if batches else float("nan")
    else:
        mean_mse = float("nan")

    Path(os.path.dirname(output) or ".").mkdir(parents=True, exist_ok=True)
    with open(output, "w") as f:
        f.write(f"Mean Recon MSE: {mean_mse}\n")
    if log_fn:
        log_fn(f"Evaluation finished. Results saved to {output}")
    return mean_mse


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--data", nargs="*", default=None,
                        help="x_sequences u_sequences paths")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--output",
                        default="evaluation_reports/eval_results.txt")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    data = None
    if args.data and len(args.data) >= 2:
        from ..train.pipeline import load_sequences

        data = load_sequences(args.data[0], args.data[1])
    evaluate(args.config, args.checkpoint, data, args.batch_size,
             args.output, device=args.device)


if __name__ == "__main__":
    main()
