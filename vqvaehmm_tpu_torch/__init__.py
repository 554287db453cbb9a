"""vqvaehmm_tpu_torch — the PyTorch/CUDA port of vqvaehmm_tpu for NVIDIA
Hopper (H100).

The JAX package `vqvaehmm_tpu` beside it is the reference each module is
held against; this package imports torch and numpy only, never JAX.  It
mirrors the reference's layout (core/, ops/, models/, data/, train/,
parallel/, serve/), and its kernels are hand-written CUDA under csrc/,
built on first use by ops/_build.py.

The top-level names are the JAX package's, but for its functional trainer
API (`create_train_state`, `make_train_step`), whose torch form is
`TrainState`, `train.trainer.make_optimizer` and `train.trainer.train_step`.
"""

from .core.config import (Config, DataConfig, MeshConfig, ModelConfig,
                          PortfolioConfig, TrainConfig, apply_overrides,
                          config_from_dict, load_config)
from .models.vae_hmm import VAEHMM, make_model
from .data.dataset import RandomChunkDataset, collate_fn, batch_iterator
from .train.trainer import (TrainState, beta_schedule, make_epoch_step,
                            train_model)

__version__ = "0.1.0"

__all__ = [
    "Config", "ModelConfig", "DataConfig", "TrainConfig", "PortfolioConfig",
    "MeshConfig", "load_config", "config_from_dict", "apply_overrides",
    "VAEHMM", "make_model",
    "RandomChunkDataset", "collate_fn", "batch_iterator",
    "TrainState", "train_model", "make_epoch_step", "beta_schedule",
]
