"""vqvaehmm_tpu_torch — the PyTorch/CUDA port of vqvaehmm_tpu for NVIDIA
Hopper (H100).

The JAX package `vqvaehmm_tpu` beside it is the reference each module is
held against; this package imports torch and numpy only, never JAX.  It
mirrors the reference's layout (core/, ops/, models/, data/, serve/), and
its kernels are hand-written CUDA under csrc/, built on first use by
ops/_build.py.
"""

from .core.config import Config, ModelConfig, load_config
from .models.vae_hmm import VAEHMM
