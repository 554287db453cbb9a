"""Typed configuration, shared by the JAX package and this port.

A copy of vqvaehmm_tpu/core/config.py: that package's `__init__` imports
JAX eagerly, and the machine the port runs on has no JAX, so the copy
stays (ROADMAP.md queue 1, the standing rule on numpy-only copies).
Both packages read the same JSON files.  It is verbatim but for one
comment: that of `VQConfig.codebook_lr_scale`, which here says what the
knob does (it scales the codebook's update, not its gradient).

One dataclass-based config system replacing the reference's three ad-hoc
mechanisms (YAML dicts in configs/config.yaml, JSON dicts in
training_pipeline/train_config.json + inference_config.json, and module-level
constants in train.py:7-28).  Field names and defaults are the union of the
reference keys (reference: configs/config.yaml:1-34,
training_pipeline/train_config.json, inference_config.json).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class ModelConfig:
    """VAE_HMM architecture hyperparameters.

    Matches the reference constructor signature
    VAE_HMM(input_dim, hidden_dim, K, hidden_dim2, u_dim, trans_hidden)
    (reference: VQ_VAE_HMM_fixed.py:93).
    """

    input_dim: int = 5
    hidden_dim: int = 64
    K: int = 3
    hidden_dim2: int = 32
    u_dim: Optional[int] = 4
    trans_hidden: int = 128
    # Model family: "vae" (the reference's shipped soft-codebook VAE-HMM)
    # or "vqvae" (the true-VQ stack the reference only sketched,
    # pseudocode.txt:1-32 — models/vqvae_hmm.py + a categorical-emission
    # HMM over code indices).  The vqvae family reads its extra
    # hyperparameters from the `vq` config section; K here is the REGIME
    # count for both families.
    family: str = "vae"
    # --- TPU-native extensions (not in reference) ---
    # Compute dtype for the fast path; parity path always runs f32/highest.
    compute_dtype: str = "float32"
    # Matmul precision: "default" | "float32" | "highest".
    matmul_precision: str = "highest"
    # Conv lowering: "conv" (lax.conv) | "matmul" (shifted MXU matmuls;
    # usually faster for this model's tiny channel counts).
    conv_impl: str = "conv"
    def __post_init__(self):
        if self.family not in ("vae", "vqvae"):
            raise ValueError(f"unknown model family {self.family!r}; "
                             "expected 'vae' or 'vqvae'")


@dataclass(frozen=True)
class VQConfig:
    """Hyperparameters of the true-VQ family (model.family: vqvae).

    Implements the reference's design sketch (pseudocode.txt:1-32) as a
    first-class pipeline family: encoder -> per-timestep vector
    quantization against a codebook of `num_codes` `latent_dim`-d codes
    -> decoder, plus a `model.K`-state categorical-emission HMM over the
    discrete code sequence fit by Baum-Welch EM after training."""

    num_codes: int = 8
    latent_dim: int = 16
    commitment_beta: float = 0.25
    # multiplies the codebook's update after the optimizer step (a
    # separate effective codebook lr without a second optimizer; on the
    # gradient it would cancel inside Adam), train/vq_pipeline.py
    codebook_lr_scale: float = 1.0
    # Baum-Welch over code indices (models/hmm.fit_categorical_em)
    hmm_iters: int = 50
    hmm_restarts: int = 4
    # Half the EM restarts start from a sticky (diag-heavy) transition
    # matrix: per-timestep code symbols switch fast, and near-uniform
    # inits reliably land EM in fast-switching local optima that decode
    # regimes at chance (measured on the market fixture).
    hmm_sticky: Optional[float] = 0.97
    # Codebook health (standard VQ-VAE practice; without these the
    # fixture run collapsed to ONE used code out of 8 — gradient VQ only
    # updates assigned codes, so codes that start far from the data
    # manifold never move):
    #   data_init: initialize the codebook from encoder latents of the
    #   first training batch instead of random normals
    #   dead_code_reinit: after each epoch, restart codes whose usage
    #   fell below dead_code_min_usage (fraction of a uniform share)
    #   to random valid encoder latents
    data_init: bool = True
    dead_code_reinit: bool = True
    dead_code_min_usage: float = 0.1
    # In-loop restarts skip the last epoch (a fresh code would ship
    # untrained); if the FINAL usage still has sub-threshold codes the
    # trainer restarts them and runs up to this many extra polish epochs
    # so the archive never silently ships a near-dead code (remaining
    # dead codes are recorded in the archive's codebook_usage + warned)
    final_polish_epochs: int = 1


@dataclass(frozen=True)
class DataConfig:
    """Chunking / padding (reference: VQ_VAE_HMM_fixed.py:10-29, config.yaml:27-30)."""

    min_len: int = 20
    max_len: int = 200
    # Pad every batch to a length from this bucket ladder instead of the batch
    # max, so XLA compiles a handful of shapes instead of one per batch.
    # () or None => always pad to max_len (single compilation).
    length_buckets: Tuple[int, ...] = ()
    samples_per_epoch: int = 1000  # reference __len__ hardcodes 1000 (:17-18)
    x_sequences_path: str = "data/x_sequences.npy"
    u_sequences_path: str = "data/u_sequences.npy"
    # Hold out the LAST fraction of sequences as a validation set
    # (deterministic split; never sampled by training).  The pipeline
    # then logs a per-epoch validation ELBO (beta=1, full windows) and
    # early stopping — when enabled — tracks it instead of the training
    # loss.  0.0 (default) = reference parity, no split.
    val_fraction: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    """Training loop hyperparameters (reference: configs/config.yaml:10-16)."""

    batch_size: int = 64
    num_epochs: int = 150
    learning_rate: float = 1e-5
    beta_warmup: bool = True
    gradient_clip: Optional[float] = None  # reference train_model does not clip
    seed: int = 42
    checkpoint_dir: str = "checkpoints"
    save_freq: int = 10
    # Upper bound on optimizer steps per jitted dispatch.  0 (default) =
    # the whole epoch in ONE lax.scan — maximum throughput (the reference
    # pays a host sync per step at loss.item()).  N > 0 chunks each epoch
    # into ceil(batches/N) bounded calls with an identical trajectory —
    # use when one dispatch must not outlive an external bound
    # (timeout-guarded on-chip stages, preemptible runs).
    steps_per_call: int = 0
    # Learning-rate schedule (train/trainer.py::make_lr_schedule):
    # "constant" (default, reference parity — fixed lr, train.py:28),
    # "cosine" or "linear" decay to final_lr_frac*lr over the run, each
    # with an optional linear warmup.  The schedule rides the optimizer
    # step count in the checkpointed opt_state, so resume continues it.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    final_lr_frac: float = 0.0
    # Early stopping: stop when the epoch loss has not improved by more
    # than early_stop_min_delta for early_stop_patience epochs.  0
    # (default) = off, the reference-parity fixed-epoch run.  Enabling
    # it forces a per-epoch host sync of the loss (the same cost live
    # logging pays), so epochs no longer pipeline — worth it only when
    # epochs are expensive relative to one dispatch round-trip.  The
    # best-loss/wait counters persist in the periodic-checkpoint
    # metadata, so a preempted-and-resumed run stops at the same epoch.
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    # The fused loss-and-gradients kernel (ops/fused_train.py).  "auto"
    # (default) takes it on a CUDA device and the plain path on the CPU;
    # true forces it; false takes the plain path (compute_loss and
    # autograd).  On a CUDA device a shape the kernel's gate refuses
    # raises (train/trainer.py::resolve_fused).
    fused: Union[bool, str] = "auto"
    # "host": epochs assembled on the host (native C sampler + prefetch,
    # the reference's DataLoader shape).  "device": the sequence pool
    # lives in HBM and each epoch ships only index triples — the gather
    # runs inside the training scan (data/device_sampler.py; the host
    # path is ~93x too slow to feed the fused step on this 1-core host,
    # BENCH_NOTES.md).  "auto" (default): device on TPU, host elsewhere
    # (train/trainer.py::resolve_input_pipeline) — the measured-fast
    # path is the default, not a knob (round-3 VERDICT item 1).
    input_pipeline: str = "auto"
    # When set, capture a jax.profiler trace (TensorBoard/Perfetto) of
    # one steady-state epoch into this directory — the epoch after the
    # first, so compile time never pollutes the trace (SURVEY.md §5:
    # tracing as a first-class feature; utils/profiling.py).
    profile_dir: Optional[str] = None
    # When non-empty, train EVERY listed seed simultaneously in one
    # vmapped loop (train/ensemble.py) and checkpoint the member with
    # the best final loss; per-member histories go to the checkpoint
    # metadata.  Incompatible with resume/periodic checkpoints (the
    # ensemble run is one shot).
    ensemble_seeds: tuple = ()

    def __post_init__(self):
        if self.input_pipeline not in ("auto", "host", "device"):
            # a typo here would otherwise silently fall back to the
            # ~150x-slower host path (review finding)
            raise ValueError(
                f"unknown input_pipeline {self.input_pipeline!r}; "
                "expected 'auto', 'host' or 'device'")
        if self.fused not in (True, False, "auto"):
            raise ValueError(
                f"unknown fused {self.fused!r}; expected true, false "
                "or 'auto'")


@dataclass(frozen=True)
class PortfolioConfig:
    """Downstream head hyperparameters (reference: configs/config.yaml:18-24)."""

    n_assets: int = 10
    hidden_dim: int = 64
    transaction_cost: float = 0.001
    max_weight: float = 0.3
    risk_free_rate: float = 0.0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for SPMD execution. The reference is single-device
    (SURVEY.md section 2.9); here data-parallelism over ICI is
    first-class.  The data axis is named "data" throughout the framework
    (every PartitionSpec/psum spells it out) — it is a contract, not a
    config knob."""

    # None => use all visible devices on the data axis.
    num_devices: Optional[int] = None


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainConfig = field(default_factory=TrainConfig)
    portfolio: PortfolioConfig = field(default_factory=PortfolioConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    vq: VQConfig = field(default_factory=VQConfig)
    checkpoint_path: str = "checkpoints/vae_hmm_trained"
    head_checkpoint_path: Optional[str] = None


# ---------------------------------------------------------------------------
# Loading / merging
# ---------------------------------------------------------------------------

_SECTION_TYPES = {
    "model": ModelConfig,
    "data": DataConfig,
    "training": TrainConfig,
    "portfolio": PortfolioConfig,
    "mesh": MeshConfig,
    "vq": VQConfig,
}

# Reference configs use a few alternative key spellings; accept them all.
_KEY_ALIASES = {
    "training": {"epochs": "num_epochs", "lr": "learning_rate"},
}


def _coerce_section(name: str, cls, raw: Dict[str, Any]):
    aliases = _KEY_ALIASES.get(name, {})
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in raw.items():
        k = aliases.get(k, k)
        if k in known:
            if k == "length_buckets" and v is not None:
                v = tuple(v)
            kwargs[k] = v
    return cls(**kwargs)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Build a Config from a nested dict (JSON/YAML payload).

    Unknown keys are ignored so reference train_config.json /
    inference_config.json files load unchanged.
    """
    sections = {}
    for name, cls in _SECTION_TYPES.items():
        if name in raw and isinstance(raw[name], dict):
            sections[name] = _coerce_section(name, cls, raw[name])
    top = {}
    for key in ("checkpoint_path", "head_checkpoint_path"):
        if key in raw:
            top[key] = raw[key]
    return Config(**sections, **top)


def load_config(path: str) -> Config:
    """Load a Config from a .json or .yaml/.yml file.

    Replaces the reference's load_config variants
    (training_pipeline/train.py:24-34, inference_api/app.py:29-39).
    """
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
    elif path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
    else:
        raise ValueError(f"Unsupported config format: {path}")
    return config_from_dict(raw or {})


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply CLI 'section.key=value' overrides, e.g. 'training.lr=1e-4'."""
    raw = config_to_dict(cfg)
    for item in overrides:
        key, _, value = item.partition("=")
        parts = key.strip().split(".")
        node = raw
        for p in parts[:-1]:
            node = node[p]
        leaf = parts[-1]
        section = parts[0] if len(parts) > 1 else None
        leaf = _KEY_ALIASES.get(section, {}).get(leaf, leaf)
        try:
            node[leaf] = json.loads(value)
        except json.JSONDecodeError:
            node[leaf] = value
    return config_from_dict(raw)
