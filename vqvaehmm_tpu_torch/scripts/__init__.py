"""The repo's studies and reference CLIs on the port (counterparts of the
scripts under scripts/ that drive the JAX package), each run as

    python -m vqvaehmm_tpu_torch.scripts.<name> [--device cuda|cpu]
        [--outdir artifacts_torch] ...

  throughput_quality_ab  5 seeds of the quality recipe in float32 (kernel
                         C) and bfloat16 (its tensor-core mode), scored
                         under the float32 model, paired deltas
  vq_sweep               the VQ family's codebook grid, the joint
                         HMM-consistency finetune, and 5 seeds of three arms
  crash_regime           crash-regime recall: the reference's own torch
                         model, the port's model, two oversampled pools, K=5
  fixture_model_compare  the GMM stack, the GMM with a learned chain and a
                         Gaussian HMM on the fixture panel
  quality_eval           regime recovery by decode mode on synthetic data
  vq_quality             the VQ stack on synthetic data
  quality_sweep          stickiness x noise grid of the decode modes
  ensemble_eval          seed ensembles, synthetic or on the fixture
  train                  the reference's two-stage training CLI
  backtest               the GMM-stack backtest, the equal-weight benchmark
                         and Monte Carlo

Every entry point runs on --device (the card by default; --device cpu
runs the plain versions; a CUDA device without a GPU raises) and writes
its JSON under --outdir (artifacts_torch/ by default; never artifacts/).
The studies on the fixture read <outdir>/data, the recipe's data stage
(`python -m vqvaehmm_tpu_torch.recipe --stage data --outdir <outdir>`),
and run that stage themselves where it is missing.  Each JSON carries
the JAX script's keys, the device with a card's name and power limit,
the seeds, and where a committed JAX artifact holds the same numbers,
those numbers read from artifacts/ under `jax_artifact`.  The modules
import torch and numpy and the port, never JAX, the JAX package or
scripts/.
"""
