"""Synthetic market-like data for tests and benchmarks.

A verbatim copy of vqvaehmm_tpu/data/synthetic.py (numpy only): the
JAX package cannot be imported without JAX, and the machine the port
runs on has none.  The training pipeline falls back to it when the
data files are missing, as the JAX pipeline does.

The reference relies on yfinance downloads (data_loader.py:9-25) or inline
torch.randn (examples/train_example.py:53, tests/smoke_test.py:31-32).  This
generator produces regime-switching sequences with the same shapes as the
real pipeline — x:(N, input_dim, T) features and u:(N, u_dim, T) exogenous
covariates — without network access, and with known ground-truth regime
paths for HMM/calibration tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_sequences(n_sequences: int = 8, seq_len: int = 200,
                        input_dim: int = 5, u_dim: int = 4, K: int = 3,
                        seed: int = 0, stickiness: float = 0.95,
                        noise_scale: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regime-switching Gaussian sequences.

    Returns (x:(N,C,T), u:(N,U,T), regimes:(N,T) int) where each regime has
    its own feature mean/scale and the hidden path follows a sticky Markov
    chain — so encoders have real signal to find and HMM decoders have a
    ground truth to be scored against.  noise_scale multiplies the emission
    noise (higher = lower per-step SNR — the regime where temporal
    smoothing must carry the decode).
    """
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 1.0, size=(K, input_dim))
    scales = (0.3 + rng.uniform(0.0, 0.4, size=(K, input_dim))) * noise_scale
    u_means = rng.normal(0.0, 1.0, size=(K, u_dim))

    A = np.full((K, K), (1.0 - stickiness) / max(K - 1, 1))
    np.fill_diagonal(A, stickiness)

    xs = np.zeros((n_sequences, input_dim, seq_len), np.float32)
    us = np.zeros((n_sequences, u_dim, seq_len), np.float32)
    zs = np.zeros((n_sequences, seq_len), np.int32)
    for n in range(n_sequences):
        z = rng.integers(0, K)
        for t in range(seq_len):
            z = rng.choice(K, p=A[z])
            zs[n, t] = z
            xs[n, :, t] = means[z] + scales[z] * rng.normal(size=input_dim)
            us[n, :, t] = u_means[z] + 0.2 * rng.normal(size=u_dim)
    return xs, us, zs


def synthetic_returns(n_batches: int, batch_size: int, horizon: int = 20,
                      n_assets: int = 10, seed: int = 0) -> np.ndarray:
    """Asset-return windows shaped (N, B, horizon, n_assets) for portfolio
    head training (reference samples random 20-day windows, train.py:70-72)."""
    rng = np.random.default_rng(seed)
    return rng.normal(5e-4, 0.01,
                      size=(n_batches, batch_size, horizon, n_assets)
                      ).astype(np.float32)
