"""Threshold calibration, signal/noise control, empirical stopping
(reference: calibration.py:1-256).

The port's copy of vqvaehmm_tpu/calibration/calibrate.py (numpy only:
that package's `__init__` imports JAX, and the machine the port runs on
has none).  It is verbatim but for this paragraph, the docstrings of
calibrate_regime_thresholds (whose posterior_fn may return a torch
tensor on the card: on a CUDA device VAEHMM.posterior is the encoder
kernel) and evaluate_with_tradeoffs (which imports pandas lazily, as the
JAX copy does: where pandas is missing, as on the card's machine, it
raises ImportError, exactly as the JAX copy would), and the tensor's move
to the host.

Host-side numpy by design: these are small threshold sweeps over
already-computed predictions — scheduling them on the TPU would cost more
in transfers than the math.  The vectorized sweep in ThresholdCalibrator
evaluates all thresholds at once instead of the reference's Python loop.
Names follow the canonical library API (the reference's
examples/calibration_example.py drifted from it — SURVEY.md section 4.1;
we match calibration.py, the real surface).

Reference-faithful quirks kept deliberately (parity is this module's
contract; each matches the reference line for line):
* ThresholdCalibrator's constraint-miss fallback scans the curve
  ACCUMULATED across every calibrate() call on the instance
  (calibration.py:43), so reuse across datasets can return a result
  from earlier data — use a fresh calibrator per dataset to avoid it.
* SignalNoiseController.find_threshold truncates the quantile index
  with int() (calibration.py:86): float error can land one index low
  for ratios like 0.8/0.9 (int(10*0.0999...) == 0).
* evaluate_quality scores NON-binary labels as wrong on both branches
  (calibration.py:97-105), unlike _eval_thresholds which excludes
  them from fp — the two metrics disagree on e.g. -1 labels.
* EmpiricalStoppingCriteria silently reads 0.0 for a missing metric
  key (calibration.py:130), and EvaluationLoop accumulates results/
  stopping state across run() calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclass
class CalibrationResult:
    """(reference: calibration.py:7-17)"""

    threshold: float
    precision: float
    recall: float
    f1_score: float
    signal_ratio: float
    noise_ratio: float
    true_positives: int
    false_positives: int
    false_negatives: int


def _eval_thresholds(preds: np.ndarray, targets: np.ndarray,
                     thresholds: np.ndarray) -> List[CalibrationResult]:
    """All thresholds in one broadcasted comparison: (n_thresh, n_preds)
    boolean matrix, confusion counts reduced along axis 1."""
    thresholds = np.atleast_1d(np.asarray(thresholds, float))
    pred_bin = preds[None, :] >= thresholds[:, None]
    pos = targets == 1
    neg = targets == 0  # NOT ~pos: non-binary labels stay excluded
    tp = (pred_bin & pos[None, :]).sum(1)
    fp = (pred_bin & neg[None, :]).sum(1)
    fn = ((~pred_bin) & pos[None, :]).sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(prec + rec > 0,
                      2 * prec * rec / np.maximum(prec + rec, 1e-300), 0.0)
    sig = pred_bin.mean(1)
    return [CalibrationResult(float(t), float(p), float(r), float(f),
                              float(s), float(1 - s), int(a), int(b), int(c))
            for t, p, r, f, s, a, b, c
            in zip(thresholds, prec, rec, f1, sig, tp, fp, fn)]


def _eval_threshold(preds: np.ndarray, targets: np.ndarray,
                    thresh: float) -> CalibrationResult:
    return _eval_thresholds(preds, targets, np.array([thresh]))[0]


class ThresholdCalibrator:
    """Sweep thresholds, pick best F1 subject to precision/recall floors
    (reference: calibration.py:20-76)."""

    def __init__(self, min_precision: float = 0.7, min_recall: float = 0.5):
        self.min_precision = min_precision
        self.min_recall = min_recall
        self.curve: List[CalibrationResult] = []

    def calibrate(self, preds, targets, thresholds=None) -> CalibrationResult:
        preds = np.asarray(preds)
        targets = np.asarray(targets)
        if thresholds is None:
            thresholds = np.linspace(preds.min(), preds.max(), 100)
        results = _eval_thresholds(preds, targets, thresholds)
        self.curve.extend(results)
        best = None
        best_f1 = 0.0
        for r in results:
            if r.precision >= self.min_precision and \
                    r.recall >= self.min_recall and r.f1_score > best_f1:
                best_f1 = r.f1_score
                best = r
        if best is None:
            best = max(self.curve, key=lambda r: r.f1_score)
        return best

    def get_pr_curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.array([r.precision for r in self.curve]),
                np.array([r.recall for r in self.curve]),
                np.array([r.threshold for r in self.curve]))


class SignalNoiseController:
    """Quantile threshold for a target signal ratio + quality decomposition
    (reference: calibration.py:79-117)."""

    def __init__(self, target_signal_ratio: float = 0.3,
                 tolerance: float = 0.05):
        self.target_ratio = target_signal_ratio
        self.tolerance = tolerance

    def find_threshold(self, preds) -> float:
        sorted_p = np.sort(np.asarray(preds))
        idx = int(len(sorted_p) * (1 - self.target_ratio))
        idx = min(idx, len(sorted_p) - 1)
        return float(sorted_p[idx])

    def evaluate_quality(self, preds, targets, thresh: float) -> Dict[str, float]:
        preds = np.asarray(preds)
        targets = np.asarray(targets)
        signals = preds >= thresh
        sig_ratio = signals.sum() / len(signals)
        if signals.sum() > 0:
            sig_qual = float(((preds[signals] >= thresh).astype(int)
                              == targets[signals]).mean())
        else:
            sig_qual = 0.0
        noise = ~signals
        if noise.sum() > 0:
            noise_qual = float(((preds[noise] < thresh).astype(int)
                                == (1 - targets[noise])).mean())
        else:
            noise_qual = 0.0
        return {
            "signal_ratio": float(sig_ratio),
            "signal_quality": sig_qual,
            "noise_ratio": float(1 - sig_ratio),
            "noise_quality": noise_qual,
            "overall_quality": float(sig_ratio * sig_qual
                                     + (1 - sig_ratio) * noise_qual),
        }


class EmpiricalStoppingCriteria:
    """Patience-based stop + variance-window convergence
    (reference: calibration.py:120-147)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.001,
                 metric: str = "f1_score"):
        self.patience = patience
        self.min_delta = min_delta
        self.metric = metric
        self.history: List[float] = []
        self.best = -np.inf
        self.wait = 0

    def should_stop(self, metrics: Dict[str, float]) -> bool:
        val = metrics.get(self.metric, 0.0)
        self.history.append(val)
        if val > self.best + self.min_delta:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
        return self.wait >= self.patience

    def get_curve(self) -> np.ndarray:
        return np.array(self.history)

    def is_converged(self, window: int = 5) -> bool:
        if len(self.history) < window:
            return False
        return float(np.var(self.history[-window:])) < self.min_delta ** 2


class PrecisionRecallOptimizer:
    """Weighted precision/recall threshold search over percentiles
    (reference: calibration.py:150-184)."""

    def __init__(self, precision_weight: float = 0.5):
        self.prec_w = precision_weight
        self.rec_w = 1 - precision_weight

    def optimize(self, preds, targets, thresholds=None
                 ) -> Tuple[float, Dict[str, float]]:
        preds = np.asarray(preds)
        targets = np.asarray(targets)
        if thresholds is None:
            thresholds = np.percentile(preds, np.linspace(0, 100, 50))
        results = _eval_thresholds(preds, targets, thresholds)
        scores = np.array([self.prec_w * r.precision + self.rec_w * r.recall
                           for r in results])
        i = int(scores.argmax())
        r = results[i]
        return r.threshold, {
            "precision": r.precision,
            "recall": r.recall,
            "f1_score": r.f1_score,
            "weighted_score": float(scores[i]),
        }


class EvaluationLoop:
    """Iterate evaluate -> calibrate -> stopping until converged
    (reference: calibration.py:187-226)."""

    def __init__(self, calibrator: ThresholdCalibrator,
                 stopping: EmpiricalStoppingCriteria):
        self.calibrator = calibrator
        self.stopping = stopping
        self.results: List[CalibrationResult] = []

    def run(self, predict_fn: Callable, val_batches, max_iter: int = 100):
        """predict_fn: x -> scores; val_batches: iterable of (x, y).

        val_batches is materialized once: the reference consumes a
        re-iterable DataLoader, so a one-shot generator here would be
        silently exhausted after iteration 1 and crash iteration 2."""
        val_batches = list(val_batches)
        if not val_batches:
            raise ValueError("val_batches is empty")
        for _ in range(max_iter):
            preds, targets = [], []
            for x, y in val_batches:
                preds.append(np.asarray(predict_fn(x)))
                targets.append(np.asarray(y))
            preds = np.concatenate(preds)
            targets = np.concatenate(targets)
            result = self.calibrator.calibrate(preds, targets)
            self.results.append(result)
            metrics = {"f1_score": result.f1_score,
                       "precision": result.precision,
                       "recall": result.recall}
            if self.stopping.should_stop(metrics):
                break
        return {
            "best_result": max(self.results, key=lambda r: r.f1_score),
            "iterations": len(self.results),
            "converged": self.stopping.is_converged(),
            "curve": self.stopping.get_curve(),
        }


def calibrate_regime_thresholds(posterior_fn: Callable, data, true_regimes,
                                K: int) -> Dict[int, float]:
    """Per-regime one-vs-rest threshold calibration from mean posterior
    (reference: calibration.py:229-242).  posterior_fn(data) -> (B, K, T)
    regime probabilities, a numpy array or a torch tensor on any device
    (VAEHMM.posterior under torch.inference_mode, for one)."""
    probs = posterior_fn(data)
    if hasattr(probs, "detach"):              # a torch tensor
        probs = probs.detach().cpu().numpy()
    probs = np.asarray(probs)  # (B, K, T)
    true_regimes = np.asarray(true_regimes)
    thresholds = {}
    for k in range(K):
        cal = ThresholdCalibrator(min_precision=0.6, min_recall=0.5)
        targets = (true_regimes == k).astype(int)
        preds = probs[:, k, :].mean(axis=1)
        thresholds[k] = cal.calibrate(preds, targets).threshold
    return thresholds


def evaluate_with_tradeoffs(preds, targets,
                            weights=np.linspace(0, 1, 11)):
    """Precision-weight sweep -> DataFrame (reference: calibration.py:245-256).
    Needs pandas: without it (the card's machine has none) the import
    below raises ImportError, as in the JAX copy."""
    import pandas as pd

    rows = []
    for w in weights:
        opt = PrecisionRecallOptimizer(precision_weight=w)
        thresh, metrics = opt.optimize(preds, targets)
        metrics["precision_weight"] = float(w)
        metrics["threshold"] = thresh
        rows.append(metrics)
    return pd.DataFrame(rows)
