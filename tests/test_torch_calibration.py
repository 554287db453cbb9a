"""The port's calibration module (vqvaehmm_tpu_torch/calibration/, a numpy
copy of vqvaehmm_tpu/calibration/calibrate.py) against the JAX copy on the
same inputs: every class and function gives the same results (exactly,
since both are the same numpy), and calibrate_regime_thresholds with
posterior_fn = the port's VAEHMM.posterior matches it with JAX's
VAEHMM.posterior on the same parameters (thresholds within 1e-5)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqvaehmm_tpu.calibration as jc
import vqvaehmm_tpu_torch.calibration as tc
from tests.torch_port import inputs, model_pair


def _data(seed=0, n=300):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 2, n)
    preds = np.where(targets == 1, 0.7, 0.3) + rng.normal(0, 0.15, n)
    return preds, targets


def _results(rs):
    return [dataclasses.astuple(r) for r in rs]


@pytest.mark.parametrize("floors", [(0.7, 0.5), (0.99, 0.99)])
def test_threshold_calibrator_as_jax(floors):
    """Best F1 under the floors, and the fallback over the whole curve
    accumulated across calls where the floors cannot be met."""
    j, p = jc.ThresholdCalibrator(*floors), tc.ThresholdCalibrator(*floors)
    for seed in (0, 1):
        preds, targets = _data(seed)
        assert dataclasses.astuple(p.calibrate(preds, targets)) == \
            dataclasses.astuple(j.calibrate(preds, targets))
    assert _results(p.curve) == _results(j.curve)
    for a, b in zip(p.get_pr_curve(), j.get_pr_curve()):
        assert np.array_equal(a, b)


def test_signal_noise_stopping_and_optimizer_as_jax():
    preds, targets = _data(2)
    for ratio in (0.3, 0.8, 0.9):
        j, p = jc.SignalNoiseController(ratio), tc.SignalNoiseController(ratio)
        th = p.find_threshold(preds)
        assert th == j.find_threshold(preds)
        assert p.evaluate_quality(preds, targets, th) == \
            j.evaluate_quality(preds, targets, th)
    j, p = jc.EmpiricalStoppingCriteria(3, 0.01), \
        tc.EmpiricalStoppingCriteria(3, 0.01)
    for v in (0.5, 0.6, 0.7, 0.7, 0.705, 0.7):
        assert p.should_stop({"f1_score": v}) == \
            j.should_stop({"f1_score": v})
        assert p.is_converged(3) == j.is_converged(3)
    assert p.should_stop({}) == j.should_stop({})     # a missing key reads 0
    assert np.array_equal(p.get_curve(), j.get_curve())
    for w in (0.0, 0.3, 1.0):
        assert tc.PrecisionRecallOptimizer(w).optimize(preds, targets) == \
            jc.PrecisionRecallOptimizer(w).optimize(preds, targets)


def test_evaluation_loop_and_tradeoffs_as_jax():
    preds, targets = _data(3)
    batches = [(preds[i:i + 100], targets[i:i + 100])
               for i in range(0, 300, 100)]

    def run(mod):
        loop = mod.EvaluationLoop(mod.ThresholdCalibrator(),
                                  mod.EmpiricalStoppingCriteria(patience=2))
        out = loop.run(lambda x: x, iter(batches), max_iter=10)
        return (dataclasses.astuple(out["best_result"]), out["iterations"],
                out["converged"], out["curve"].tolist())

    assert run(tc) == run(jc)
    with pytest.raises(ValueError, match="empty"):
        tc.EvaluationLoop(tc.ThresholdCalibrator(),
                          tc.EmpiricalStoppingCriteria()).run(
            lambda x: x, [])
    got = tc.evaluate_with_tradeoffs(preds, targets)
    want = jc.evaluate_with_tradeoffs(preds, targets)
    assert list(got.columns) == list(want.columns)
    assert np.array_equal(got.values, want.values)


def test_regime_thresholds_on_the_posterior_as_jax():
    """posterior_fn = VAEHMM.posterior on both packages, one parameter
    set: the port's takes a tensor and returns one (moved to the host by
    calibrate_regime_thresholds)."""
    jm, params, tm = model_pair(seed=4)
    x, _, _ = inputs(12, 30, seed=5)
    true = np.random.default_rng(6).integers(0, 3, size=12)
    want = jc.calibrate_regime_thresholds(
        lambda d: jm.posterior(params, jnp.asarray(d)), x, true, 3)
    with torch.inference_mode():
        got = tc.calibrate_regime_thresholds(tm.posterior,
                                             torch.from_numpy(x), true, 3)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for k in range(3):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
