"""Calibration workflow example (the JAX package's
examples/calibration_example.py on the port): precision/recall-
constrained thresholds, signal/noise control, empirical stopping, a
weighted precision/recall search with its trade-off table, and an
evaluation loop.

numpy only, so it touches no device (--device is accepted and unused).
Step 4's trade-off table (`evaluate_with_tradeoffs(...).head()`) is a
pandas DataFrame, as in JAX: the example needs pandas, which the card's
machine does not have, so it runs where pandas is installed (the CPU
tests).

    python -m vqvaehmm_tpu_torch.examples.calibration_example
"""

import numpy as np

from ..calibration import (EmpiricalStoppingCriteria, EvaluationLoop,
                           PrecisionRecallOptimizer, SignalNoiseController,
                           ThresholdCalibrator, evaluate_with_tradeoffs)
from . import parser


def run(device="cpu", log_fn=print) -> dict:
    """The example; each step's result is printed by log_fn as the JAX
    example prints it, and returned."""
    log_fn = log_fn or (lambda *a: None)
    rng = np.random.default_rng(0)
    n = 1000
    targets = rng.integers(0, 2, n)
    preds = np.clip(0.55 * targets + rng.normal(0.25, 0.15, n), 0, 1)
    out = {}

    # 1. precision/recall-constrained calibration
    cal = ThresholdCalibrator(min_precision=0.7, min_recall=0.5)
    best = out["best"] = cal.calibrate(preds, targets)
    log_fn(f"Optimal threshold: {best.threshold:.3f}")
    log_fn(f"F1 Score: {best.f1_score:.3f} "
           f"(P={best.precision:.3f}, R={best.recall:.3f})")
    prec, rec, thr = cal.get_pr_curve()
    log_fn(f"PR curve points: {len(prec)}")

    # 2. signal/noise control
    controller = SignalNoiseController(target_signal_ratio=0.3)
    threshold = controller.find_threshold(preds)
    quality = out["quality"] = controller.evaluate_quality(preds, targets,
                                                           threshold)
    log_fn(f"signal threshold {threshold:.3f} -> quality {quality}")

    # 3. empirical stopping
    stopping = EmpiricalStoppingCriteria(patience=5, min_delta=0.001)
    for epoch in range(50):
        f1 = 0.8 - 0.3 * np.exp(-epoch / 5) + rng.normal(0, 0.002)
        if stopping.should_stop({"f1_score": f1}):
            out["stopped_at"] = epoch
            log_fn(f"stopped at epoch {epoch}, best={stopping.best:.4f}")
            break
    log_fn(f"converged: {stopping.is_converged()}")

    # 4. weighted precision/recall search + tradeoff table
    opt = PrecisionRecallOptimizer(precision_weight=0.7)
    thresh, metrics = opt.optimize(preds, targets)
    out["weighted"] = (thresh, metrics)
    log_fn(f"precision-weighted threshold {thresh:.3f}: {metrics}")
    log_fn(evaluate_with_tradeoffs(preds, targets).head())

    # 5. evaluation loop with stopping
    batches = [(preds[i::4], targets[i::4]) for i in range(4)]
    loop = EvaluationLoop(ThresholdCalibrator(),
                          EmpiricalStoppingCriteria(patience=2))
    res = out["loop"] = loop.run(lambda x: x, batches, max_iter=20)
    log_fn(f"loop: {res['iterations']} iters, "
           f"best F1 {res['best_result'].f1_score:.3f}")
    return out


def main(argv=None) -> int:
    parser("calibration_example", __doc__.splitlines()[0]).parse_args(argv)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
