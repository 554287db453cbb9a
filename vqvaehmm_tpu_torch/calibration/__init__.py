from .calibrate import (CalibrationResult, EmpiricalStoppingCriteria,
                        EvaluationLoop, PrecisionRecallOptimizer,
                        SignalNoiseController, ThresholdCalibrator,
                        calibrate_regime_thresholds, evaluate_with_tradeoffs)
