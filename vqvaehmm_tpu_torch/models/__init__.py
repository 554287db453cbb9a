from .portfolio import (AttentionPortfolioOptimizer,
                        BayesianPortfolioOptimizer,
                        EnsemblePortfolioOptimizer, HeadConfig,
                        HierarchicalPortfolioOptimizer,
                        ImprovedPortfolioOptimizer,
                        RegimeLSTMOptimizer, RegimePortfolioOptimizer,
                        TransformerPortfolioOptimizer)
from .hedging import (DynamicDeltaHedger, LSTMDeltaHedger, RegimeDeltaHedger,
                      TransactionCostAwareHedger, TransitionAwareHedger)
from .regime import (ForwardTransitionPredictor, RegimeChangeDetector,
                     RegimeFactorModel, RegimePersistenceModel,
                     TemperatureScaling, calibrate_probabilities,
                     confidence_based_sizing, estimate_regime_covariance,
                     optimize_leverage, optimize_rebalancing_frequency)
from .vae_hmm import VAEHMM
from .hmm import (CategoricalEmission, GaussianEmission, HiddenMarkovModel,
                  fit_categorical_em, fit_gaussian_em, fit_transitions_em)
from .vqvae_hmm import VQVAEConfig, VQVAEHMM
