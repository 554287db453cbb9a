from .portfolio import (HeadConfig, ImprovedPortfolioOptimizer,
                        RegimePortfolioOptimizer)
from .vae_hmm import VAEHMM
from .hmm import (CategoricalEmission, GaussianEmission, HiddenMarkovModel,
                  fit_categorical_em, fit_gaussian_em, fit_transitions_em)
from .vqvae_hmm import VQVAEConfig, VQVAEHMM
