from .portfolio import (HeadConfig, ImprovedPortfolioOptimizer,
                        RegimePortfolioOptimizer)
from .vae_hmm import VAEHMM
