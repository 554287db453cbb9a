from .portfolio import HeadConfig, RegimePortfolioOptimizer
from .vae_hmm import VAEHMM
