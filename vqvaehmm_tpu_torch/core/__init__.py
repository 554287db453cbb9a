from .config import Config, ModelConfig, load_config
from .masking import length_mask, pairwise_mask
