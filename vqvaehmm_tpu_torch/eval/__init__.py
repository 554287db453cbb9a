from .evaluate import evaluate, masked_recon_mse
