"""Gradio demo UI for the port (counterpart of
vqvaehmm_tpu/serve/gradio_app.py): market data typed into a text box ->
regime posterior -> portfolio head -> allocation table and a named regime
(Bull/Bear/Neutral).  gradio is imported only by `build_demo`.

The demo's head is the served model's configured head checkpoint where
one is set (`head_checkpoint_path`, the head /predict uses), else a
TransformerPortfolioOptimizer drawn from a Generator seeded with 0, as
the JAX demo builds one from PRNGKey(0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

REGIME_NAMES = ["Bull", "Bear", "Neutral"]


def parse_market_text(text: str, input_dim: int = 5) -> np.ndarray:
    """Comma-, space- or newline-separated floats as a (1, C, T) float32
    array: C rows of T values (one row a line), or a flat list read as C
    feature rows."""
    def parse_floats(s: str) -> np.ndarray:
        toks = s.replace(",", " ").split()
        return np.array([float(t) for t in toks], np.float64)

    rows = [r.strip() for r in text.strip().splitlines() if r.strip()]
    if len(rows) == input_dim:
        data = [parse_floats(r) for r in rows]
        T = min(len(d) for d in data)
        if T < 3:
            raise ValueError("need at least 3 timesteps per feature row")
        return np.stack([d[:T] for d in data])[None].astype(np.float32)
    flat = parse_floats(text)
    if flat.size < input_dim * 3:
        raise ValueError(
            f"need at least {input_dim * 3} values ({input_dim} features x "
            f">=3 timesteps)")
    T = flat.size // input_dim
    return flat[:input_dim * T].reshape(1, input_dim, T).astype(np.float32)


def run_inference(text: str, posterior_fn, weight_fn,
                  tickers: Optional[list] = None, input_dim: int = 5):
    """(regime name, {name: probability}, {ticker: "w%"}) of one text.
    posterior_fn maps a (1, C, T) numpy array to the (1, K, T) posterior,
    weight_fn that posterior to (1, A) weights, both as numpy arrays."""
    x = parse_market_text(text, input_dim)
    q = np.asarray(posterior_fn(x))                  # (1, K, T)
    weights = np.asarray(weight_fn(q))[0]
    k = int(q[0, :, -1].argmax())
    regime = REGIME_NAMES[k] if k < len(REGIME_NAMES) else f"Regime {k}"
    tickers = tickers or [f"ASSET{i}" for i in range(len(weights))]
    alloc = {t: f"{w * 100:.2f}%" for t, w in zip(tickers, weights)}
    return regime, {n: float(p) for n, p in
                    zip(REGIME_NAMES[:q.shape[1]], q[0, :, -1])}, alloc


def make_infer_fn(config_path: str = "inference_config.json",
                  device="cuda"):
    """The demo's click callback, text -> (regime, probs, allocation),
    independent of gradio.  The posterior is `VAEHMM.posterior` (kernel 8
    on a CUDA device); the head is the configured head checkpoint's, or a
    seeded TransformerPortfolioOptimizer where none is set."""
    from ..models.portfolio import HeadConfig, TransformerPortfolioOptimizer
    from .app import get_model

    m = get_model(config_path, device)
    dev = m.device
    if m.cfg.head_checkpoint_path:
        head = m._get_head()
    else:
        head = TransformerPortfolioOptimizer(
            HeadConfig(K=m.cfg.model.K, n_assets=m.cfg.portfolio.n_assets,
                       hidden_dim=m.cfg.portfolio.hidden_dim),
            device=dev, generator=torch.Generator().manual_seed(0)).eval()

    def posterior_fn(x):
        with torch.inference_mode():
            return m.model.posterior(torch.from_numpy(x).to(dev)).cpu() \
                .numpy()

    def weight_fn(q):
        with torch.inference_mode():
            return head(torch.from_numpy(q).to(dev)).cpu().numpy()

    def infer(text):
        return run_inference(text, posterior_fn, weight_fn,
                             input_dim=m.cfg.model.input_dim)

    return infer


def build_demo(config_path: str = "inference_config.json", device="cuda"):
    """The Gradio Blocks app (needs `pip install gradio`)."""
    import gradio as gr

    infer = make_infer_fn(config_path, device)

    with gr.Blocks(title="VQ-VAE-HMM regime detection") as demo:
        gr.Markdown("# Market regime detection & allocation")
        inp = gr.Textbox(lines=6, label="Market data "
                         "(5 feature rows x T timesteps)")
        btn = gr.Button("Analyze")
        regime = gr.Textbox(label="Current regime")
        probs = gr.JSON(label="Regime probabilities")
        alloc = gr.JSON(label="Allocation")
        btn.click(infer, inputs=inp, outputs=[regime, probs, alloc])
    return demo


if __name__ == "__main__":
    build_demo().launch()
