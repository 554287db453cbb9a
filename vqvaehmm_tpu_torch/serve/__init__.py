from .app import InferenceModel, get_model, load_portfolio_head
