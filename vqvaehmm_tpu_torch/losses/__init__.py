from .portfolio import (adversarial_portfolio_loss, calmar_loss,
                        delta_hedge_loss, minimum_variance_hedge_ratio,
                        optimal_hedge_frequency, portfolio_loss,
                        regime_aware_sharpe_loss, regime_conditional_loss,
                        risk_parity_loss, sharpe_loss, sortino_loss,
                        transition_aware_loss)
