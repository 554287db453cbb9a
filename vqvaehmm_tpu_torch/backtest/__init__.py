from .backtester import (Backtester, BacktestResult, RegimeBacktest,
                         WalkForwardBacktest, compare_strategies,
                         plot_results)
from .montecarlo import (analyze_monte_carlo, monte_carlo_draws,
                         monte_carlo_simulation, plot_monte_carlo,
                         regime_statistics, simulate_paths)
