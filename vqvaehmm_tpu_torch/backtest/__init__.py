from .backtester import (Backtester, BacktestResult, RegimeBacktest,
                         WalkForwardBacktest, compare_strategies,
                         plot_results)
