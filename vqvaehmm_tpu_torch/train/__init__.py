from .trainer import (ClippedAdam, Trainer, TrainState, beta_schedule,
                      make_lr_schedule, make_optimizer, resolve_fused,
                      resolve_input_pipeline, train_model, train_step)
from .heads import (HeadTrainResult, train_delta_hedger, train_portfolio,
                    train_portfolio_fused, train_portfolio_optimizer)
from .strategies import (MetaPortfolioOptimizer, OnlinePortfolioOptimizer,
                         WalkForwardTrainer)
