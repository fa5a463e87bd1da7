from .optimizers import (AdamState, OptimizerConfig, adamw, make_optimizer,
                         momentum_sgd, sgd)

__all__ = ["AdamState", "OptimizerConfig", "adamw", "make_optimizer",
           "momentum_sgd", "sgd"]
