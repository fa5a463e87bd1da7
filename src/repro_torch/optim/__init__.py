from .optimizers import (AdamState, OptimizerConfig, adamw, make_optimizer,
                         sgd)

__all__ = ["AdamState", "OptimizerConfig", "adamw", "make_optimizer", "sgd"]
