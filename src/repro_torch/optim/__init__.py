from .optimizers import (AdafactorState, AdamState, OptimizerConfig,
                         adafactor, adamw, make_optimizer, momentum_sgd, sgd)

__all__ = ["AdafactorState", "AdamState", "OptimizerConfig", "adafactor",
           "adamw", "make_optimizer", "momentum_sgd", "sgd"]
