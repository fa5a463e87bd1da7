"""Model substrate of the port: the dense transformer family."""
from .transformer import (count_params, forward_hidden, init_params, lm_loss,
                          param_table)

__all__ = ["count_params", "forward_hidden", "init_params", "lm_loss",
           "param_table"]
