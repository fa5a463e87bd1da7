"""Model substrate of the port: the dense transformer family."""
from .parallel import ParallelCtx
from .transformer import (count_params, forward_hidden, init_params, lm_loss,
                          param_specs, param_table)

__all__ = ["ParallelCtx", "count_params", "forward_hidden", "init_params",
           "lm_loss", "param_specs", "param_table"]
