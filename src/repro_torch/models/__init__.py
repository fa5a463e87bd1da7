"""Model substrate of the port: every family of the reference's
transformer (dense, MoE, SSM, hybrid, frontend)."""
from .parallel import SINGLE, ParallelCtx
from .transformer import (abstract_params, active_params, count_params,
                          forward_hidden, init_params, lm_loss, param_specs,
                          param_table)

__all__ = ["SINGLE", "ParallelCtx", "abstract_params", "active_params",
           "count_params", "forward_hidden", "init_params", "lm_loss",
           "param_specs", "param_table"]
