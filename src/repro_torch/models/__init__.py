"""Model substrate of the port: every family of the reference's
transformer (dense, MoE, SSM, hybrid, frontend), trained and served."""
from .parallel import SINGLE, ParallelCtx
from .transformer import (abstract_params, active_params, count_params,
                          decode_step, forward_hidden, init_decode_state,
                          init_params, lm_loss, param_specs, param_table,
                          prefill_step)

__all__ = ["SINGLE", "ParallelCtx", "abstract_params", "active_params",
           "count_params", "decode_step", "forward_hidden",
           "init_decode_state", "init_params", "lm_loss", "param_specs",
           "param_table", "prefill_step"]
