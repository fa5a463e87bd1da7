"""Serving: batched greedy decoding on the peer grid (``engine``)."""
from .engine import (ServePlan, abstract_state, build_serve_step, generate,
                     global_state, plan_serving, state_specs)

__all__ = ["ServePlan", "abstract_state", "build_serve_step", "generate",
           "global_state", "plan_serving", "state_specs"]
