from .ops import grid_quant
from .ref import grid_quant_ref

__all__ = ["grid_quant", "grid_quant_ref"]
