from .ops import grid_quant, uniform_dequant, uniform_quant
from .ref import grid_quant_ref, uniform_dequant_ref, uniform_quant_ref

__all__ = ["grid_quant", "grid_quant_ref", "uniform_dequant",
           "uniform_dequant_ref", "uniform_quant", "uniform_quant_ref"]
