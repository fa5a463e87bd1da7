from .ops import dequant_masked_mean
from .ref import dequant_masked_mean_ref

__all__ = ["dequant_masked_mean", "dequant_masked_mean_ref"]
