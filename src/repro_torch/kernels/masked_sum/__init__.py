from .ops import masked_mean
from .ref import masked_mean_ref

__all__ = ["masked_mean", "masked_mean_ref"]
