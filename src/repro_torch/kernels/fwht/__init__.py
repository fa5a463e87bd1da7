from .ops import fwht, randomized_fwht
from .ref import fwht_mxu_ref, fwht_ref, randomized_fwht_ref

__all__ = ["fwht", "fwht_mxu_ref", "fwht_ref", "randomized_fwht",
           "randomized_fwht_ref"]
