from .ops import ht_amax, ht_encode_fused, ht_quant
from .ref import ht_amax_ref, ht_quant_ref, ht_rotate_ref

__all__ = ["ht_amax", "ht_amax_ref", "ht_encode_fused", "ht_quant",
           "ht_quant_ref", "ht_rotate_ref"]
