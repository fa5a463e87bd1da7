from .ops import MAX_KEYS, draw, key_array
from .ref import bits_ref, draw_ref, erf_inv, threefry2x32

__all__ = ["MAX_KEYS", "bits_ref", "draw", "draw_ref", "erf_inv", "key_array",
           "threefry2x32"]
