"""Public wrapper for the threefry draw kernel (``csrc/threefry.cu``).

``draw`` computes ``(K, n)`` fp32 values under a ``(K, 2)`` batch of keys
(uint32 bit patterns, held on the host: key derivation never touches the
card). On a CUDA device it launches the kernel (or raises); on the CPU it
runs the plain version in ``ref.py`` (see ``kernels/runtime``). ``launches``
counts kernel launches and is bumped nowhere else. A batch of more than
``MAX_KEYS`` keys is refused, not split.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, runtime

from .ref import MODES, NORMAL_LO, draw_ref

launches = 0

MAX_KEYS = 256
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("threefry").threefry_draw_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def key_array(keys) -> np.ndarray:
    """A ``(K, 2)`` uint32 array from keys (pairs of ints) or an array."""
    arr = np.asarray(keys, dtype=np.int64).reshape(-1, 2) & 0xFFFF_FFFF
    return np.ascontiguousarray(arr.astype(np.uint32))


def _span(a: float, b: float) -> tuple[float, float]:
    """``a`` and ``b - a`` rounded as fp32, as the plain version rounds
    them."""
    lo, hi = np.float32(a), np.float32(b)
    return float(lo), float(np.float32(hi - lo))


def draw_launch(keys, n: int, mode: str, a: float, b: float,
                device: torch.device) -> torch.Tensor:
    """Launch the kernel: ``(K, n)`` fp32 on the CUDA ``device``."""
    global launches
    if mode not in MODES:
        raise ValueError(f"unknown draw mode {mode!r}; one of {tuple(MODES)}")
    k = key_array(keys)
    if not 0 < k.shape[0] <= MAX_KEYS:
        raise ValueError(f"the threefry kernel takes 1..{MAX_KEYS} keys a "
                         f"launch, got {k.shape[0]}")
    out = torch.empty((k.shape[0], n), dtype=torch.float32, device=device)
    if n == 0:
        return out
    if mode == "normal":
        a, b = NORMAL_LO, 1.0
    lo, span = _span(a, b)
    err = _kernel()(k.ctypes.data, k.shape[0], out.data_ptr(), n,
                    MODES[mode], lo, span,
                    torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "threefry_draw_f32")
    launches += 1
    return out


def draw(keys, n: int, mode: str = "uniform", a: float = 0.0, b: float = 1.0,
         device: torch.device | str = "cpu") -> torch.Tensor:
    """``(K, n)`` fp32 draws of ``mode`` (``uniform`` on ``[a, b)``,
    ``bernoulli`` with probability ``a`` as 0/1, ``normal``) under each of
    the ``(K, 2)`` keys, on ``device``."""
    device = torch.device(device)
    probe = torch.empty(0, device=device)
    if runtime.use_kernel(probe, "threefry"):
        return draw_launch(keys, n, mode, a, b, device)
    return draw_ref(torch.from_numpy(key_array(keys).astype(np.int64)), n,
                    mode, a, b, device)
