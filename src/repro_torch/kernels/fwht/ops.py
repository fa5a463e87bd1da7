"""Public wrappers for the FWHT kernel (``csrc/fwht.cu``).

Counterpart of ``src/repro/kernels/fwht/ops.py``. ``fwht`` and
``randomized_fwht`` transform the last axis. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the butterfly ``fwht_ref``, the same
arithmetic (see ``kernels/runtime``). ``launches`` counts kernel launches
and is bumped nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, runtime

from .ref import fwht_ref, randomized_fwht_ref

launches = 0

MIN_N, MAX_N = 16, 4096
_MODES = {"none": 0, "pre": 1, "post": 2}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("fwht").fwht_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows_view(x: torch.Tensor) -> tuple[torch.Tensor, int, int, int]:
    """(tensor, rows, rows_per_peer, peer_stride) for the kernel: a 3-D
    (P, R, n) view whose rows are contiguous keeps its peer stride (0 for a
    broadcast all_gather view); anything else is made contiguous rows."""
    n = x.shape[-1]
    if (x.dim() == 3 and x.stride(2) == 1 and x.stride(1) == n
            and x.shape[1] > 0):
        return x, x.shape[0] * x.shape[1], x.shape[1], x.stride(0)
    x2 = x.contiguous().reshape(-1, n)
    return x2, x2.shape[0], max(x2.shape[0], 1), 0


def fwht_launch(x: torch.Tensor, sign: torch.Tensor | None,
                sign_mode: str) -> torch.Tensor:
    """Launch the kernel on a CUDA fp32 tensor: rows of the last axis ->
    a new contiguous tensor of ``x``'s shape."""
    global launches
    n = x.shape[-1]
    if x.dtype != torch.float32:
        raise TypeError(f"fwht kernel takes float32, got {x.dtype}")
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"fwht kernel takes a power-of-two length in "
                         f"[{MIN_N}, {MAX_N}], got {n}")
    mode = _MODES[sign_mode]
    if mode:
        if sign is None or sign.shape != (n,):
            raise ValueError(f"sign of shape ({n},) required for "
                             f"sign_mode={sign_mode!r}")
        if sign.device != x.device or sign.dtype != torch.float32:
            raise ValueError("sign must be float32 on the input's device")
        sign = sign.contiguous()
        if sign.data_ptr() % 16:
            raise ValueError("sign must be 16-byte aligned")
    xv, rows, per_peer, stride = _rows_view(x)
    if xv.data_ptr() % 16 or stride % 4:
        raise ValueError("fwht kernel needs 16-byte aligned rows")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = _kernel()(xv.data_ptr(), y.data_ptr(),
                    sign.data_ptr() if mode else None, rows, n, per_peer,
                    stride, mode, torch.cuda.current_stream(x.device)
                    .cuda_stream)
    build.check(err, "fwht_f32")
    launches += 1
    return y


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FWHT over the last axis. Involution: fwht(fwht(x)) == x."""
    if runtime.use_kernel(x, "fwht"):
        return fwht_launch(x, None, "none")
    return fwht_ref(x)


def randomized_fwht(x: torch.Tensor, sign: torch.Tensor, *,
                    mode: str) -> torch.Tensor:
    """Randomized HT: encode = H (d*x); decode = d * (H y) (exact inverse)."""
    if mode not in ("encode", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if runtime.use_kernel(x, "randomized_fwht"):
        return fwht_launch(x, sign, "pre" if mode == "encode" else "post")
    return randomized_fwht_ref(x, sign, mode=mode)
