"""Public wrapper for the drop-compensated mean kernel
(``csrc/masked_mean.cu``).

Counterpart of ``src/repro/kernels/masked_sum/ops.py``, with a leading
receiver axis: ``(R, N, L)`` shards and mask -> ``(R, L)``, one launch for
every receiver of a bucket. A CUDA tensor launches the kernel (or raises); a
CPU tensor takes ``masked_mean_ref`` (see ``kernels/runtime``). ``launches``
counts kernel launches and is bumped nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, runtime

from .ref import masked_mean_ref

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("masked_mean").masked_mean_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def masked_mean_launch(shards: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: CUDA fp32 ``(R, N, L)`` shards (any receiver and
    peer strides, contiguous columns) and mask -> contiguous ``(R, L)``."""
    global launches
    if shards.dim() != 3 or mask.shape != shards.shape:
        raise ValueError("shards and mask must both be (R, N, L), got "
                         f"{tuple(shards.shape)} and {tuple(mask.shape)}")
    if shards.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("masked_mean kernel takes float32 shards and mask")
    if mask.device != shards.device:
        raise ValueError("shards and mask must be on one device")
    r, n, length = shards.shape
    if r > 65535:
        raise ValueError(f"at most 65535 receivers per launch, got {r}")
    if shards.stride(2) != 1:
        shards = shards.contiguous()
    mask = mask.contiguous()
    out = torch.empty((r, length), dtype=torch.float32, device=shards.device)
    sr, sn = shards.stride(0), shards.stride(1)
    vec4 = (length % 4 == 0 and sr % 4 == 0 and sn % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in (shards, mask, out)))
    err = _kernel()(shards.data_ptr(), mask.data_ptr(), out.data_ptr(), r, n,
                    length, sr, sn, int(vec4),
                    torch.cuda.current_stream(shards.device).cuda_stream)
    build.check(err, "masked_mean_f32")
    launches += 1
    return out


def masked_mean(shards: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Drop-compensated mean over the peer axis: ``(..., N, L)`` shards and
    mask -> ``(..., L)``. A 2-D input is one receiver."""
    if runtime.use_kernel(shards, "masked_mean"):
        if shards.dim() == 2:
            return masked_mean_launch(shards[None], mask[None])[0]
        return masked_mean_launch(shards, mask)
    return masked_mean_ref(shards, mask)
