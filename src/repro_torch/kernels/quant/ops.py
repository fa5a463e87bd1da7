"""Public wrapper for the per-row-grid quantization kernel
(``csrc/grid_quant.cu``).

Counterpart of ``src/repro/kernels/quant/ops.py::grid_quant``: the TAR
stage-2 re-quantization of the quantized exchange. A CUDA tensor launches
the kernel (or raises); a CPU tensor takes ``grid_quant_ref`` (see
``kernels/runtime``). ``launches`` counts kernel launches and is bumped
nowhere else. ``uniform_quant`` (B7) waits for the next slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, runtime

from .ref import _tile_rows, grid_quant_ref

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("grid_quant").grid_quant_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + \
            [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grid_quant_launch(x: torch.Tensor, noise: torch.Tensor, lo: torch.Tensor,
                      step: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Launch the kernel: CUDA fp32 ``(rows, C)`` x, ``(noise_rows, C)``
    noise and ``(grid_rows,)`` grids -> contiguous ``(rows, C)`` uint8.
    Each thread takes 4 elements: C must be a multiple of 4 and x and the
    noise 16-byte aligned, as the sync engine's Hadamard-block rows are."""
    global launches
    if x.dim() != 2 or noise.dim() != 2 or noise.shape[1] != x.shape[1]:
        raise ValueError("x and noise must be (rows, C) and (noise_rows, C), "
                         f"got {tuple(x.shape)} and {tuple(noise.shape)}")
    if lo.dim() != 1 or step.shape != lo.shape:
        raise ValueError("lo and step must both be (grid_rows,)")
    if any(t.dtype != torch.float32 for t in (x, noise, lo, step)):
        raise TypeError("grid_quant kernel takes float32 x, noise and grids")
    if any(t.device != x.device for t in (noise, lo, step)):
        raise ValueError("x, noise and grids must be on one device")
    if not 1 <= bits <= 8:
        raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
    rows, cols = x.shape
    _tile_rows(rows, noise.shape[0], "noise")
    _tile_rows(rows, lo.shape[0], "lo/step")
    x, noise = x.contiguous(), noise.contiguous()
    lo, step = lo.contiguous(), step.contiguous()
    if cols % 4 or x.data_ptr() % 16 or noise.data_ptr() % 16:
        raise ValueError(f"grid_quant kernel takes rows of a multiple of 4 "
                         f"fp32 from 16-byte aligned x and noise, got {cols}")
    out = torch.empty((rows, cols), dtype=torch.uint8, device=x.device)
    err = _kernel()(x.data_ptr(), noise.data_ptr(), lo.data_ptr(),
                    step.data_ptr(), out.data_ptr(), rows, cols,
                    noise.shape[0], lo.shape[0], bits,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "grid_quant_f32")
    launches += 1
    return out


def grid_quant(x: torch.Tensor, noise: torch.Tensor, lo: torch.Tensor,
               step: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """Quantize ``(rows, C)`` onto per-row ``[lo_r, lo_r + levels*step_r]``
    grids; row i reads noise row ``i % noise_rows`` and grid
    ``i % grid_rows`` (one copy shared by every peer)."""
    if runtime.use_kernel(x, "grid_quant"):
        return grid_quant_launch(x, noise, lo, step, bits=bits)
    return grid_quant_ref(x, noise, lo, step, bits=bits)
