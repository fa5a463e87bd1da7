"""Public wrappers for the quantization kernels (``csrc/grid_quant.cu``).

Counterpart of ``src/repro/kernels/quant/ops.py``: ``grid_quant`` (B6), the
TAR stage-2 re-quantization of the quantized exchange, and
``uniform_quant`` (B7), the THC baseline's quantizer onto one shared range.
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version (see ``kernels/runtime``). ``launches`` (B6) and
``uniform_launches`` (B7) count kernel launches and are bumped nowhere
else. ``uniform_dequant`` stays plain PyTorch, as the reference keeps it
jnp: one elementwise multiply-add.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, runtime

from .ref import (_tile_rows, grid_quant_ref, uniform_dequant_ref,
                  uniform_quant_ref)

launches = 0
uniform_launches = 0

_ARGTYPES = {
    "grid_quant_f32": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_void_p],
    "uniform_quant_f32": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
    + [ctypes.c_int, ctypes.c_void_p],
}
_fns: dict = {}


def _kernel(name: str):
    if name not in _fns:
        fn = getattr(build.library("grid_quant"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_rows(x: torch.Tensor, noise: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or noise.dim() != 2 or noise.shape[1] != x.shape[1]:
        raise ValueError("x and noise must be (rows, C) and (noise_rows, C), "
                         f"got {tuple(x.shape)} and {tuple(noise.shape)}")
    _tile_rows(x.shape[0], noise.shape[0], "noise")
    if x.shape[1] % 4 or x.data_ptr() % 16 or noise.data_ptr() % 16:
        raise ValueError(f"{what} kernel takes rows of a multiple of 4 fp32 "
                         "from 16-byte aligned x and noise, got "
                         f"{x.shape[1]}")


def grid_quant_launch(x: torch.Tensor, noise: torch.Tensor, lo: torch.Tensor,
                      step: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Launch the kernel: CUDA fp32 ``(rows, C)`` x, ``(noise_rows, C)``
    noise and ``(grid_rows,)`` grids -> contiguous ``(rows, C)`` uint8.
    Each thread takes 4 elements: C must be a multiple of 4 and x and the
    noise 16-byte aligned, as the sync engine's Hadamard-block rows are."""
    global launches
    if lo.dim() != 1 or step.shape != lo.shape:
        raise ValueError("lo and step must both be (grid_rows,)")
    if any(t.dtype != torch.float32 for t in (x, noise, lo, step)):
        raise TypeError("grid_quant kernel takes float32 x, noise and grids")
    if any(t.device != x.device for t in (noise, lo, step)):
        raise ValueError("x, noise and grids must be on one device")
    if not 1 <= bits <= 8:
        raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
    x, noise = x.contiguous(), noise.contiguous()
    lo, step = lo.contiguous(), step.contiguous()
    _check_rows(x, noise, "grid_quant")
    rows, cols = x.shape
    _tile_rows(rows, lo.shape[0], "lo/step")
    out = torch.empty((rows, cols), dtype=torch.uint8, device=x.device)
    err = _kernel("grid_quant_f32")(
        x.data_ptr(), noise.data_ptr(), lo.data_ptr(), step.data_ptr(),
        out.data_ptr(), rows, cols, noise.shape[0], lo.shape[0], bits,
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


def uniform_quant_launch(x: torch.Tensor, noise: torch.Tensor,
                         lohi: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Launch B7: CUDA fp32 ``(rows, C)`` x, ``(noise_rows, C)`` noise
    (noise_rows dividing rows) and ``lohi`` = [lo, hi], 2 fp32 on x's
    device -> contiguous ``(rows, C)`` uint8. Each thread takes 4 columns:
    C must be a multiple of 4 and x and the noise 16-byte aligned."""
    global uniform_launches
    if any(t.dtype != torch.float32 for t in (x, noise, lohi)):
        raise TypeError("uniform_quant kernel takes float32 x, noise and "
                        "lohi")
    if lohi.shape != (2,) or lohi.device != x.device:
        raise ValueError("lohi must be 2 fp32 values [lo, hi] on x's device, "
                         f"got shape {tuple(lohi.shape)} on {lohi.device}")
    if noise.device != x.device:
        raise ValueError("x and noise must be on one device")
    if not 1 <= bits <= 8:
        raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
    x, noise, lohi = x.contiguous(), noise.contiguous(), lohi.contiguous()
    _check_rows(x, noise, "uniform_quant")
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=torch.uint8, device=x.device)
    err = _kernel("uniform_quant_f32")(
        x.data_ptr(), noise.data_ptr(), lohi.data_ptr(), out.data_ptr(), rows,
        cols, noise.shape[0], bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "uniform_quant_f32")
    uniform_launches += 1
    return out


def uniform_quant(x: torch.Tensor, noise: torch.Tensor, lohi: torch.Tensor,
                  *, bits: int = 8) -> torch.Tensor:
    """Quantize ``x`` (any leading shape, rows of the last axis) onto the
    shared ``[lo, hi] = lohi`` grid. ``noise`` holds whole rows of that
    width, one copy shared by every leading index: row i of the flattened x
    reads noise row ``i % noise_rows``. Returns uint8 codes of x's shape."""
    c = x.shape[-1]
    x2, n2 = x.reshape(-1, c), noise.reshape(-1, c)
    if runtime.use_kernel(x, "uniform_quant"):
        out = uniform_quant_launch(x2, n2, lohi, bits=bits)
    else:
        out = uniform_quant_ref(x2, n2, lohi[0], lohi[1], bits=bits)
    return out.view(x.shape)


def uniform_dequant(codes: torch.Tensor, lohi: torch.Tensor, *,
                    bits: int = 8, nsum: int = 1) -> torch.Tensor:
    """Elementwise dequant of (a sum of ``nsum`` workers') codes."""
    return uniform_dequant_ref(codes, lohi[0], lohi[1], bits=bits, nsum=nsum)
