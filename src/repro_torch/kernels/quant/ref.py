"""Plain PyTorch versions of the stochastic quantizers.

Counterpart of ``src/repro/kernels/quant/ref.py``: THC's uniform quantizer
onto one shared range (``uniform_quant_ref``, kernel B7, and its dequant)
and its per-Hadamard-block variant (``grid_quant_ref``, kernel B6):

    step   = (hi - lo) / (2^bits - 1), or the row's grid step
    code   = clip(floor((x - lo) / step + u), 0, 2^bits - 1)
    dequant(code) = lo + code * step                (unbiased: E = x)

A NaN quotient (a NaN value or grid) gives code 0, as XLA's float-to-integer
convert does; a NaN grid then decodes every code of its block to NaN. The
shared step is a true division on the operand's device (PyTorch's CUDA
division by a Python scalar multiplies by the reciprocal), so the card's
codes are the CPU's.

The port's grids and noise are shared by every peer, so they are passed as
one copy: ``x`` has ``rows`` rows, ``noise`` ``noise_rows`` and ``lo`` /
``step`` ``grid_rows``, both dividing ``rows``, and row i reads noise row
``i % noise_rows`` and grid ``i % grid_rows``. With ``noise_rows ==
grid_rows == rows`` this is the reference's function exactly.
"""
from __future__ import annotations

import torch


def _tile_rows(rows: int, period: int, what: str) -> int:
    if period <= 0 or rows % period:
        raise ValueError(f"{what} has {period} rows, which must divide the "
                         f"{rows} rows of x")
    return rows // period


def _quantize(y: torch.Tensor, noise: torch.Tensor, levels: int
              ) -> torch.Tensor:
    """y: (rows, C) quotients (x - lo) / step; noise (noise_rows, C)."""
    rows, c = y.shape
    nr = noise.shape[0]
    k = _tile_rows(rows, nr, "noise")
    q = torch.nan_to_num(torch.floor(y.view(k, nr, c) + noise), nan=0.0)
    return torch.clamp(q, 0, levels).to(torch.uint8).view(rows, c)


def _shared_step(lo: torch.Tensor, hi: torch.Tensor,
                 levels: int) -> torch.Tensor:
    return (hi - lo) / torch.full_like(hi, levels)


def uniform_quant_ref(x: torch.Tensor, noise: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, *, bits: int) -> torch.Tensor:
    """x: (rows, C); noise: (noise_rows, C); lo/hi: 0-dim fp32 on x's
    device, one range shared by every row. Returns (rows, C) uint8 codes."""
    levels = (1 << bits) - 1
    step = _shared_step(lo, hi, levels)
    return _quantize((x.to(torch.float32) - lo) / step, noise, levels)


def uniform_dequant_ref(codes: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, *, bits: int,
                        nsum: int = 1) -> torch.Tensor:
    """Dequantize (a sum of ``nsum`` workers' codes): codes*step + lo*nsum,
    two roundings (the reference's XLA may fuse them into one FMA)."""
    step = _shared_step(lo, hi, (1 << bits) - 1)
    return codes.to(torch.float32) * step + lo * nsum


def grid_quant_ref(x: torch.Tensor, noise: torch.Tensor, lo: torch.Tensor,
                   step: torch.Tensor, *, bits: int) -> torch.Tensor:
    """x: (rows, C); noise: (noise_rows, C); lo/step: (grid_rows,).
    Returns (rows, C) uint8 codes."""
    rows, c = x.shape
    g = lo.shape[0]
    k = _tile_rows(rows, g, "lo/step")
    y = (x.to(torch.float32).view(k, g, c) - lo[:, None]) / step[:, None]
    return _quantize(y.view(rows, c), noise, (1 << bits) - 1)


def grid_quant_bytes(rows: int, cols: int, noise_rows: int,
                     grid_rows: int) -> int:
    """Bytes the quantizer must move: x (fp32) and one copy of the noise
    (fp32) and grids read once, the uint8 codes written once."""
    return 4 * rows * cols + 4 * noise_rows * cols + 8 * grid_rows \
        + rows * cols


def grid_quant_flops(rows: int, cols: int) -> int:
    """A subtract, a divide, an add and the floor an element."""
    return 4 * rows * cols


def uniform_quant_bytes(rows: int, cols: int, noise_rows: int) -> int:
    """Bytes B7 must move: x (fp32) and one copy of the noise (fp32) read
    once, the 2-float range read once, the uint8 codes written once."""
    return 4 * rows * cols + 4 * noise_rows * cols + 8 + rows * cols


def uniform_quant_flops(rows: int, cols: int) -> int:
    """A subtract, a divide, an add and the floor an element (the shared
    step is one division)."""
    return 4 * rows * cols + 2
