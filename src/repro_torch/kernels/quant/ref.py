"""Plain PyTorch version of the per-row-grid stochastic quantizer.

Counterpart of ``src/repro/kernels/quant/ref.py::grid_quant_ref`` (the THC
uniform quantizer on per-Hadamard-block grids):

    step   = the row's grid step, lo its lower bound
    code   = clip(floor((x - lo) / step + u), 0, 2^bits - 1)
    dequant(code) = lo + code * step                (unbiased: E = x)

A NaN quotient (a NaN value or grid) gives code 0, as XLA's float-to-integer
convert does; a NaN grid then decodes every code of its block to NaN.

The port's grids and noise are shared by every peer, so they are passed as
one copy: ``x`` has ``rows`` rows, ``noise`` ``noise_rows`` and ``lo`` /
``step`` ``grid_rows``, both dividing ``rows``, and row i reads noise row
``i % noise_rows`` and grid ``i % grid_rows``. With ``noise_rows ==
grid_rows == rows`` this is the reference's function exactly.
``uniform_quant_ref`` (B7, the THC baseline) is not ported yet.
"""
from __future__ import annotations

import torch


def _tile_rows(rows: int, period: int, what: str) -> int:
    if period <= 0 or rows % period:
        raise ValueError(f"{what} has {period} rows, which must divide the "
                         f"{rows} rows of x")
    return rows // period


def grid_quant_ref(x: torch.Tensor, noise: torch.Tensor, lo: torch.Tensor,
                   step: torch.Tensor, *, bits: int) -> torch.Tensor:
    """x: (rows, C); noise: (noise_rows, C); lo/step: (grid_rows,).
    Returns (rows, C) uint8 codes."""
    levels = (1 << bits) - 1
    rows, c = x.shape
    g = lo.shape[0]
    k = _tile_rows(rows, g, "lo/step")
    y = (x.to(torch.float32).view(k, g, c) - lo[:, None]) / step[:, None]
    nr = noise.shape[0]
    k = _tile_rows(rows, nr, "noise")
    q = torch.nan_to_num(torch.floor(y.view(k, nr, c) + noise), nan=0.0)
    return torch.clamp(q, 0, levels).to(torch.uint8).view(rows, c)


def grid_quant_bytes(rows: int, cols: int, noise_rows: int,
                     grid_rows: int) -> int:
    """Bytes the quantizer must move: x (fp32) and one copy of the noise
    (fp32) and grids read once, the uint8 codes written once."""
    return 4 * rows * cols + 4 * noise_rows * cols + 8 * grid_rows \
        + rows * cols


def grid_quant_flops(rows: int, cols: int) -> int:
    """A subtract, a divide, an add and the floor an element."""
    return 4 * rows * cols
