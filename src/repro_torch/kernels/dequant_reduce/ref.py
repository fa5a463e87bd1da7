"""Plain PyTorch version of the fused dequant + drop-compensated mean.

Counterpart of ``src/repro/kernels/dequant_reduce/ref.py``: the THC dequant
(``codes * step + lo`` on per-column grids, two roundings) composed with the
port's ``masked_mean_ref``, or the plain mean over peers without a mask.
Leading axes (the port's receiver axis) are batched:

    codes (..., N, S) uint8, lo_row / step_row (..., S) -> (..., S) fp32
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_sum.ref import masked_mean_ref


def dequant_masked_mean_ref(codes: torch.Tensor, lo_row: torch.Tensor,
                            step_row: torch.Tensor,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    vals = (codes.to(torch.float32) * step_row[..., None, :]
            .to(torch.float32) + lo_row[..., None, :].to(torch.float32))
    if mask is None:
        return vals.mean(dim=-2)
    return masked_mean_ref(vals, mask)


def dequant_mean_bytes(r: int, n: int, s: int, block: int, *,
                       masked: bool) -> int:
    """Bytes the reduction must move: the uint8 codes and (masked) the fp32
    mask read once, the per-block grids once, the (R, S) fp32 result
    written once."""
    return r * n * s + (4 * r * n * s if masked else 0) \
        + 8 * r * (s // block) + 4 * r * s


def dequant_mean_flops(r: int, n: int, s: int, *, masked: bool) -> int:
    """Per code a multiply and an add to dequantize, an add to sum (and with
    a mask a multiply and an add for the count); one divide a column."""
    return r * s * ((5 if masked else 3) * n + 1)
