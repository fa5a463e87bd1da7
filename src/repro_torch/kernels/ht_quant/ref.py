"""Plain PyTorch versions of the fused HT-encode + quantize kernels.

Counterpart of ``src/repro/kernels/ht_quant/ref.py``. Each composes the
port's building blocks: the rotation is ``fwht_ref`` (the butterfly the CUDA
kernels run, lowest index bit first) of ``d * x``, and the quantizer is
``quant/ref.py::grid_quant_ref``. The reference's oracles rotate with the
Kronecker form instead (``fwht_mxu_ref``); the two differ by fp32 rounding.

Rows are Hadamard blocks. Leading axes (the peer axis) ride along. The
grids and the noise are one copy shared by every peer: row i of the
flattened rows reads noise and grid row ``i % G``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.fwht.ref import fwht_ref
from repro_torch.kernels.quant.ref import grid_quant_ref


def ht_rotate_ref(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """sign-flip + blocked FWHT of ``(..., n)``: the encode rotation."""
    return fwht_ref(x.to(torch.float32) * sign)


def ht_amax_ref(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Per-block amax of the rotated blocks: ``(..., n)`` -> ``(...)``."""
    return ht_rotate_ref(x, sign).abs().amax(dim=-1)


def ht_quant_ref(x: torch.Tensor, sign: torch.Tensor, noise: torch.Tensor,
                 lo: torch.Tensor, step: torch.Tensor, *,
                 bits: int) -> torch.Tensor:
    """Rotate, then quantize onto per-block ``[lo, lo + levels*step]``
    grids. x: ``(..., n)``; noise ``(G, n)``; lo/step ``(G,)``, already
    pmax-shared across peers. Returns uint8 codes of x's shape."""
    n = x.shape[-1]
    y = ht_rotate_ref(x, sign).reshape(-1, n)
    return grid_quant_ref(y, noise, lo, step, bits=bits).view(x.shape)


def ht_amax_bytes(rows: int, n: int) -> int:
    """x read once (fp32), the sign once, one fp32 written a row."""
    return 4 * (rows * n + n + rows)


def ht_amax_flops(rows: int, n: int) -> int:
    """The sign, the butterfly's adds, the scale, and the abs-max."""
    return rows * n * (int(math.log2(n)) + 3)


def ht_quant_bytes(rows: int, n: int, grid_rows: int) -> int:
    """x read once (fp32), one shared copy of the noise and the grids, the
    sign, and one uint8 code written an element."""
    return 4 * rows * n + 4 * grid_rows * n + 8 * grid_rows + 4 * n \
        + rows * n


def ht_quant_flops(rows: int, n: int) -> int:
    """The rotation as in ``ht_amax_flops`` less the max, plus the
    quantizer's subtract, divide, add and floor."""
    return rows * n * (int(math.log2(n)) + 6)
