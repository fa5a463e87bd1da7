"""Randomized Hadamard transform over gradient buckets (paper §3.3).

Counterpart of ``src/repro/core/hadamard.py`` (``rademacher_sign``,
``ht_encode``, ``ht_decode`` and the fused encode-side stages of the
quantized exchange, ``ht_encode_amax`` and ``ht_encode_quant``). A bucket is processed in ``block``-long blocks;
blockwise HT commutes with TAR sharding when shard boundaries are
block-aligned (``core.tar.pad_for_tar``), and the transform is linear, so
``decode(mean_i(encode(g_i))) == mean_i(g_i)`` without drops, while under
drops the error spreads across the block.

The reference derives the sign from a key inside these functions; the port
takes the sign itself (from the ``SyncContext``'s draws), so the same
encode and decode can be fed the reference's sign in the tests. Leading
axes (the peer axis) ride along: a ``(P, L)`` stack is one kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fwht import randomized_fwht
from repro_torch.kernels.ht_quant import ht_amax, ht_quant


def rademacher_sign(gen: torch.Generator, block: int) -> torch.Tensor:
    """The random +-1 diagonal D shared by all workers for one bucket."""
    keep = torch.rand((block,), generator=gen, device=gen.device) < 0.5
    return torch.where(keep, 1.0, -1.0).to(torch.float32)


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[-1]
    if n % block:
        raise ValueError(f"bucket length {n} not a multiple of block {block}")
    return x.view(*x.shape[:-1], n // block, block)


def ht_encode(x: torch.Tensor, sign: torch.Tensor, *,
              block: int = 4096) -> torch.Tensor:
    """Encode flat block-aligned buckets (last axis): per block H (d * x)."""
    y = randomized_fwht(_blocks(x, block), sign, mode="encode")
    return y.reshape(x.shape)


def ht_decode(y: torch.Tensor, sign: torch.Tensor, *,
              block: int = 4096) -> torch.Tensor:
    """Inverse of ``ht_encode`` with the same sign: per block d * (H y)."""
    x = randomized_fwht(_blocks(y, block), sign, mode="decode")
    return x.reshape(y.shape)


# ------------------------------------------------- fused encode-side stages
# The rotated bucket is never materialized: kernels B3 and B4 rotate in
# registers and emit only the per-block amax or the uint8 codes.

def ht_encode_amax(x: torch.Tensor, sign: torch.Tensor, *,
                   block: int = 4096) -> torch.Tensor:
    """Per-block amax of ``ht_encode(x)`` without materializing it:
    ``(..., L)`` -> ``(..., L / block)`` fp32, the quantization-grid pass
    (pmax these across peers, then call :func:`ht_encode_quant`)."""
    return ht_amax(_blocks(x, block), sign)


def ht_encode_quant(x: torch.Tensor, sign: torch.Tensor, noise: torch.Tensor,
                    lo: torch.Tensor, step: torch.Tensor, *,
                    block: int = 4096, bits: int = 8) -> torch.Tensor:
    """Fused ``ht_encode`` + shared-grid stochastic quantization.
    x: ``(..., L)`` block-aligned; noise ``(L / block, block)`` and lo/step
    ``(L / block,)``, one copy shared by every peer. Returns ``(..., L)``
    uint8 codes."""
    codes = ht_quant(_blocks(x, block), sign, noise, lo, step, bits=bits)
    return codes.reshape(x.shape)
