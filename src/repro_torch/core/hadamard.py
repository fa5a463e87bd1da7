"""Randomized Hadamard transform over gradient buckets (paper §3.3).

Counterpart of ``src/repro/core/hadamard.py`` (``rademacher_sign``,
``ht_encode``, ``ht_decode``; the quantized encoders wait for the
``optireduce_q`` slice). A bucket is processed in ``block``-long blocks;
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
