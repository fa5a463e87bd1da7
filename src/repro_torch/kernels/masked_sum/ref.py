"""Plain PyTorch version of the drop-compensated shard reduction.

Counterpart of ``src/repro/kernels/masked_sum/ref.py``. Given ``shards``
(..., N, L), the N peers' contributions for one shard, and a 0/1 ``mask`` of
the same shape marking which entries arrived before the timeout:

    out[..., j] = sum_i mask[..., i, j] * shards[..., i, j]
                  / max(1, sum_i mask[..., i, j])

and exactly 0 where nobody delivered column j. Leading axes (the port's
receiver axis) are batched.
"""
from __future__ import annotations

import torch


def masked_mean_ref(shards: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = shards.to(torch.float32)
    m = mask.to(torch.float32)
    cnt = m.sum(dim=-2)
    s = (x * m).sum(dim=-2)
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(s))
    return out.to(shards.dtype)


def masked_mean_bytes(r: int, n: int, length: int) -> int:
    """Bytes the reduction must move: shards and mask read once (fp32), the
    (R, L) result written once."""
    return 4 * (2 * r * n * length + r * length)


def masked_mean_flops(r: int, n: int, length: int) -> int:
    """Per column and peer a multiply and two adds; one divide a column."""
    return r * length * (3 * n + 1)
