"""Transpose AllReduce (TAR, §3.1) over the peer axis, all_to_all path.

Counterpart of ``src/repro/core/tar.py`` lines 38-84. Stage mapping
(DESIGN §2): stage 1 (shard exchange) -> ``collectives.all_to_all``; reduce
-> the drop-compensated masked mean (kernel B2 on the card); stage 2
(broadcast) -> ``collectives.all_gather``. Buckets are ``(P, L)`` stacks,
one row per peer. The round schedules wait for ROADMAP A14.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.masked_sum import masked_mean as _masked_mean_kernel

from . import collectives


def pad_for_tar(x: torch.Tensor, n: int,
                block: int = 1) -> tuple[torch.Tensor, int]:
    """Pad the last axis so its length % (n * block) == 0."""
    length = x.shape[-1]
    pad = (-length) % (n * block)
    if pad:
        x = F.pad(x, (0, pad))
    return x, length


def masked_mean(received: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
    """Drop-compensated mean over the sender axis: received ``(P, N, S)``
    (receiver-major) -> ``(P, S)``. No mask -> the plain mean; with an
    arrival mask -> the compensated mean (one kernel launch for all
    receivers on the card)."""
    if mask is None:
        return received.mean(dim=-2)
    return _masked_mean_kernel(received, mask)


def tar_reduce_scatter(x: torch.Tensor, *,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """TAR stage 1 + reduce: ``(P, L)`` -> each peer's aggregated shard
    ``(P, S)``. mask: ``(P, N, S)``, receiver r's arrivals in row r (its own
    row always 1; see drops.make_mask)."""
    p = collectives.axis_size(x)
    s = x.shape[-1] // p
    received = collectives.all_to_all(x.reshape(p, p, s))
    return masked_mean(received, mask)


def tar_allreduce(x: torch.Tensor, *,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Full TAR: all_to_all -> compensated reduce -> all_gather.
    ``(P, L)`` -> ``(P, L)``."""
    own = tar_reduce_scatter(x, mask=mask)
    return collectives.all_gather(own)
