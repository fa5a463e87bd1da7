"""The peer axis: the port's counterpart of the ``jax.lax`` axis primitives
the sync path uses.

The reference runs its N data ranks as ``shard_map`` over N devices. On one
card the port runs them as a leading peer axis of size P on stacked
tensors: row p of every stacked tensor is what rank p holds. Each
collective is then a reindexing of that axis, returned as a view where one
exists (no copy): the kernels read the strided views directly.

A ``torch.distributed`` (NCCL) backend behind this interface, one rank per
card, is the next multi-GPU slice (ROADMAP).
"""
from __future__ import annotations

import torch


def axis_size(x: torch.Tensor) -> int:
    return x.shape[0]


def axis_index(x: torch.Tensor) -> torch.Tensor:
    """Each peer's own index, ``(P,)``."""
    return torch.arange(x.shape[0], device=x.device)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled all_to_all: ``(P, N, S)`` sender-major (row p = what peer p
    sends to each of N peers) -> receiver-major ``(N, P, S)`` (row j = the
    shards peer j received, one per sender)."""
    if x.shape[0] != x.shape[1]:
        raise ValueError(f"all_to_all over {x.shape[0]} peers needs "
                         f"{x.shape[0]} shards each, got {x.shape[1]}")
    return x.transpose(0, 1)


def all_gather(own: torch.Tensor) -> torch.Tensor:
    """Tiled all_gather: ``(P, S)`` -> ``(P, P*S)``, every peer holding the
    concatenation of all peers' shards (a broadcast view)."""
    p = own.shape[0]
    return own.reshape(1, -1).expand(p, -1)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over peers, held by every peer: ``(P, ...)`` -> ``(P, ...)``."""
    return x.mean(dim=0, keepdim=True).expand_as(x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=0, keepdim=True).expand_as(x)
