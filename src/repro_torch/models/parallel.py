"""Parallelism context of the model code: the data-parallel half.

Counterpart of ``src/repro/models/parallel.py``. The reference's model code
runs inside a ``shard_map`` body and ``ParallelCtx`` carries the mesh axis
names; here the P data-parallel peers are the leading axis of stacked
tensors on one card (pod-major over ``(pod, data)``, as
``core/collectives.py`` lays them out), so a per-device value of the
reference becomes a ``(P, ...)`` stack and each collective reindexes it.

``gather`` is the FSDP weight gather the trainer installs: ``(w, dim, key,
name) -> w_full``, whose gradient the trainer reduces with OptiReduce's
reduce-scatter. On one card a parameter is stored whole, so the gather
hands back the full weight; ``name`` tells apart two call sites that share
a key (the embedding lookup and the tied head). Tensor parallelism
(``tp_axis``) is ROADMAP A15b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    tp_axis: str | None = None      # 'model' (ROADMAP A15b)
    dp_axis: str | None = None      # 'data'  (fsdp gathers + grad sync)
    pod_axis: str | None = None     # 'pod', or 'model' under pure_dp
    fsdp: bool = False              # weights sharded over the dp axes
    gather: Callable | None = None  # (w, dim, key, name) -> w_full
    sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.tp_axis is not None:
            raise NotImplementedError(
                f"tensor parallelism (tp_axis={self.tp_axis!r}) is not "
                "ported yet: ROADMAP A15b")

    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in (self.pod_axis, self.dp_axis) if a)

    def dp_size(self) -> int:
        return math.prod(self.sizes.get(a, 1) for a in self.dp_axes())

    def dp_shard_index(self, device=None) -> torch.Tensor:
        """Each peer's linear index over (pod, data), ``(P,)``: the peer
        axis itself, the order of ``P(('pod', 'data'))``."""
        return torch.arange(self.dp_size(), device=device)

    def psum_dp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a ``(P, ...)`` stack over the dp axes, held by every
        peer."""
        if not self.dp_axes():
            return x
        return x.sum(dim=0, keepdim=True).expand_as(x)

    def all_gather_dp(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """FSDP weight gather over the data axis (identity when not fsdp):
        ``(P, *shard)`` -> ``(P, *gathered)``, each pod's N shards
        concatenated along ``axis`` of the unstacked tensor."""
        if not (self.fsdp and self.dp_axis):
            return x
        g = self.sizes.get(self.pod_axis, 1) if self.pod_axis else 1
        pods = x.reshape(g, -1, *x.shape[1:])          # (G, N, *shard)
        n = pods.shape[1]
        full = torch.cat(pods.unbind(1), dim=axis + 1)  # (G, *gathered)
        return full[:, None].expand(g, n, *full.shape[1:]).reshape(
            g * n, *full.shape[1:])


# A no-parallelism context for single-peer use and references.
SINGLE = ParallelCtx()
