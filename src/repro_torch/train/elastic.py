"""Elastic scaling: continue a job on a different worker count.

Counterpart of ``src/repro/train/elastic.py``, on trees of torch tensors.

OptiReduce makes this cheap: the collective is defined for any N (TAR shard
count follows the axis size) and the drop machinery already tolerates
departed peers mid-step (a failed node is a 100%-dropped peer until the
controller re-forms the membership). What remains is state surgery:

* replicated params: nothing to do — every survivor holds the full state.
* fsdp shards: concatenate old shards along each leaf's fsdp dim and
  re-split by the new axis size (``reshard``).
* data pipeline: deterministic (step, host, n_hosts) indexing re-partitions
  the global stream automatically (data/pipeline.py).

Pure data movement: the result is bitwise the reference's on the same
weights. The shards ``reshard`` returns are views of the full leaves.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import _map_table, param_table
from repro_torch.tree import tree_leaves, tree_unflatten


def _fsdp_dims(cfg: ModelConfig, tp: int) -> list[int | None]:
    """Each leaf's fsdp dim in tree order (None: replicated)."""
    table = param_table(cfg, tp=tp, fsdp_axes=("data",))
    return tree_leaves(_map_table(lambda leaf: leaf.fsdp_dim, table))


def gather_shards(shard_trees: list, cfg: ModelConfig, tp: int = 1) -> Any:
    """Reassemble full params from the per-worker fsdp shards."""
    dims = _fsdp_dims(cfg, tp)
    flats = [tree_leaves(t) for t in shard_trees]
    out = []
    for i, dim in enumerate(dims):
        parts = [f[i] for f in flats]
        out.append(parts[0] if dim is None        # replicated leaf
                   else torch.cat(parts, dim=dim))
    return tree_unflatten(shard_trees[0], out)


def reshard(full_params: Any, cfg: ModelConfig, new_n: int, *, tp: int = 1
            ) -> list:
    """Split full params into ``new_n`` fsdp shards (one per new worker).
    Raises ValueError when a leaf's fsdp dim does not split evenly."""
    dims = _fsdp_dims(cfg, tp)
    shards: list[list] = [[] for _ in range(new_n)]
    for leaf, dim in zip(tree_leaves(full_params), dims):
        if dim is None:
            for s in shards:
                s.append(leaf)
            continue
        if leaf.shape[dim] % new_n:
            raise ValueError(f"leaf of shape {tuple(leaf.shape)} does not "
                             f"split over {new_n} workers along dim {dim}")
        for w, piece in enumerate(torch.tensor_split(leaf, new_n, dim=dim)):
            shards[w].append(piece)
    return [tree_unflatten(full_params, s) for s in shards]
