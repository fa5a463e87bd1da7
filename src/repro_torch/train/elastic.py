"""Elastic scaling: continue a job on a different worker count.

Counterpart of ``src/repro/train/elastic.py``, on trees of torch tensors.

OptiReduce makes this cheap: the collective is defined for any N (TAR shard
count follows the axis size) and the drop machinery already tolerates
departed peers mid-step (a failed node is a 100%-dropped peer until the
controller re-forms the membership). What remains is state surgery:

* replicated params: nothing to do — every survivor holds the full state.
* fsdp shards: concatenate old shards along each leaf's fsdp dim and
  re-split by the new axis size (``reshard``). One rank a peer under FSDP
  (``launch/train.py`` under ``torchrun``, or ``build_train_step(...,
  group=)`` on a ``(pod, data)`` grid of G x N ranks) takes its shard of
  each leaf through the same slicing, G x N pieces pod-major, rank ``g * N
  + i`` the piece of that index, and puts the ranks' shards back together
  through the same join, for its checkpoints.
* tp shards over ranks: the same functions along each leaf's tp dim
  (``transformer.tp_dims``), T pieces, tp rank t the t-th; under FSDP x
  TP both cuts, the tp chunk first, then its data shard. One rank's cuts
  of every leaf are :func:`rank_cuts`: init keeps the rank's piece of each
  full leaf as it is drawn (:func:`cut_piece`), a checkpoint gathers each
  leaf's pieces back into the full leaf, the stacked format
  (:func:`gather_cut_tree`: over the data group, then over the tp group),
  and ``--resume`` cuts them again (:func:`cut_tree`).
* data pipeline: deterministic (step, host, n_hosts) indexing re-partitions
  the global stream automatically (data/pipeline.py).

Pure data movement: the result is bitwise the reference's on the same
weights. The shards ``reshard`` returns are views of the full leaves.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import _map_table, param_table, tp_dims
from repro_torch.tree import tree_leaves, tree_unflatten


def fsdp_dims(cfg: ModelConfig, tp: int = 1) -> list[int | None]:
    """Each leaf's fsdp dim in tree order (None: replicated)."""
    table = param_table(cfg, tp=tp, fsdp_axes=("data",))
    return tree_leaves(_map_table(lambda leaf: leaf.fsdp_dim, table))


def state_dims(cfg: ModelConfig, opt_state: Any, like_params: bool,
               tp: int = 1, *, dims: list | None = None
               ) -> list[int | None]:
    """Each leaf's fsdp dim of an optimizer state, in tree order: the
    parameters' dims once for each parameter-shaped tree it holds
    (``like_params``: AdamW's two moments, momentum's one), else None for
    every leaf (a state replicated whole). ``dims``: the parameters' entries
    to repeat instead of their fsdp dims (a rank's :func:`rank_cuts`, or
    their tp dims)."""
    n = len(tree_leaves(opt_state))
    if not like_params:
        return [None] * n
    dims = fsdp_dims(cfg, tp) if dims is None else dims
    if n % len(dims):
        raise ValueError(f"an optimizer state of {n} leaves is not whole "
                         f"trees of {len(dims)} parameters")
    return dims * (n // len(dims))


def split_leaf(leaf: torch.Tensor, dim: int | None, n: int) -> list:
    """A leaf's ``n`` fsdp shards, views along ``dim`` in worker order (n
    times the leaf itself when ``dim`` is None). Raises ValueError when the
    dim does not split evenly."""
    if dim is None:
        return [leaf] * n
    if dim >= leaf.dim():
        raise ValueError(
            f"a leaf of shape {tuple(leaf.shape)} has no fsdp dim {dim}: "
            "reshard takes trees shaped like the parameters (a factored "
            "Adafactor state is not; it is replicated, not sharded)")
    if leaf.shape[dim] % n:
        raise ValueError(f"leaf of shape {tuple(leaf.shape)} does not "
                         f"split over {n} workers along dim {dim}")
    return list(torch.tensor_split(leaf, n, dim=dim))


def join_leaf(parts: list, dim: int | None) -> torch.Tensor:
    """Inverse of :func:`split_leaf`: the shards concatenated along
    ``dim`` (the first part of a replicated leaf)."""
    return parts[0] if dim is None else torch.cat(parts, dim=dim)


def gather_shards(shard_trees: list, cfg: ModelConfig, tp: int = 1) -> Any:
    """Reassemble full params from the per-worker fsdp shards."""
    flats = [tree_leaves(t) for t in shard_trees]
    out = [join_leaf([f[i] for f in flats], dim)
           for i, dim in enumerate(fsdp_dims(cfg, tp))]
    return tree_unflatten(shard_trees[0], out)


def reshard(full_params: Any, cfg: ModelConfig, new_n: int, *, tp: int = 1
            ) -> list:
    """Split full params into ``new_n`` fsdp shards (one per new worker).
    Raises ValueError when a leaf's fsdp dim does not split evenly."""
    shards: list[list] = [[] for _ in range(new_n)]
    for leaf, dim in zip(tree_leaves(full_params), fsdp_dims(cfg, tp)):
        for w, piece in enumerate(split_leaf(leaf, dim, new_n)):
            shards[w].append(piece)
    return [tree_unflatten(full_params, s) for s in shards]


def rank_cuts(cfg: ModelConfig, *, ranks: int, rank: int, tp: int = 1,
              fsdp: bool = False) -> list[tuple]:
    """What rank ``rank`` of ``ranks`` holds of each leaf, in tree order:
    the cuts that take its piece from the full leaf, applied in order, each
    ``(dim, pieces, this rank's piece, the collectives axis whose group
    holds the other pieces)``.
    Over tp ranks (rank ``i * T + t`` of the ``(data, model)`` grid) tp
    chunk t of T along the leaf's tp dim (the ``MODEL`` group); under FSDP
    then data shard i of the N along its fsdp dim (``BOTH``: the data
    group over tp ranks, the whole ``(pod, data)`` grid at tp 1, where
    ``i`` is the rank). A leaf with neither dim is held whole (``()``)."""
    from repro_torch.core import collectives
    tp_d = tp_dims(cfg, tp)                  # all None at tp 1
    fs_d = fsdp_dims(cfg, tp) if fsdp else [None] * len(tp_d)
    cuts = []
    for a, b in zip(tp_d, fs_d):
        leaf = []
        if a is not None:
            leaf.append((a, tp, rank % tp, collectives.MODEL))
        if b is not None:
            leaf.append((b, ranks // tp, rank // tp, collectives.BOTH))
        cuts.append(tuple(leaf))
    return cuts


def cut_piece(leaf: torch.Tensor, cuts) -> torch.Tensor:
    """The rank's piece of a full leaf (:func:`rank_cuts`; None or ``()``:
    the leaf itself) as a contiguous copy of its own, so the full leaf can
    be freed."""
    if not cuts:
        return leaf
    for dim, n, piece, _ in cuts:
        leaf = split_leaf(leaf, dim, n)[piece]
    return leaf.clone(memory_format=torch.contiguous_format)


def cut_tree(full: Any, cuts: list, device: torch.device | str) -> Any:
    """The rank's tree on ``device``: :func:`cut_piece` of every leaf
    (``cuts`` in tree order), one leaf at a time."""
    return tree_unflatten(full, [cut_piece(leaf, c).to(device)
                                 for leaf, c in zip(tree_leaves(full), cuts)])


def gather_cut_tree(tree: Any, cuts: list, grid, *, keep: bool) -> Any:
    """The full tree of the ranks' pieces (a process group's
    ``collectives.Grid``): each leaf's cuts undone in reverse order, the
    pieces of each gathered from every rank of its axis and joined along
    its dim (under FSDP x TP the data group's shards of the tp chunk
    first, then the tp group's chunks), one leaf at a time; a leaf
    replicated over an axis reads this rank's copy. Every rank must call
    it. Where ``keep``, the full leaves are copied to the host and
    returned as a tree; elsewhere None (each gathered leaf is dropped at
    once)."""
    from repro_torch.core import collectives
    leaves = []
    for leaf, leaf_cuts in zip(tree_leaves(tree), cuts):
        full = leaf
        for dim, _, _, axis in reversed(leaf_cuts or ()):
            full = collectives.all_gather_dim(full, dim, grid, axis)
        if keep:
            leaves.append(full.detach().to("cpu", copy=True))
        del full
    return tree_unflatten(tree, leaves) if keep else None
