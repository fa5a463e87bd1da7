"""Gradient-sync entry points over the composable collective pipeline.

Counterpart of ``src/repro/core/allreduce.py``: ``sync_bucket`` (one bucket
through the resolved spec), ``sync_packed`` (the engine core on a packed
``(P, B, bucket_elems)`` arena, one ``(B, bucket_elems)`` arena per peer)
and ``sync_pytree`` (pack -> ``sync_packed`` -> unpack).

Modes of ``sync_packed``:
  ``'scan'``       buckets strictly one after the other.
  ``'pipelined'``  the reference's stage skew (``_sync_pipelined``):
                   iteration k encodes bucket k, exchanges bucket k-1 and
                   decodes bucket k-2. Everything runs on one CUDA stream
                   here, so the order is kept but nothing overlaps yet.
Both run the same per-bucket stages on the same draws, so their results are
identical. The reference's ``'vmap'`` mode has no counterpart yet.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map

from .bucket_plan import BucketPlan
from .pipeline import (CollectiveSpec, OptiReduceConfig, SyncContext,
                       resolve_spec, strategy_names)

__all__ = ["OptiReduceConfig", "SyncContext", "CollectiveSpec",
           "resolve_spec", "strategy_names", "sync_bucket", "sync_packed",
           "sync_pytree"]

MODES = ("scan", "pipelined")


def _check_device(x: torch.Tensor, cfg: OptiReduceConfig) -> None:
    if cfg.use_kernels and not x.is_cuda:
        raise RuntimeError("use_kernels=True needs the tensors on a CUDA "
                           f"device, got {x.device}")


def sync_bucket(bucket: torch.Tensor, ctx: SyncContext,
                spec: CollectiveSpec | None = None) -> torch.Tensor:
    """Reduce one ``(P, L)`` bucket stack to its (approximate) mean over
    peers, held by every peer; ``ctx.bucket`` names its draws."""
    _check_device(bucket, ctx.cfg)
    if spec is None:
        spec = resolve_spec(ctx.cfg)
    return spec.all_reduce(bucket, ctx)


def sync_packed(batch: torch.Tensor, ctx: SyncContext, *,
                mode: str = "scan",
                spec: CollectiveSpec | None = None) -> torch.Tensor:
    """Sync a packed ``(P, B, bucket_elems)`` arena; returns a new arena of
    the same shape. Bucket b draws under ``ctx.for_bucket(b)`` (the
    reference's ``fold_in(key, b)``); loss counts accumulate in
    ``ctx.stats``."""
    if mode not in MODES:
        if mode == "vmap":
            raise NotImplementedError("sync mode 'vmap' is not ported yet: "
                                      "ROADMAP A7")
        raise ValueError(f"unknown sync mode {mode!r}; one of {MODES}")
    if batch.dim() != 3:
        raise ValueError("sync_packed takes a (P, B, bucket_elems) arena, "
                         f"got shape {tuple(batch.shape)}")
    _check_device(batch, ctx.cfg)
    if spec is None:
        spec = resolve_spec(ctx.cfg)
    nbuckets, length = batch.shape[1], batch.shape[2]
    out = torch.empty(batch.shape, dtype=torch.float32, device=batch.device)
    if mode == "scan":
        for b in range(nbuckets):
            out[:, b] = spec.all_reduce(batch[:, b], ctx.for_bucket(b))
        return out
    encoded: dict[int, tuple] = {}
    exchanged: dict[int, tuple] = {}
    for it in range(nbuckets + 2):
        if it < nbuckets:                                 # encode bucket k
            encoded[it] = spec.encode_stage(batch[:, it], ctx.for_bucket(it))
        k = it - 1
        if 0 <= k < nbuckets:                             # exchange k-1
            exchanged[k] = spec.exchange_stage(encoded.pop(k),
                                               ctx.for_bucket(k))
        k = it - 2
        if 0 <= k < nbuckets:                             # decode k-2
            out[:, k] = spec.decode_stage(exchanged.pop(k), length,
                                          ctx.for_bucket(k))
    return out


def sync_pytree(grads, ctx: SyncContext, *, bucket_elems: int = 6_553_600,
                plan: BucketPlan | None = None, mode: str = "scan",
                spec: CollectiveSpec | None = None):
    """Sync a tree whose leaves are ``(P, *shape)`` stacks through
    fixed-size buckets (25 MB of fp32, PyTorch DDP's default). ``plan``,
    when given, is built from one peer's leaves."""
    if plan is None:
        plan = BucketPlan.for_tree(tree_map(lambda g: g[0], grads),
                                   bucket_elems)
    return plan.unpack(sync_packed(plan.pack(grads), ctx, mode=mode,
                                   spec=spec))
