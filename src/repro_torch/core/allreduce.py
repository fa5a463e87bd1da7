"""Gradient-sync entry points over the composable collective pipeline.

Counterpart of ``src/repro/core/allreduce.py``: ``sync_bucket`` (one bucket
through the resolved spec), ``sync_packed`` (the engine core on a packed
``(P, B, bucket_elems)`` arena, one ``(B, bucket_elems)`` arena per peer),
``sync_pytree`` (pack -> ``sync_packed`` -> unpack) and
``reduce_scatter_axis`` (the FSDP gradient reduction through ``rs_spec``).
On a ``(pod, data)`` grid ``ctx.grid.pods`` gives the pod count G of the
arena's P = G * N peers (``core/collectives.py``).

Modes of ``sync_packed``:
  ``'scan'``       buckets strictly one after the other.
  ``'vmap'``       the reference's ``jax.vmap`` over the buckets, as one
                   batch: each stage runs once over all B buckets (one
                   encode, one exchange, one decode a step; each kernel one
                   launch), the buckets interleaved block by block
                   (``pipeline.interleave``) so that every shard, chunk and
                   Hadamard block of the batch holds the same elements of
                   each bucket as the bucket's own would. The draws are the
                   buckets' own, drawn together.
  ``'pipelined'``  the reference's stage skew (``_sync_pipelined``):
                   iteration k encodes bucket k, exchanges bucket k-1 and
                   decodes bucket k-2. Everything runs on one CUDA stream
                   here, so the order is kept but nothing overlaps yet.
All three run the same arithmetic a bucket on the same draws, so their
results are identical, bucket for bucket. ``sync_pytree_unfused`` is the
reference's parity oracle: the seed's loop over flat slices of the leaves.
"""
from __future__ import annotations

import torch

import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from . import collectives
from .bucket_plan import BucketPlan
from .pipeline import (CollectiveSpec, Hadamard, HTQuant, Identity, Lossy,
                       OptiReduceConfig, Reliable, SyncContext, TarTopology,
                       deinterleave, interleave, resolve_spec,
                       strategy_names)

__all__ = ["OptiReduceConfig", "SyncContext", "CollectiveSpec",
           "resolve_spec", "strategy_names", "sync_bucket", "sync_packed",
           "sync_pytree", "sync_pytree_unfused", "rs_spec",
           "reduce_scatter_axis"]

MODES = ("scan", "vmap", "pipelined")


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
                spec: CollectiveSpec | None = None,
                stale: torch.Tensor | None = None) -> torch.Tensor:
    """Sync a packed ``(P, B, bucket_elems)`` arena; returns a new arena of
    the same shape. Bucket b draws under ``ctx.for_bucket(b)`` (the
    reference's ``fold_in(key, b)``); loss counts accumulate in
    ``ctx.stats``.

    ``stale`` (optional, ``(B, bucket_elems)``, one copy for every peer):
    the previous step's synced arena, the prediction cache of a stale-fill
    recovery codec. Bucket b's row enters at its encode and rides the stage
    state through the skew; None leaves every path as without recovery."""
    if mode not in MODES:
        raise ValueError(f"unknown sync mode {mode!r}; one of {MODES}")
    if batch.dim() != 3:
        raise ValueError("sync_packed takes a (P, B, bucket_elems) arena, "
                         f"got shape {tuple(batch.shape)}")
    _check_device(batch, ctx.cfg)
    if spec is None:
        spec = resolve_spec(ctx.cfg)
    nbuckets, length = batch.shape[1], batch.shape[2]
    if stale is not None and tuple(stale.shape) != (nbuckets, length):
        raise ValueError(f"stale cache of shape {tuple(stale.shape)} for a "
                         f"({nbuckets}, {length}) arena a peer")
    if stale is not None and ctx.grid.pods > 1:
        raise ValueError("recovery does not compose with the 2D (pod, data) "
                         "hierarchy: the stale wire layout assumes one flat "
                         "TAR shard order")

    def stale_at(b):
        return None if stale is None else stale[b]

    if mode == "vmap":
        return _sync_batched(batch, ctx, spec, stale)
    out = torch.empty(batch.shape, dtype=torch.float32, device=batch.device)
    if mode == "scan":
        for b in range(nbuckets):
            out[:, b] = spec.all_reduce(batch[:, b],
                                        ctx.for_bucket(b, stale_at(b)))
        return out
    encoded: dict[int, tuple] = {}
    exchanged: dict[int, tuple] = {}
    for it in range(nbuckets + 2):
        if it < nbuckets:                                 # encode bucket k
            encoded[it] = spec.encode_stage(batch[:, it],
                                            ctx.for_bucket(it, stale_at(it)))
        k = it - 1
        if 0 <= k < nbuckets:                             # exchange k-1
            exchanged[k] = spec.exchange_stage(encoded.pop(k),
                                               ctx.for_bucket(k))
        k = it - 2
        if 0 <= k < nbuckets:                             # decode k-2
            out[:, k] = spec.decode_stage(exchanged.pop(k), length,
                                          ctx.for_bucket(k))
    return out


def _sync_batched(batch: torch.Tensor, ctx: SyncContext,
                  spec: CollectiveSpec,
                  stale: torch.Tensor | None) -> torch.Tensor:
    """``mode='vmap'``: the B buckets as one stack. Each bucket is padded
    as its own encode would pad it, the B padded rows are interleaved in
    runs of the codec's block, and the stack goes through the spec's three
    stages once, under a context that draws the B buckets' sites
    together; the result is taken apart the same way."""
    p, nbuckets, length = batch.shape
    cfg = ctx.cfg
    g = spec.codec.block(cfg)
    n = collectives.axis_size(batch[:, 0], ctx.grid)
    unit = spec.topology.pad_units(cfg, n) * g
    padded = -(-length // unit) * unit
    x = batch.to(torch.float32)
    if padded != length:
        x = F.pad(x, (0, padded - length))
    x = interleave(x.transpose(0, 1), g)                  # (P, B * L')
    st = None
    if stale is not None:
        st = stale if padded == length else F.pad(stale,
                                                  (0, padded - length))
        st = interleave(st, g)
    bctx = ctx.for_buckets(tuple(range(nbuckets)), g, st)
    out = spec.all_reduce(x, bctx)
    return deinterleave(out, nbuckets, g).transpose(0, 1)[..., :length]


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


def sync_pytree_unfused(grads, ctx: SyncContext, *,
                        bucket_elems: int = 6_553_600):
    """The seed bucketing loop, kept as the parity oracle for
    :func:`sync_pytree` (the reference's of the same name): the leaves'
    ``(P, *shape)`` stacks flattened and joined in tree order, cut into
    ``bucket_elems``-long slices (the last one shorter, padded only as its
    encode pads it), slice b synced as bucket b, and the result cut back
    into the leaves, each in its dtype."""
    spec = resolve_spec(ctx.cfg)
    leaves = tree_leaves(grads)
    p = leaves[0].shape[0]
    flat = torch.cat([leaf.reshape(p, -1).to(torch.float32)
                      for leaf in leaves], dim=1)
    total = flat.shape[1]
    parts = [sync_bucket(flat[:, start:start + bucket_elems],
                         ctx.for_bucket(b), spec=spec)
             for b, start in enumerate(range(0, total, bucket_elems))]
    synced = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    out, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(synced[:, off:off + size].reshape(leaf.shape)
                   .to(leaf.dtype))
        off += size
    return tree_unflatten(grads, out)


def rs_spec(cfg: OptiReduceConfig, *,
            with_drops: bool = True) -> CollectiveSpec:
    """The reduce-scatter spec for a config: TAR stage 1 with the rs codec.
    ``rs_wire_bits`` picks the shared-grid quantizer (the rotation comes
    with it); otherwise the Hadamard rotation rides along only when drops
    are live. The quantizer draws its noise under salt 9, so the rs wire
    never correlates with the bucketed stage-1 draws."""
    quant = cfg.rs_wire_bits
    use_ht = (with_drops and cfg.use_hadamard and cfg.drop_rate > 0) or \
        bool(quant)
    if quant:
        codec = HTQuant(bits=quant, noise_salt=9)
    elif use_ht:
        codec = Hadamard()
    else:
        codec = Identity()
    return CollectiveSpec(TarTopology(), Lossy() if with_drops else Reliable(),
                          codec)


def reduce_scatter_axis(g: torch.Tensor, axis, dim: int, ctx: SyncContext, *,
                        with_drops: bool = True) -> torch.Tensor:
    """OptiReduce as a reduce-scatter: TAR stage 1 + the compensated reduce
    on each peer's ``(P, *shape)`` tensor, scattering ``dim`` over ``axis``
    (``collectives.DATA`` or ``POD``). Returns ``(P, *shard)``: peer p's
    slice ``i`` of ``dim`` (i its index on the axis) holding the
    drop-compensated mean over the axis's peers. ``ctx.bucket`` names the
    gather site's draws."""
    _check_device(g, ctx.cfg)
    return rs_spec(ctx.cfg, with_drops=with_drops).reduce_scatter(
        g, axis, dim, ctx)
