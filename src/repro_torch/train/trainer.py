"""Data-parallel trainer with OptiReduce as the gradient sync.

Counterpart of ``src/repro/train/trainer.py``, both of its data-parallel
modes. The reference runs one rank per device under ``shard_map``; here the
P peers live on one card as the leading axis of stacked tensors, pod-major
over the mesh's ``(pod, data)`` axes (``core/collectives.py``).

``replicated`` (the paper's mode). The gradients live in a **packed arena**
of shape ``(P, B, bucket_elems)``, one ``(B, bucket_elems)`` gradient arena
per peer:

1. peer p takes rows ``[p*b_local, (p+1)*b_local)`` of the global batch and
   packs its gradients (micro-batch by micro-batch, accumulated in
   ``accum_dtype``) straight into its arena row;
2. ``sync_packed`` syncs the whole arena (stage skew ``pipelined`` by
   default) with every kernel launch covering all P peers of a bucket;
3. after stage 2 every peer holds the same synced arena (the tests assert
   it), so the §3.4 guard, the global norm over ``plan.total`` entries and
   the clip run once, as one multiply, on peer 0's copy;
4. one optimizer update is applied, in place, to the single parameter copy
   — the parameters every replica would hold.

``fsdp`` (ZeRO-3). The reference shards every large weight over the dp axes
and gathers it at use through a custom VJP whose backward is OptiReduce's
reduce-scatter (TAR stage 1 + the compensated mean). On one card the
peers' shards side by side are the full weight, so the port keeps **one
full copy** of each parameter and optimizer leaf; peer p's shard is its
slice along the leaf's ``fsdp_dim``, pod-major. The gather
(``models/transformer.py``, ``pctx.gather``) hands the forward pass a fresh
autograd leaf over the full weight at each call site, keyed by (name, key):
the reference's sites and keys, so a recompute under ``remat`` or a weight
gathered twice (the tied embedding) never merges two sites. The peers run
one after another, so no peer's backward can see the others' gradients: the
reduce-scatter is deferred. Each site's gradients are stacked ``(P,
*shape)`` and, once the last peer of the micro-batch is done, reduced by
``core.allreduce.rs_spec`` in one pass over all peers per fsdp axis (outer
pod hop first, reliable; data hop with the drop model), under the site's
own draws (:data:`~repro_torch.core.pipeline.Site`). The peers' reduced
slices are the leaf's reduced gradient; sites sharing a leaf add. AdamW is
elementwise, so one update of the full tensor is every peer's update of its
own shard; the global norm is the reference's grouped sum of squares (one
partial sum per shard, summed over each sharded-axes set). The stacked
form saves no memory on one card: every leaf is held whole. The
replicated leaves (the norms) are
bucket-synced as in the reference, and ``loss_frac`` counts only them, as
the reference's does (its gather VJP's stats are thrown away; ROADMAP C).

The pod axis: a mesh with a ``pod`` axis, or ``pure_dp`` on the
``(data, model)`` host mesh, which takes the ``model`` axis as the pod axis
(the second level of the hierarchical 2D TAR).

Tensor parallelism: a ``model`` axis of T > 1 without ``pure_dp``. The
parameters are the reference's global, padded arrays
(``param_table(cfg, tp=T)``), stored once; tp rank t's local leaf is the
t-th of T contiguous chunks of the leaf's tp dim (the whole leaf when it is
replicated over tp). Each data peer runs the forward and backward pass of
its whole tp group at once (``models/parallel.py``: one activation, the
row-parallel partial products summed by ``psum_tp``), which gives the
gradient of every global leaf: the correct one, where the reference's
``check_vma=False`` step scales its sharded leaves' gradients by T and
leaves partial sums in its replicated ones (ROADMAP C). The peer grid gains
the model axis, outermost (``core/collectives.py``): rank (t, p) packs its
*local* gradients into row ``t * P + p`` of a ``(T * P, B, bucket_elems)``
arena whose ``BucketPlan`` is made from the local shapes, as the
reference's body sees them, and ``sync_packed`` syncs over ``data`` within
each tp group (the same draws in every group: the reference's sync key is
the same on every tp rank), all groups in one launch a bucket. After the
sync each tp rank's synced slice goes back into its chunk of the global
gradient, and the replicated leaves take tp rank 0's synced values, which
is what the reference's global array reads back as. The global norm sums
one partial sum a shard over exactly each leaf's sharded axes, a replicated
leaf counted once. Under FSDP x TP each gather site's gradient is cut into
its T tp shards, stacked ``(T * P, *local)``, and reduce-scattered over the
dp axes within each tp group. ``seq_parallel`` runs the residual stream as
sequence slices (Megatron-SP), the same values. Recovery does not compose
with tp > 1, as the reference's launcher fails on it (ROADMAP C).

With ``sync.recovery`` armed (DESIGN §8, core/recovery.py; replicated, one
pod) the step also threads the recovery state: the carried error-feedback
residual ``ef`` ``(P, B, E)`` joins each peer's arena before the sync, the
stale cache ``stale`` ``(B, E)`` feeds the fill, and the step returns the
next state (this step's synced arena as the cache, the new residuals).

One rank a peer (``build_train_step(..., group=)``, the launcher under
``torchrun``): the peers are a ``torch.distributed`` process group's ranks
(``collectives.rank_grid``), pod-major over ``(pod, data)`` (``pure_dp``'s
``model`` axis or a ``pod`` axis as the pods: rank ``g * N + i``, each pod
a data group, each data index a pod group), each rank runs its own rows of
the global batch once and the syncs cross processes. Replicated: the rank
packs a ``(1, B, bucket_elems)`` arena; every rank then holds the same
synced arena, so the guard, norm, clip and update above run on each rank
alike and the replicas stay bitwise equal. FSDP (ZeRO-3): the rank holds
only its shard of every sharded leaf (its pod-major slice along the leaf's
``fsdp_dim``, ``train/elastic.py``) and of that leaf's optimizer state; the
gather builds the full weight from every rank's shard over the whole grid
(``collectives.all_gather_dim``), a fresh leaf a site, the deferred VJP
reduce-scatters the rank's ``(1, *shape)`` gradient, the pod hop in its pod
group and then the data hop in its data group, and keeps the rank's
reduced shard, and the update runs on the shards in place. The global norm
sums the squares of each rank's own shards, gathers the per-rank partial
sums over the whole grid and adds them as the stacked form adds its
per-shard ones, so norm, clip and every shard are bitwise the stacked
form's.

Tensor parallelism over ranks (a ``model`` axis of T > 1 with ``group``
of N x T ranks, ``collectives.rank_grid(group, tp=T)``: rank ``i * T +
t``, each data index's tp group and each tp index's data group): each rank
holds only its tp shard of every tp-sharded leaf and of its AdamW moments
(``train/elastic.py``) and runs its own shards' forward and backward pass
on its data index's rows, the row-parallel sums and their backward
reduces in its tp group (``models/parallel.py``). It packs a ``(1, B,
bucket_elems)`` arena of its local leaves, the plan the stacked form makes
from tp rank 0's local shapes, and syncs it in its data group with the
draws every tp rank of the index draws alike. After the sync the leaves
replicated over tp take tp rank 0's synced values (gathered over the tp
group), as the stacked form reads them; the norm sums each model-sharded
run's per-rank sums of squares over the tp group in rank order and reads
the replicated runs once, so every rank of a tp group holds the same norm
and clip, and the replicated leaves stay bitwise equal across the tp group
and the data replicas. FSDP x TP over ranks: the rank holds only block
``(i, t)`` of every leaf sharded over both (data shard i of tp chunk t,
``train/elastic.py``'s ``rank_cuts``) and of its moments; the gather
builds its tp chunk over its data group, the deferred VJP reduce-scatters
its tp-local gradient in its data group (a site replicated over tp takes
tp rank 0's reduced shard), the small leaves sync in the data group and
take tp rank 0's values, and the norm gathers every rank's partial sums
over the whole grid in the stacked form's order. The dense, MoE, SSM and
frontend-prefix families (a rank holding only its own experts or SSM
heads; the router, ``wB`` and ``wC`` replicated over tp, their gradients
summed over the tp group by ``copy_tp``; Mamba-2's ``conv_w``, ``a_log``,
``dt_bias`` and ``d_skip``, tp-sharded with no FSDP dim, in the small
bucket, each rank keeping its own chunk; ``frontend_proj`` replicated over
tp, its gradient whole on every rank: the residual stream's gradient is),
one pod, and ``seq_parallel`` with the dense block (a rank's residual
stream its sequence slice, the norms' gradients summed over the tp group
by ``copy_seq``, so every replicated leaf's gradient is whole before the
sync and tp rank 0's synced values are the step's); pods x tp, Adafactor,
the hybrid family and the MoE or SSM block under SP over tp ranks raise
(later slices of ROADMAP A18c). A step is not bitwise
the stacked one: a rank's "f" adds T partial input gradients where the
stacked form runs one GEMM.

The loss metric is the mean over peers; ``loss_frac`` the mean over
receivers. ``tc.transport_override`` swaps the spec's transport for the
bucketed sync (the launcher's ``WireTransport``, whose masks a host wire
observes: replicated, one bucket exchange a call; error feedback refuses
it, its masks being irreproducible at the sender).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.core import recovery as recovery_lib
from repro_torch.core.allreduce import (OptiReduceConfig, rs_spec,
                                        sync_packed, sync_pytree)
from repro_torch.core.bucket_plan import BucketPlan
from repro_torch.core.keys import Key, fold_in
from repro_torch.core.pipeline import (Draws, ThreefryDraws, SyncContext,
                                       resolve_spec)
from repro_torch.core.safeguards import guard_scale, guard_update
from repro_torch.kernels import runtime as kernel_runtime
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm_loss, param_specs, param_table
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import (_map_table, check_tp_ranks,
                                            tp_dims)
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    sync: OptiReduceConfig = OptiReduceConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    dp_mode: str = "replicated"          # 'replicated' | 'fsdp'
    microbatch: int | None = None        # per-peer micro-batch (grad accum)
    seq_chunk: int = 1024                # loss sequence chunking
    remat: bool = True
    bucket_elems: int = 6_553_600        # 25 MB fp32 buckets
    sync_mode: str = "pipelined"         # 'pipelined' | 'scan' | 'vmap'
    guard: bool = True                   # §3.4 skip-update safeguard
    accum_dtype: torch.dtype = torch.float32
    # pure data parallelism on a single-pod mesh: the 'model' axis is a
    # second data level (hierarchical 2D TAR over (model, data))
    pure_dp: bool = False
    # sequence parallelism (Megatron-SP) over the tp ranks; needs
    # seq_len % tp == 0
    seq_parallel: bool = False
    # a transport that replaces the resolved spec's (replicated DP only)
    transport_override: Any = None
    kernel_mode: str | None = None       # kernels/runtime mode, None = as is


def mesh_axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes_of(mesh) -> tuple[str, ...]:
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _fsdp_leaf_mask(cfg: ModelConfig, fsdp_axes) -> list[bool]:
    """Which leaves (tree order) are fsdp-sharded (their gradients arrive
    through the gather's reduce-scatter) and which replicated (bucket
    sync)."""
    table = param_table(cfg, fsdp_axes=fsdp_axes)
    return tree_leaves(_map_table(lambda leaf: leaf.fsdp_dim is not None,
                                  table))


def _spec_axes(spec) -> tuple[str, ...]:
    axes: list[str] = []
    for entry in spec:
        if entry is None:
            continue
        axes.extend(entry if isinstance(entry, tuple) else (entry,))
    return tuple(axes)


def _summed_groups(pairs) -> dict[tuple[str, ...], torch.Tensor]:
    """Sum (axes, squared sums) pairs into one accumulator per distinct
    sharded-axes set (canonicalised by sort)."""
    groups: dict[tuple[str, ...], torch.Tensor] = {}
    for axes, ss in pairs:
        key = tuple(sorted(axes))
        prev = groups.get(key)
        groups[key] = ss if prev is None else prev + ss
    return groups


def _psum_group_total(groups) -> torch.Tensor:
    """The groups' total: a sharded group's per-shard partial sums are
    summed over its shards (the reference's psum over its axes)."""
    total = None
    for ss in groups.values():
        ss = ss.sum() if ss.dim() else ss
        total = ss if total is None else total + ss
    return total


def _shard_sumsq(g: torch.Tensor, spec, sizes,
                 whole: bool = True) -> torch.Tensor:
    """Sum of squares of a leaf in fp32: a scalar when replicated, else
    one partial sum per shard, ``(k,)`` (k the product of the sharded
    dims' axis sizes: ``model`` on the tp dim, the fsdp axes pod-major on
    another), as each rank of the reference sums its own shard. Each
    shard is summed alone, as one contiguous run, so a rank that holds
    only its shard (``whole`` off: ``g`` is that shard, ``(1,)``) sums it
    to the same bits."""
    g = g.to(torch.float32)
    dims = [(d, e) for d, e in enumerate(spec) if e is not None]
    if not dims:
        return torch.sum(g * g)
    if whole:
        # cut every sharded dim into its shards, moved to the front
        parts = g
        for i, (d, entry) in enumerate(dims):
            k = math.prod(sizes[a] for a in _spec_axes((entry,)))
            parts = parts.unflatten(d + i, (k, -1)).movedim(d + i, i)
        parts = parts.reshape(math.prod(parts.shape[:len(dims)]), -1)
    else:
        parts = g.reshape(1, -1)
    return torch.stack([torch.sum(row * row) for row in parts])


def sharded_global_norm(grads, specs, sizes,
                        grid: collectives.Grid = collectives.ONE,
                        axes: dict | None = None) -> torch.Tensor:
    """Global L2 norm of a gradient tree whose leaves are sharded per
    ``specs`` over axes of ``sizes``: each shard's squared sum, summed over
    exactly the axes its leaf is sharded on, leaves grouped by their
    sharded-axes set (one sum a group), so replicated leaves count once.
    Over a process group (``grid.group``) a sharded leaf is this rank's
    piece: every rank's partial sums are gathered and laid out as the
    stacked form's per-shard vectors (:func:`_rank_partials`), so every
    rank adds the stacked form's values in its order and holds the same
    norm. ``axes`` maps a spec's axis names to the grid's axes where they
    differ (``pure_dp``'s ``model`` axis is the pod axis)."""
    leaf_specs = _spec_leaves(specs)
    whole = grid.group is None
    sums = [_shard_sumsq(g, s, sizes, whole)
            for g, s in zip(tree_leaves(grads), leaf_specs)]
    if not whole:
        sums = _rank_partials(sums, leaf_specs, grid, axes or {})
    return torch.sqrt(_psum_group_total(_summed_groups(
        zip(map(_spec_axes, leaf_specs), sums))))


def _rank_partials(sums: list, specs: list, grid: collectives.Grid,
                   axes: dict) -> list:
    """Over a process group: each sharded leaf's ``(1,)`` partial sum of
    this rank as the stacked form's ``(k,)`` vector of every rank's, all
    leaves' in one gather over the tp group and one over the ``(pod,
    data)`` grid. Position k of a leaf is the shard its sharded dims'
    indices name, in dim order, each dim's axes pod-major, as
    :func:`_shard_sumsq` lays them out; an axis the leaf is not sharded on
    reads the rank at index 0 (a leaf replicated over tp: tp rank 0's)."""
    at = [i for i, ss in enumerate(sums) if ss.dim()]
    if not at:
        return sums
    own = torch.cat([sums[i] for i in at])[None]
    # (ranks, m): the tp group's rows, then the grid's, rank (g * N + i)
    # * T + t
    rows = collectives.gather_peers(own, grid, collectives.MODEL)
    rows = collectives.gather_peers(rows.reshape(1, -1), grid,
                                    collectives.BOTH).reshape(-1, len(at))
    size = {collectives.POD: grid.pods, collectives.MODEL: grid.tp,
            collectives.DATA: grid.ranks // (grid.pods * grid.tp)}
    out = list(sums)
    for col, i in enumerate(at):
        names = [axes.get(a, a) for a in _spec_axes(specs[i])]
        ranks = []
        for idx in itertools.product(*(range(size[a]) for a in names)):
            on = dict(zip(names, idx))
            ranks.append((on.get(collectives.POD, 0) * size[collectives.DATA]
                          + on.get(collectives.DATA, 0)) * grid.tp
                         + on.get(collectives.MODEL, 0))
        out[i] = rows[:, col].index_select(
            0, collectives.index(tuple(ranks), rows.device))
    return out


def _spec_leaves(specs) -> list[tuple]:
    """The specs of a tree in leaf order (a spec is a tuple of entries, not
    a subtree)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def packed_global_norm(ranks: torch.Tensor, plan: BucketPlan, specs,
                       grid: collectives.Grid = collectives.ONE
                       ) -> torch.Tensor:
    """:func:`sharded_global_norm` over the T tp ranks' packed ``(T, B,
    bucket_elems)`` arenas of one data peer (T = 1 without tensor
    parallelism), over their ``plan.total`` real entries (the zero-padded
    tail excluded). Adjacent leaves that are both sharded over ``model``,
    or both not, coalesce into one contiguous run, one sum of squares a
    run: a run sharded over ``model`` sums every tp rank's arena (one
    partial sum a shard); any other run is read once, from tp rank 0's.
    The data axes shard nothing here: the arena holds full tensors. Over
    tp ranks (``grid`` with a model group) ``ranks`` is this rank's ``(1,
    B, bucket_elems)`` arena: each run's sum of squares is taken here, and
    a sharded run's sums are gathered over the tp group and added in rank
    order, so every tp rank holds the same norm."""
    flat = ranks.reshape(ranks.shape[0], -1)
    runs: list[tuple[bool, int, int]] = []
    for off, size, s in zip(plan.offsets, plan.sizes, _spec_leaves(specs)):
        on_tp = "model" in _spec_axes(s)
        if runs and runs[-1][0] == on_tp and runs[-1][2] == off:
            runs[-1] = (on_tp, runs[-1][1], off + size)
        else:
            runs.append((on_tp, off, off + size))
    if grid.tp_rows != grid.tp:                    # tp ranks over a group
        own = torch.stack([torch.sum(torch.square(
            flat[0, a:b].to(torch.float32))) for _, a, b in runs])
        summed = collectives.psum(own[None], grid, collectives.MODEL)[0]
        parts = [summed[i] if on_tp else own[i]
                 for i, (on_tp, _, _) in enumerate(runs)]
    else:
        parts = [torch.sum(torch.square(
            (flat[:, a:b] if on_tp else flat[0, a:b]).to(torch.float32)))
            for on_tp, a, b in runs]
    total = None
    for ss in parts:
        total = ss if total is None else total + ss
    return torch.sqrt(total)


def _tp0_values(parts: list, grid: collectives.Grid) -> list:
    """Over tp ranks: tp rank 0's values of tensors every tp rank holds a
    copy of, one gather over the tp group for all of them (carried in the
    widest of their dtypes, which holds each exactly)."""
    if not parts:
        return []
    wide = functools.reduce(torch.promote_types, (p.dtype for p in parts))
    own = torch.cat([p.reshape(-1).to(wide) for p in parts])
    first = collectives.gather_peers(own[None], grid, collectives.MODEL)[0]
    return [x.view(p.shape).to(p.dtype) for x, p in zip(
        first.split([p.numel() for p in parts]), parts)]


def _replicated_from_tp0(g: torch.Tensor, plan: BucketPlan, leaf_tp: list,
                        grid: collectives.Grid) -> torch.Tensor:
    """Over tp ranks: this rank's synced ``(1, B, bucket_elems)`` arena
    with the entries of every leaf replicated over tp (``leaf_tp`` None)
    replaced by tp rank 0's, gathered over the tp group (its data group's
    sync rounds them with its own shards' entries), as the stacked form
    reads tp rank 0's."""
    g = g.contiguous()
    flat = g.view(-1)
    spans = [(off, off + size) for off, size, d
             in zip(plan.offsets, plan.sizes, leaf_tp) if d is None]
    for (a, b), first in zip(spans, _tp0_values(
            [flat[a:b] for a, b in spans], grid)):
        flat[a:b] = first
    return g


def _local(batch: dict, rows: slice, device: torch.device) -> dict:
    return {k: torch.as_tensor(v[rows]).to(device) for k, v in batch.items()}


class FsdpGather:
    """The FSDP weight gather and its deferred VJP, OptiReduce's
    reduce-scatter (the reference's custom-VJP ``gather``).

    ``gather(w, dim, path, name)`` (installed as ``ParallelCtx.gather``)
    hands the forward pass a fresh autograd leaf over the full weight ``w``
    (on one card the peers' shards side by side are the whole tensor), one
    a site, a site being (name, path): the reference's call sites, each
    with its key path below the step key (``()`` or ``(l,)``).
    ``backward`` takes one peer's gradients of its sites into each site's
    ``(P, *shape)`` stack; once the last peer of a micro-batch is done,
    ``reduce`` runs each stack's reduce-scatter over all peers, one hop a
    fsdp axis, outer first, under the site's own draws, and yields the view
    ``w`` with the reduced gradient of the full weight (the peers' slices,
    pod-major), in the gradient's dtype. With T tp ranks a peer's gradient
    enters the stack as its T tp shards (rows ``t * P + p``), each tp group
    reduce-scatters its own, and the reduced shards go back into the
    global weight's tp chunks (tp rank 0's for a weight replicated over
    tp).

    Over a process group (one rank a peer) ``w`` is this rank's shard: the
    gather builds the full weight from every rank's shard over the fsdp
    axes, pod-major (:func:`collectives.all_gather_dim` over ``BOTH``: the
    whole ``(pod, data)`` grid, or over tp ranks the rank's data group,
    which gives the forward pass the rank's whole tp chunk), a stack holds
    the rank's one row (over tp ranks its tp-local gradient as it is),
    each hop runs in the rank's group of its axis, and ``reduce`` yields
    ``w`` with the rank's reduced shard gradient; a site whose weight is
    replicated over tp takes tp rank 0's reduced shard (gathered over the
    tp group), as the stacked form reads it."""

    def __init__(self, cfg: OptiReduceConfig, hops,
                 grid: collectives.Grid = collectives.ONE,
                 tp_dims: dict | None = None):
        self.cfg, self.hops, self.grid = cfg, hops, grid
        self.tp_dims = tp_dims or {}  # site name -> the weight's tp dim
        # the tp ranks are processes: a site's gradient is this rank's own
        self.tp_ranks = grid.tp_rows != grid.tp
        self.taken: dict = {}     # this forward: site -> (leaf, dim, view)
        self.stacks: dict = {}    # site -> ((T*P, *local) stack, dim, view)

    def gather(self, w: torch.Tensor, dim: int, path: tuple[int, ...],
               name: str) -> torch.Tensor:
        site = (name, path)
        if site in self.taken:
            raise RuntimeError(f"gather site {site} taken twice in one "
                               "forward pass")
        full = collectives.all_gather_dim(w.detach(), dim, self.grid)
        leaf = full.requires_grad_(True)
        self.taken[site] = (leaf, dim, w)
        return leaf

    def backward(self, loss: torch.Tensor, peer: int, peers: int,
                 inputs: list) -> tuple:
        """``loss``'s gradients for the peer in row ``peer`` of ``peers``
        rows: its sites' into their stacks; those of ``inputs`` (the
        replicated leaves) returned."""
        order = list(self.taken)
        grads = torch.autograd.grad(
            loss, [self.taken[site][0] for site in order] + list(inputs))
        for site, g in zip(order, grads):
            local = (g[None] if self.tp_ranks else
                     to_tp(g, self.tp_dims.get(site[0]), self.grid.tp))
            if site not in self.stacks:
                _, dim, w = self.taken[site]
                self.stacks[site] = (g.new_empty((self.grid.tp_rows * peers,
                                                  *local.shape[1:])), dim, w)
            self.grid.by_group(self.stacks[site][0])[:, peer] = local
        self.taken = {}
        return grads[len(order):]

    def reduce(self, draws: Draws):
        """Yield ``(view, reduced gradient)`` a site and drop the stacks.
        A site's draws are ``draws`` (keyed on the step key) at its path."""
        stacks, self.stacks = self.stacks, {}
        for (name, path), (stack, dim, w) in stacks.items():
            ctx = SyncContext(cfg=self.cfg, draws=draws, bucket=path,
                              grid=self.grid)
            g = stack
            for axis, hop in self.hops:
                g = hop.reduce_scatter(g, axis, dim, ctx)
            local = torch.stack([torch.cat(r.unbind(0), dim=dim)
                                 for r in self.grid.by_group(g).unbind(0)])
            d = self.tp_dims.get(name)
            if not self.tp_ranks:
                out = from_tp(local, d)
            elif d is None:
                out = _tp0_values([local[0]], self.grid)[0]
            else:
                out = local[0]
            yield w, out.to(stack.dtype)


def make_fsdp_gather(sync_cfg: OptiReduceConfig, fsdp_axes, data_axis: str,
                     grid: collectives.Grid = collectives.ONE,
                     tp_dims: dict | None = None) -> FsdpGather:
    """The gather over ``fsdp_axes`` (outer first) with one reduce-scatter
    spec an axis: drops are modelled only on the data axis, the pod hop is
    the reliable inter-pod aggregation. ``tp_dims`` gives each site name's
    tp dim in the gathered weight (None or absent: replicated over tp)."""
    hops = [(collectives.DATA if ax == data_axis else collectives.POD,
             rs_spec(sync_cfg, with_drops=ax == data_axis))
            for ax in fsdp_axes]
    return FsdpGather(sync_cfg, hops, grid, tp_dims)


def to_tp(g: torch.Tensor, dim: int | None, tp: int) -> torch.Tensor:
    """A global tensor as its T tp ranks' local tensors, ``(T, *local)``:
    the T contiguous chunks of ``dim`` (views), or T views of the whole
    tensor when it is replicated over tp (``dim`` None)."""
    if dim is None:
        return g.expand(tp, *g.shape)
    return g.unflatten(dim, (tp, -1)).movedim(dim, 0)


def from_tp(local: torch.Tensor, dim: int | None) -> torch.Tensor:
    """Inverse of :func:`to_tp` on synced values: the T chunks put back
    along ``dim``, or tp rank 0's tensor for a replicated one."""
    if dim is None:
        return local[0]
    return local.movedim(0, dim).flatten(dim, dim + 1)


def _site_tp_dims(cfg: ModelConfig, tp: int) -> dict[str, int | None]:
    """The tp dim of every gather site's weight: the layer leaves of every
    period position without their stack dim, the embedding (and its tied
    head) on the vocab."""
    if tp == 1:
        return {}
    table = param_table(cfg, tp=tp)
    dims = {k: (v.tp_dim - 1 if v.tp_dim is not None else None)
            for stage in table["stages"] for k, v in stage.items()}
    dims["embed"] = dims["head"] = table["embed"].tp_dim
    if "lm_head" in table:
        dims["lm_head"] = table["lm_head"].tp_dim
    return dims


def _grad_view(w: torch.Tensor, owners: dict) -> torch.Tensor:
    """The slice of its parameter's gradient buffer that the view ``w`` of
    that parameter covers (a layer's row of a stacked leaf, or the leaf)."""
    param, buf = owners[w.untyped_storage().data_ptr()]
    off = w.storage_offset() - param.storage_offset()
    return buf.as_strided(w.shape, w.stride(), buf.storage_offset() + off)


# the reference's FSDP step with Adafactor fails as it traces (ROADMAP C):
# its factored statistics are declared replicated, at the global shapes,
# while each device's gradient has its shard's
ADAFACTOR_FSDP = (
    "FSDP with Adafactor does not run in the reference: its step replicates "
    "Adafactor's factored statistics at the global shapes while each device "
    "updates its shard, and fails as it traces (TypeError: add got "
    "incompatible shapes for broadcasting; ROADMAP C); use --dp-mode "
    "replicated or another optimizer")


def _check_rank_form(cfg: ModelConfig, tc: TrainConfig, pod_axis,
                     tp: int) -> None:
    """Raise on what the one-rank-a-peer form does not run yet, each with
    its ROADMAP item (A18c's later slices)."""
    refused = [
        (tp > 1 and pod_axis is not None, "pods x tp over ranks"),
        (tc.sync_mode == "vmap", "--sync-mode vmap over ranks"),
        (tc.sync.recovery != "none", "--recovery over ranks"),
        (tc.transport_override is not None, "--transport over ranks"),
        # its factored statistics of a leaf span the leaf's tp shards
        (tp > 1 and tc.optimizer.name == "adafactor",
         "Adafactor over tp ranks")]
    for bad, what in refused:
        if bad:
            raise ValueError(f"{what} is a later slice of ROADMAP A18c: "
                             "one rank a peer runs replicated data "
                             "parallelism and FSDP over (pod, data) at "
                             "tp 1, and the dense, MoE, SSM and "
                             "frontend-prefix families replicated or FSDP "
                             "over (data, model), the dense block also "
                             "with --seq-parallel")
    if tp > 1:
        check_tp_ranks(cfg, seq_parallel=tc.seq_parallel)


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None, *,
                     peers: int | None = None, device: torch.device | str,
                     group=None) -> tuple[Callable, Any]:
    """Returns ``(step_fn, opt)``; ``step_fn(params, opt_state, batch, step,
    key, draws=None, site_draws=None) -> (params, opt_state, metrics)``
    updates ``params`` and ``opt_state`` in place. ``mesh``
    (``launch.mesh.make_host_mesh``) gives the peer grid, ``peers=N`` the
    one-axis grid of N; ``batch`` is the global batch (numpy or tensors)
    split over the peers, pod-major. ``draws`` overrides the step's default
    :class:`ThreefryDraws` of the bucketed sync (keyed on the step's sync
    key), ``site_draws`` that of the FSDP gather sites (keyed on the step
    key; a site's draws are ``bucket=()`` for the embedding, ``(l,)`` for
    layer l): a test hands in the reference's.

    With ``tc.sync.recovery`` armed the call takes ``rec_state=`` (from
    ``recovery.init_state``) and returns ``(params, opt_state, rec_state,
    metrics)``: a new state, never sharing storage with the old one, and a
    ``filled`` metric, the lost wire entries the stale cache filled.

    ``group`` (a ``torch.distributed`` process group) runs one peer a
    rank: the mesh's pod and data axes are the group's ranks, pod-major
    (``collectives.rank_grid(group, pods=G)``), this rank runs the
    forward and backward pass of its own rows of the global batch once and
    syncs over the grid's groups. Replicated, it packs
    a ``(1, B, bucket_elems)`` arena; under FSDP ``params`` and
    ``opt_state`` hold this rank's shard of every sharded leaf
    (``train/elastic.py``: ``rank_cuts``) and the rest whole. Every
    decision after the sync reads values every rank holds bitwise (the
    synced arena or norm, the gathered loss fraction), so the replicas, or
    the shards against the stacked form's slices, stay equal; ``loss`` is
    the mean of the gathered per-rank losses in rank order, as the stacked
    form's."""
    if (mesh is None) == (peers is None):
        raise ValueError("build_train_step takes a mesh or peers=, one of "
                         "them")
    if mesh is None:
        mesh = make_host_mesh(dp=peers)
    if tc.dp_mode not in ("replicated", "fsdp"):
        raise ValueError(f"unknown dp_mode {tc.dp_mode!r}")
    if tc.kernel_mode is not None:
        kernel_runtime.set_kernel_mode(tc.kernel_mode)
    device = torch.device(device)
    names, shape = mesh_axis_names(mesh), mesh.shape
    if tc.pure_dp:
        if "pod" in names:
            raise ValueError("pure_dp is a single-pod remap")
        data_axis, pod_axis = "data", "model"   # second data level
        dp_axes = ("model", "data")
        tp = 1
    else:
        dp_axes = dp_axes_of(mesh)
        data_axis = "data" if "data" in names else None
        pod_axis = "pod" if "pod" in names else None
        tp = shape.get("model", 1)
    pods = shape[pod_axis] if pod_axis else 1
    peers = pods * (shape[data_axis] if data_axis else 1)
    over_ranks = group is not None and tp > 1
    if group is None:
        grid = collectives.Grid(pods, tp)
        local_peers = tuple(range(peers))
    else:
        _check_rank_form(cfg, tc, pod_axis, tp)
        import torch.distributed as dist
        if dist.get_world_size(group) != peers * tp:
            raise ValueError(f"a grid of {peers} peers ({pods} pods"
                             + (f", tp {tp}" if tp > 1 else "")
                             + ") over a process group of "
                             f"{dist.get_world_size(group)} ranks")
        # one peer a rank (pod-major, or data-major over tp ranks): the
        # rank's data index's rows of the global batch
        grid = collectives.rank_grid(group, pods=pods, tp=tp)
        local_peers = (grid.rank,)
    fsdp = tc.dp_mode == "fsdp"
    fsdp_axes = dp_axes if fsdp else None
    if fsdp and tc.optimizer.name == "adafactor":
        raise ValueError(ADAFACTOR_FSDP)

    sync_cfg = dataclasses.replace(tc.sync, data_axis=data_axis or "data",
                                   pod_axis=pod_axis)
    spec = resolve_spec(sync_cfg)          # fail fast on unknown settings
    rec_policy = recovery_lib.parse(sync_cfg.recovery)
    if rec_policy.any:
        if fsdp:
            raise ValueError(
                "recovery rides the bucketed sync path (stale arena + EF "
                "residuals are arena-shaped); fsdp grads reduce through "
                "rs_spec — use dp_mode='replicated'")
        if pod_axis is not None:
            raise ValueError(
                "recovery does not compose with the 2D (pod, data) "
                "hierarchy yet: the stale/EF wire-space layout assumes a "
                "single flat TAR shard order")
        if tp > 1:
            raise ValueError(
                "recovery does not compose with tensor parallelism: the "
                "reference's launcher sizes the recovery state from the "
                "global parameters while its trainer packs each tp rank's "
                "local ones, and fails ('stale cache ... longer than the "
                "padded bucket'; ROADMAP C)")
        if rec_policy.ef and tc.transport_override is not None:
            raise ValueError(
                "recovery='ef'/'ef+budget' reconstructs sender-arrival masks "
                "from the synthetic drop model; a transport override's masks "
                "are not reproducible at the sender — use recovery='stale'")
    if tc.transport_override is not None:
        if fsdp:
            raise ValueError("transport_override drives the bucketed sync "
                             "path; fsdp grads reduce through rs_spec")
        spec = dataclasses.replace(spec, transport=tc.transport_override)
    opt = make_optimizer(tc.optimizer)
    p_specs = param_specs(cfg, tp=tp, fsdp_axes=fsdp_axes)
    leaf_tp = tp_dims(cfg, tp)
    pctx = ParallelCtx(tp_axis="model" if tp > 1 else None,
                       dp_axis=data_axis, pod_axis=pod_axis, fsdp=fsdp,
                       sizes=shape, sp=tc.seq_parallel and tp > 1,
                       tp_grid=grid if over_ranks else None)

    def local_rows(g: torch.Tensor, d: int | None) -> torch.Tensor:
        """A leaf's tp ranks' local tensors, ``(T, *local)``; over ranks
        this rank's own, ``(1, *local)``."""
        return g[None] if over_ranks else to_tp(g, d, tp)

    def from_rows(x: torch.Tensor, d: int | None) -> torch.Tensor:
        """Inverse of ``local_rows`` on synced values."""
        return x[0] if over_ranks else from_tp(x, d)
    if fsdp:
        fsdp_mask = _fsdp_leaf_mask(cfg, fsdp_axes)
        site_tp = _site_tp_dims(cfg, tp)

    def split(batch):
        gb = len(batch["tokens"])
        if gb % peers:
            raise ValueError(f"global batch {gb} not divisible by {peers} "
                             "peers")
        b_local = gb // peers
        mb = tc.microbatch or b_local
        return b_local, mb, max(1, b_local // mb)

    def replicated_grads(params, batch, b_local, mb, n_micro, ctx,
                         rec_state):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # the plan of one tp rank's local leaves (the whole tree at tp = 1)
        local_like = [local_rows(p, d)[0] for p, d in zip(leaves, leaf_tp)]
        plan = BucketPlan.for_tree(tree_unflatten(params, local_like),
                                   tc.bucket_elems)
        arena_dtype = torch.float32 if n_micro == 1 else tc.accum_dtype
        arena = torch.zeros((grid.tp_rows * len(local_peers),
                             plan.num_buckets, plan.bucket_elems),
                            dtype=arena_dtype, device=device)
        ranks = grid.by_group(arena)
        losses = []
        for row, peer in enumerate(local_peers):
            loss_p = torch.zeros((), device=device)
            for i in range(n_micro):
                lo = peer * b_local + i * mb
                mbatch = _local(batch, slice(lo, lo + mb), device)
                loss = lm_loss(params, mbatch, cfg, seq_chunk=tc.seq_chunk,
                               remat=tc.remat, pctx=pctx)
                # a leaf the forward pass does not reach (a frontend's
                # projection without a prefix) has a zero gradient
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]
                # each tp rank's local gradients into its own row
                grads = [local_rows(g, d) for g, d in zip(grads, leaf_tp)]
                plan.pack_into(ranks[:, row], tree_unflatten(params, grads),
                               accumulate=i > 0)
                loss_p = loss_p + loss.detach()
            losses.append(loss_p / n_micro)
        if n_micro > 1:
            # accumulate in accum_dtype, take the mean in fp32 wire space
            arena = arena.to(torch.float32) / n_micro

        if rec_policy.ef:
            # the carried residual joins each peer's contribution
            arena += rec_state["ef"]
        synced = sync_packed(arena, ctx, mode=tc.sync_mode, spec=spec,
                             stale=None if rec_state is None
                             else rec_state["stale"])
        loss_frac = ctx.loss_fraction().to(device)
        new_rec = None
        if rec_state is not None:
            # next step's prediction: this step's synced arena, pre-guard
            # and pre-clip (a copy: the view would hold all P peers' arenas)
            new_rec = {"stale": synced[0].clone()}
            if rec_policy.ef:
                # the residual against the pre-update cache: what the fill
                # applied in each peer's stead
                new_rec["ef"] = recovery_lib.ef_residual_arena(
                    arena, ctx, stale=rec_state["stale"])
        del arena

        # every peer of a tp group holds the same synced arena: peer 0's,
        # one (B, E) arena a tp rank
        g = grid.by_group(synced)[:, 0]
        if over_ranks:
            g = _replicated_from_tp0(g, plan, leaf_tp, grid)
        if tc.guard:
            gscale, skipped = guard_scale(
                loss_frac, skip_threshold=sync_cfg.skip_threshold)
        else:
            gscale = torch.ones((), device=device)
            skipped = torch.zeros((), dtype=torch.bool, device=device)
        gscale = gscale.to(device)
        gnorm = gscale * packed_global_norm(g, plan, p_specs, grid)
        clip = torch.clamp(tc.optimizer.grad_clip
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
        # each tp rank's synced slice into its chunk of the global
        # gradient; the replicated leaves read tp rank 0's
        grads = tree_unflatten(params, [
            from_rows(x, d) for x, d in zip(
                tree_leaves(plan.unpack(g * (gscale * clip))), leaf_tp)])
        return grads, losses, loss_frac, gnorm, skipped, new_rec

    def fsdp_grads(params, batch, b_local, mb, n_micro, ctx, site_draws):
        leaves = tree_leaves(params)
        small = [p for p, m in zip(leaves, fsdp_mask) if not m]
        small_tp = [d for d, m in zip(leaf_tp, fsdp_mask) if not m]
        for p in small:
            p.requires_grad_(True)
        owners = {p.untyped_storage().data_ptr(): j
                  for j, (p, m) in enumerate(zip(leaves, fsdp_mask)) if m}
        gather = make_fsdp_gather(sync_cfg, fsdp_axes, data_axis, grid,
                                  site_tp)
        step_pctx = dataclasses.replace(pctx, gather=gather.gather)
        acc = small_acc = None
        rows = len(local_peers)
        loss_p = torch.zeros(rows, device=device)
        for i in range(n_micro):
            # this micro-batch's gradient: the sharded leaves' reduced sums
            # (param dtype, as the gather's VJP casts) and each peer's
            # replicated leaves
            grad = [torch.zeros_like(p) if m else None
                    for p, m in zip(leaves, fsdp_mask)]
            bufs = {ptr: (leaves[j], grad[j]) for ptr, j in owners.items()}
            small_g = [torch.empty((grid.tp_rows * rows,
                                    *local_rows(p, d).shape[1:]),
                                   dtype=p.dtype, device=device)
                       for p, d in zip(small, small_tp)]
            for row, peer in enumerate(local_peers):
                lo = peer * b_local + i * mb
                mbatch = _local(batch, slice(lo, lo + mb), device)
                loss = lm_loss(params, mbatch, cfg, seq_chunk=tc.seq_chunk,
                               remat=tc.remat, pctx=step_pctx)
                for stack, g, d in zip(small_g, gather.backward(
                        loss, row, rows, small), small_tp):
                    grid.by_group(stack)[:, row] = local_rows(g, d)
                loss_p[row] += loss.detach()
            # the deferred VJP over all peers; sites sharing a leaf add
            for w, g in gather.reduce(site_draws):
                _grad_view(w, bufs).add_(g)
            if n_micro == 1:
                acc, small_acc = grad, small_g
            elif acc is None:
                acc = [None if a is None else a.to(tc.accum_dtype)
                       for a in grad]
                small_acc = [a.to(tc.accum_dtype) for a in small_g]
            else:
                for a, b in zip(acc, grad):
                    if a is not None:
                        a += b.to(a.dtype)
                for a, b in zip(small_acc, small_g):
                    a += b.to(a.dtype)
        if n_micro > 1:
            acc = [None if a is None else a / n_micro for a in acc]
            small_acc = [a / n_micro for a in small_acc]
        losses = list(loss_p / n_micro)
        if small:
            synced = sync_pytree(small_acc, ctx, bucket_elems=tc.bucket_elems,
                                 mode=tc.sync_mode, spec=spec)
            # each tp group's peer 0, put back together over tp (over tp
            # ranks, the leaves replicated over tp tp rank 0's)
            small_out = [from_rows(grid.by_group(x)[:, 0], d)
                         for x, d in zip(synced, small_tp)]
            if over_ranks:
                on_tp0 = [i for i, d in enumerate(small_tp) if d is None]
                for i, x in zip(on_tp0, _tp0_values(
                        [small_out[i] for i in on_tp0], grid)):
                    small_out[i] = x
            it = iter(small_out)
            acc = [next(it) if a is None else a for a in acc]
        grads = tree_unflatten(params, acc)
        loss_frac = ctx.loss_fraction().to(device)
        if tc.guard:
            grads, skipped = guard_update(
                grads, loss_frac, skip_threshold=sync_cfg.skip_threshold)
        else:
            skipped = torch.zeros((), dtype=torch.bool, device=device)
        gnorm = sharded_global_norm(grads, p_specs, shape, grid,
                                    {pod_axis: collectives.POD}
                                    if pod_axis else None)
        clip = torch.clamp(tc.optimizer.grad_clip
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g_: g_ * clip.to(g_.dtype), grads)
        return grads, losses, loss_frac, gnorm, skipped

    def step_fn(params, opt_state, batch, step: int, key: Key,
                draws: Draws | None = None, rec_state: dict | None = None,
                site_draws: Draws | None = None):
        if rec_policy.any != (rec_state is not None):
            raise ValueError(
                f"recovery={tc.sync.recovery!r} "
                + ("needs rec_state= (recovery.init_state)" if rec_policy.any
                   else "takes no rec_state"))
        skey = fold_in(key, step)
        b_local, mb, n_micro = split(batch)
        ctx = SyncContext(cfg=sync_cfg, draws=draws or ThreefryDraws(
            key=fold_in(skey, 7), cfg=sync_cfg, device=device), grid=grid)
        new_rec = None
        if fsdp:
            grads, losses, loss_frac, gnorm, skipped = fsdp_grads(
                params, batch, b_local, mb, n_micro, ctx,
                site_draws or ThreefryDraws(key=skey, cfg=sync_cfg,
                                             device=device))
        else:
            grads, losses, loss_frac, gnorm, skipped, new_rec = \
                replicated_grads(params, batch, b_local, mb, n_micro, ctx,
                                 rec_state)
        params, opt_state = opt.update(grads, opt_state, params,
                                       tc.optimizer.lr, step)
        metrics = {
            "loss": collectives.gather_peers(torch.stack(losses), grid,
                                             collectives.BOTH).mean(),
            "grad_norm": gnorm,
            "loss_frac": loss_frac,
            "skipped": skipped.to(torch.float32),
        }
        if new_rec is None:
            return params, opt_state, metrics
        metrics["filled"] = torch.as_tensor(ctx.stats.get("filled", 0.0),
                                            device=device)
        return params, opt_state, new_rec, metrics

    return step_fn, opt
