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
partial sum per shard, summed over each sharded-axes set). There is no
memory saving on one card. The replicated leaves (the norms) are
bucket-synced as in the reference, and ``loss_frac`` counts only them, as
the reference's does (its gather VJP's stats are thrown away; ROADMAP C).

The pod axis: a mesh with a ``pod`` axis, or ``pure_dp`` on the
``(data, model)`` host mesh, which takes the ``model`` axis as the pod axis
(the second level of the hierarchical 2D TAR). Tensor parallelism is ROADMAP
A15b.

With ``sync.recovery`` armed (DESIGN §8, core/recovery.py; replicated, one
pod) the step also threads the recovery state: the carried error-feedback
residual ``ef`` ``(P, B, E)`` joins each peer's arena before the sync, the
stale cache ``stale`` ``(B, E)`` feeds the fill, and the step returns the
next state (this step's synced arena as the cache, the new residuals).

The loss metric is the mean over peers; ``loss_frac`` the mean over
receivers. The wire transports (ROADMAP A18) wait for a later slice.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.core.pipeline import (Draws, GeneratorDraws, SyncContext,
                                       resolve_spec)
from repro_torch.core.safeguards import guard_scale, guard_update
from repro_torch.kernels import runtime as kernel_runtime
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm_loss, param_specs, param_table
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import _map_table
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
    sync_mode: str = "pipelined"         # 'pipelined' | 'scan'
    guard: bool = True                   # §3.4 skip-update safeguard
    accum_dtype: torch.dtype = torch.float32
    # pure data parallelism on a single-pod mesh: the 'model' axis is a
    # second data level (hierarchical 2D TAR over (model, data))
    pure_dp: bool = False
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


def _shard_sumsq(g: torch.Tensor, spec, sizes) -> torch.Tensor:
    """Sum of squares of a leaf in fp32: a scalar when replicated, else
    ``(k,)``, one partial sum per shard of its sharded dim (k the product
    of the dim's axis sizes, pod-major), as each rank of the reference
    sums its own shard."""
    g = g.to(torch.float32)
    dims = [(d, e) for d, e in enumerate(spec) if e is not None]
    if not dims:
        return torch.sum(g * g)
    if len(dims) > 1:
        raise NotImplementedError("a leaf sharded on two dims needs tensor "
                                  "parallelism: ROADMAP A15b")
    d, entry = dims[0]
    k = math.prod(sizes[a] for a in _spec_axes((entry,)))
    parts = g.unflatten(d, (k, -1)).movedim(d, 0).reshape(k, -1)
    return torch.sum(parts * parts, dim=1)


def sharded_global_norm(grads, specs, sizes) -> torch.Tensor:
    """Global L2 norm of a gradient tree whose leaves are sharded per
    ``specs`` over axes of ``sizes``: each shard's squared sum, summed over
    exactly the axes its leaf is sharded on, leaves grouped by their
    sharded-axes set (one sum a group), so replicated leaves count once."""
    groups = _summed_groups(
        (_spec_axes(s), _shard_sumsq(g, s, sizes))
        for g, s in zip(tree_leaves(grads), _spec_leaves(specs)))
    return torch.sqrt(_psum_group_total(groups))


def _spec_leaves(specs) -> list[tuple]:
    """The specs of a tree in leaf order (a spec is a tuple of entries, not
    a subtree)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def packed_global_norm(batch: torch.Tensor, plan: BucketPlan,
                       specs=None) -> torch.Tensor:
    """:func:`sharded_global_norm` over one peer's packed ``(B,
    bucket_elems)`` arena, over its ``plan.total`` real entries (the
    zero-padded tail excluded). Adjacent leaves of one sharded-axes set
    coalesce into one contiguous run, one sum of squares a run; an
    all-replicated tree (``specs`` None) is one sum over the stream. The
    arena holds full tensors on one card, so a sharded run's sum is already
    its sum over the shards."""
    flat = batch.reshape(-1)
    s_leaves = (_spec_leaves(specs) if specs is not None
                else [()] * len(plan.sizes))
    runs: list[tuple[tuple[str, ...], int, int]] = []
    for off, size, s in zip(plan.offsets, plan.sizes, s_leaves):
        axes = tuple(sorted(_spec_axes(s)))
        if runs and runs[-1][0] == axes and runs[-1][2] == off:
            runs[-1] = (axes, runs[-1][1], off + size)
        else:
            runs.append((axes, off, off + size))
    groups = _summed_groups(
        (axes, torch.sum(torch.square(flat[a:b].to(torch.float32))))
        for axes, a, b in runs)
    return torch.sqrt(_psum_group_total(groups))


def _local(batch: dict, rows: slice, device: torch.device) -> dict:
    return {k: torch.as_tensor(v[rows]).to(device) for k, v in batch.items()}


class FsdpGather:
    """The FSDP weight gather and its deferred VJP, OptiReduce's
    reduce-scatter (the reference's custom-VJP ``gather``).

    ``gather(w, dim, key, name)`` (installed as ``ParallelCtx.gather``)
    hands the forward pass a fresh autograd leaf over the full weight ``w``
    (on one card the peers' shards side by side are the whole tensor), one
    a site, a site being (name, key): the reference's call sites and keys.
    ``backward`` takes one peer's gradients of its sites into each site's
    ``(P, *shape)`` stack; once the last peer of a micro-batch is done,
    ``reduce`` runs each stack's reduce-scatter over all peers, one hop a
    fsdp axis, outer first, under the site's own draws, and yields the view
    ``w`` with the reduced gradient of the full weight (the peers' slices,
    pod-major), in the gradient's dtype."""

    def __init__(self, cfg: OptiReduceConfig, hops, pods: int):
        self.cfg, self.hops, self.pods = cfg, hops, pods
        self.taken: dict = {}     # this forward: site -> (leaf, dim, view)
        self.stacks: dict = {}    # site -> ((P, *shape) stack, dim, view)

    def gather(self, w: torch.Tensor, dim: int, key: Key,
               name: str) -> torch.Tensor:
        site = (name, key)
        if site in self.taken:
            raise RuntimeError(f"gather site {site} taken twice in one "
                               "forward pass")
        leaf = w.detach().requires_grad_(True)
        self.taken[site] = (leaf, dim, w)
        return leaf

    def backward(self, loss: torch.Tensor, peer: int, peers: int,
                 inputs: list) -> tuple:
        """``loss``'s gradients for peer ``peer``: its sites' into their
        stacks; those of ``inputs`` (the replicated leaves) returned."""
        order = list(self.taken)
        grads = torch.autograd.grad(
            loss, [self.taken[site][0] for site in order] + list(inputs))
        for site, g in zip(order, grads):
            if site not in self.stacks:
                _, dim, w = self.taken[site]
                self.stacks[site] = (g.new_empty((peers, *g.shape)), dim, w)
            self.stacks[site][0][peer] = g
        self.taken = {}
        return grads[len(order):]

    def reduce(self, draws: Draws, skey: Key):
        """Yield ``(view, reduced gradient)`` a site and drop the stacks.
        A site's draws are ``draws`` at the key path below ``skey``."""
        stacks, self.stacks = self.stacks, {}
        for (name, key), (stack, dim, w) in stacks.items():
            ctx = SyncContext(cfg=self.cfg, draws=draws,
                              bucket=key[len(skey):], pods=self.pods)
            g = stack
            for axis, hop in self.hops:
                g = hop.reduce_scatter(g, axis, dim, ctx)
            yield w, torch.cat(g.unbind(0), dim=dim).to(stack.dtype)


def make_fsdp_gather(sync_cfg: OptiReduceConfig, fsdp_axes, data_axis: str,
                     pods: int) -> FsdpGather:
    """The gather over ``fsdp_axes`` (outer first) with one reduce-scatter
    spec an axis: drops are modelled only on the data axis, the pod hop is
    the reliable inter-pod aggregation."""
    hops = [(collectives.DATA if ax == data_axis else collectives.POD,
             rs_spec(sync_cfg, with_drops=ax == data_axis))
            for ax in fsdp_axes]
    return FsdpGather(sync_cfg, hops, pods)


def _grad_view(w: torch.Tensor, owners: dict) -> torch.Tensor:
    """The slice of its parameter's gradient buffer that the view ``w`` of
    that parameter covers (a layer's row of a stacked leaf, or the leaf)."""
    param, buf = owners[w.untyped_storage().data_ptr()]
    off = w.storage_offset() - param.storage_offset()
    return buf.as_strided(w.shape, w.stride(), buf.storage_offset() + off)


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None, *,
                     peers: int | None = None,
                     device: torch.device | str) -> tuple[Callable, Any]:
    """Returns ``(step_fn, opt)``; ``step_fn(params, opt_state, batch, step,
    key, draws=None, site_draws=None) -> (params, opt_state, metrics)``
    updates ``params`` and ``opt_state`` in place. ``mesh``
    (``launch.mesh.make_host_mesh``) gives the peer grid, ``peers=N`` the
    one-axis grid of N; ``batch`` is the global batch (numpy or tensors)
    split over the peers, pod-major. ``draws`` overrides the step's default
    :class:`GeneratorDraws` of the bucketed sync (keyed on the step's sync
    key), ``site_draws`` that of the FSDP gather sites (keyed on the step
    key; a site's draws are ``bucket=()`` for the embedding, ``(l,)`` for
    layer l): a test hands in the reference's.

    With ``tc.sync.recovery`` armed the call takes ``rec_state=`` (from
    ``recovery.init_state``) and returns ``(params, opt_state, rec_state,
    metrics)``: a new state, never sharing storage with the old one, and a
    ``filled`` metric, the lost wire entries the stale cache filled."""
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
    else:
        if shape.get("model", 1) > 1:
            raise NotImplementedError(
                "tensor parallelism over the 'model' axis is not ported "
                "yet: ROADMAP A15b (pure_dp takes it as a pod axis)")
        dp_axes = dp_axes_of(mesh)
        data_axis = "data" if "data" in names else None
        pod_axis = "pod" if "pod" in names else None
    pods = shape[pod_axis] if pod_axis else 1
    peers = pods * (shape[data_axis] if data_axis else 1)
    fsdp = tc.dp_mode == "fsdp"
    fsdp_axes = dp_axes if fsdp else None

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
    p_specs = param_specs(cfg, fsdp_axes=fsdp_axes)
    if fsdp:
        fsdp_mask = _fsdp_leaf_mask(cfg, fsdp_axes)
        pctx = ParallelCtx(dp_axis=data_axis, pod_axis=pod_axis, fsdp=True,
                           sizes=shape)

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
        plan = BucketPlan.for_tree(params, tc.bucket_elems)
        arena_dtype = torch.float32 if n_micro == 1 else tc.accum_dtype
        arena = torch.zeros((peers, plan.num_buckets, plan.bucket_elems),
                            dtype=arena_dtype, device=device)
        losses = []
        for peer in range(peers):
            loss_p = torch.zeros((), device=device)
            for i in range(n_micro):
                lo = peer * b_local + i * mb
                mbatch = _local(batch, slice(lo, lo + mb), device)
                loss = lm_loss(params, mbatch, cfg, seq_chunk=tc.seq_chunk,
                               remat=tc.remat)
                grads = torch.autograd.grad(loss, leaves)
                plan.pack_into(arena[peer], tree_unflatten(params, grads),
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

        g = synced[0]          # every peer holds the same synced arena
        if tc.guard:
            gscale, skipped = guard_scale(
                loss_frac, skip_threshold=sync_cfg.skip_threshold)
        else:
            gscale = torch.ones((), device=device)
            skipped = torch.zeros((), dtype=torch.bool, device=device)
        gscale = gscale.to(device)
        gnorm = gscale * packed_global_norm(g, plan, p_specs)
        clip = torch.clamp(tc.optimizer.grad_clip
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = plan.unpack(g * (gscale * clip))
        return grads, losses, loss_frac, gnorm, skipped, new_rec

    def fsdp_grads(params, batch, b_local, mb, n_micro, ctx, skey,
                   site_draws):
        leaves = tree_leaves(params)
        small = [p for p, m in zip(leaves, fsdp_mask) if not m]
        for p in small:
            p.requires_grad_(True)
        owners = {p.untyped_storage().data_ptr(): j
                  for j, (p, m) in enumerate(zip(leaves, fsdp_mask)) if m}
        gather = make_fsdp_gather(sync_cfg, fsdp_axes, data_axis, pods)
        step_pctx = dataclasses.replace(pctx, gather=gather.gather)
        acc = small_acc = None
        loss_p = torch.zeros(peers, device=device)
        for i in range(n_micro):
            # this micro-batch's gradient: the sharded leaves' reduced sums
            # (param dtype, as the gather's VJP casts) and each peer's
            # replicated leaves
            grad = [torch.zeros_like(p) if m else None
                    for p, m in zip(leaves, fsdp_mask)]
            bufs = {ptr: (leaves[j], grad[j]) for ptr, j in owners.items()}
            small_g = [torch.empty((peers, *p.shape), dtype=p.dtype,
                                   device=device) for p in small]
            for peer in range(peers):
                lo = peer * b_local + i * mb
                mbatch = _local(batch, slice(lo, lo + mb), device)
                loss = lm_loss(params, mbatch, cfg, seq_chunk=tc.seq_chunk,
                               remat=tc.remat, pctx=step_pctx, key=skey)
                for stack, g in zip(small_g, gather.backward(loss, peer,
                                                             peers, small)):
                    stack[peer] = g
                loss_p[peer] += loss.detach()
            # the deferred VJP over all peers; sites sharing a leaf add
            for w, g in gather.reduce(site_draws, skey):
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
            it = iter(s[0] for s in synced)
            acc = [next(it) if a is None else a for a in acc]
        grads = tree_unflatten(params, acc)
        loss_frac = ctx.loss_fraction().to(device)
        if tc.guard:
            grads, skipped = guard_update(
                grads, loss_frac, skip_threshold=sync_cfg.skip_threshold)
        else:
            skipped = torch.zeros((), dtype=torch.bool, device=device)
        gnorm = sharded_global_norm(grads, p_specs, shape)
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
        ctx = SyncContext(cfg=sync_cfg, draws=draws or GeneratorDraws(
            key=fold_in(skey, 7), cfg=sync_cfg, device=device), pods=pods)
        new_rec = None
        if fsdp:
            grads, losses, loss_frac, gnorm, skipped = fsdp_grads(
                params, batch, b_local, mb, n_micro, ctx, skey,
                site_draws or GeneratorDraws(key=skey, cfg=sync_cfg,
                                             device=device))
        else:
            grads, losses, loss_frac, gnorm, skipped, new_rec = \
                replicated_grads(params, batch, b_local, mb, n_micro, ctx,
                                 rec_state)
        params, opt_state = opt.update(grads, opt_state, params,
                                       tc.optimizer.lr, step)
        metrics = {
            "loss": torch.stack(losses).mean(),
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
