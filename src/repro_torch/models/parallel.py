"""Parallelism context of the model code.

Counterpart of ``src/repro/models/parallel.py``. The reference's model code
runs inside a ``shard_map`` body and ``ParallelCtx`` carries the mesh axis
names; here the P data-parallel peers are the leading axis of stacked
tensors on one card (pod-major over ``(pod, data)``, as
``core/collectives.py`` lays them out), so a per-device value of the
reference becomes a ``(P, ...)`` stack and each collective reindexes it.

``gather`` is the FSDP weight gather the trainer installs: ``(w, dim,
path, name) -> w_full``, whose gradient the trainer reduces with
OptiReduce's reduce-scatter under the draws of the site's key path below
the step key (``()`` or ``(l,)``). On one card a parameter is stored whole,
so the gather hands back the full weight; over a process group (one rank
a peer) it is the rank's shard, and the gather builds the full weight from
every rank's; ``name`` tells apart two call sites that share a path (the
embedding lookup and the tied head).

Tensor parallelism (``tp_axis``, T = ``sizes[tp_axis]`` ranks). The model
code runs one data peer at a time and keeps **one** activation for the
whole tp group, the value every tp rank of the reference holds between its
sublayers (replicated over tp). Where the tp ranks differ, the value is a
``(T, ...)`` stack over the tp dim, rank order: the row-parallel partial
products, the vocab-sharded logits' statistics. ``psum_tp`` and
``pmax_tp`` reduce such a stack to the one value every rank holds:
``psum_tp`` adds the T rows in rank order in the stack's dtype, so its
autograd is the correct one (the gradient of a sum is a broadcast), and a
replicated activation that feeds a column-parallel product gets the sum of
every shard's contribution in the backward pass (Megatron's "f") by
construction, from the one activation. ``tp_index`` is the ``(T,)`` rank
index of the stack.

Over ranks (``tp_grid``: a ``core.collectives.Grid`` of process-group
ranks with a model axis, one tp rank a process, the reference's
``shard_map`` body one rank a device) a rank holds only its own shard of
every tp-sharded weight, and a value that differs across the tp ranks is
this rank's ``(1, ...)`` row of the stack (``tp_rows`` is 1, ``tp_index``
the rank's own ``(1,)`` index). ``psum_tp`` gathers the tp group's rows
and adds them in rank order in their dtype; its backward is the identity
(Megatron's "g"). ``copy_tp`` is its mate ("f"): the identity forward, the
same ordered sum over the tp group backward; it goes on the replicated
activation at the input of every column-parallel product, and on a
weight replicated over tp whose gradient each rank takes only a part of
(the K / V projections under ``kv_replicated``). ``pmax_tp`` gathers the
rows' max, without a gradient (every caller detaches it, as the stacked
form does). On one card (``tp_grid`` None) every method keeps its stacked
behaviour.

Sequence parallelism (``sp``, Megatron-SP): the residual stream between
sublayers is sharded over tp along the sequence, a ``(T, B, S/T, D)`` stack
of the ranks' slices. ``gather_seq`` puts the slices back together at a
sublayer's input, and ``reduce_output`` sums the row-parallel partials and
scatters the sum over the sequence (the reference's ``psum_scatter``).
Over ranks a rank's residual stream is its own ``(1, B, S/T, D)`` slice:
``gather_seq`` is an all-gather in the tp group (gloo's list form) whose
backward is the reduce-scatter (the rank's slice of the tp group's
rank-order sum of the full-sequence gradients); ``scatter_seq`` takes the
rank's slice, its backward the all-gather of the slices' gradients (so
what precedes it, the embedding and the frontend's projection, gets the
whole gradient on every rank); ``reduce_output`` is that reduce-scatter
forward (the rank's slice of ``psum_tp``'s rank-order sum, the same bits)
and the all-gather backward. The gather's backward already sums the
sublayer input's gradient over the tp group, so it is the "f" there:
``copy_act`` is the identity under SP (``copy_tp`` otherwise), and
``copy_seq`` sums the gradient of a replicated weight that acts on the
rank's slice alone (the norms) over the tp group.

Serving (``serve/engine.py``) runs the data peers as views of one global
batch or of one global KV cache's sequence: ``psum_dp``, ``pmax_dp`` and
``gather_dp_tiled`` reduce or concatenate a ``(P, ...)`` stack of the
peers' values, for the sequence-sharded softmax merge and the
weights-stationary MoE (``moe_stationary``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import collectives


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    tp_axis: str | None = None      # 'model'
    dp_axis: str | None = None      # 'data'  (fsdp gathers + grad sync)
    pod_axis: str | None = None     # 'pod', or 'model' under pure_dp
    fsdp: bool = False              # weights sharded over the dp axes
    gather: Callable | None = None  # (w, dim, path, name) -> w_full
    sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    sp: bool = False                # sequence parallelism over tp
    # serving: MoE expert weights stay sharded over the dp axes and the
    # expert activations are psum'd instead (``models/moe.py``)
    moe_stationary: bool = False
    # the tp ranks are processes: a Grid whose model axis holds them
    tp_grid: Any = None

    def tp_size(self) -> int:
        return self.sizes.get(self.tp_axis, 1) if self.tp_axis else 1

    def over_ranks(self) -> bool:
        """Whether the tp ranks are processes, this one holding its own
        shards (``tp_grid`` and T > 1)."""
        return self.tp_grid is not None and self.tp_size() > 1

    def tp_rows(self) -> int:
        """The rows of a value that differs across the tp ranks: T on one
        card, this rank's one over ranks."""
        return 1 if self.over_ranks() else self.tp_size()

    def tp_index(self, device=None) -> torch.Tensor:
        """The tp ranks of a ``(T, ...)`` stack, ``(T,)``; over ranks this
        rank's own, ``(1,)``."""
        if self.over_ranks():
            return torch.tensor([self.tp_grid.index_on(collectives.MODEL)],
                                device=device)
        return torch.arange(self.tp_size(), device=device)

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a ``(T, ...)`` stack over the tp ranks, in rank order and
        in its dtype (each add rounded, as a psum of that dtype rounds):
        the one value every rank holds. Over ranks ``x`` is this rank's
        ``(1, ...)`` row, summed over the tp group (backward: the
        identity)."""
        if not self.tp_axis:
            return x
        if self.over_ranks():
            return _SumOverTp.apply(x, self.tp_grid)
        out = x[0]
        for t in range(1, x.shape[0]):
            out = out + x[t]
        return out

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Max of a ``(T, ...)`` stack over the tp ranks (over ranks of
        this rank's ``(1, ...)`` row over the tp group, no gradient)."""
        if not self.tp_axis:
            return x
        if self.over_ranks():
            return collectives.pmax(x.detach(), self.tp_grid,
                                    collectives.MODEL)[0]
        return x.amax(dim=0)

    def copy_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "f": ``x`` itself, whose gradient over ranks is summed
        over the tp group in rank order (on one card the autograd of the
        one activation sums it already)."""
        if not self.over_ranks():
            return x
        return _CopyToTp.apply(x, self.tp_grid)

    def copy_act(self, x: torch.Tensor) -> torch.Tensor:
        """The "f" on the replicated activation at a column-parallel input:
        ``copy_tp``, but the identity under SP, where the sequence gather
        before it sums the input gradient over the tp group already (a
        second sum would count each rank's part T times)."""
        return x if self.seq_sharded() else self.copy_tp(x)

    def copy_seq(self, w: torch.Tensor) -> torch.Tensor:
        """A weight replicated over tp that acts on the residual stream
        (the norms): under SP over ranks a rank applies it to its sequence
        slice alone, so its gradient is summed over the tp group
        (``copy_tp``); ``w`` itself otherwise."""
        return self.copy_tp(w) if self.seq_sharded() else w

    def seq_sharded(self) -> bool:
        """Whether the residual stream runs as sequence slices (SP over
        more than one tp rank)."""
        return self.sp and self.tp_size() > 1

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``(T, B, S/T, D)`` -> ``(B, S, D)`` at a sublayer's input (SP;
        over ranks this rank's ``(1, B, S/T, D)`` slice, gathered over the
        tp group); the identity otherwise."""
        if not self.seq_sharded():
            return x
        if self.over_ranks():
            return _GatherSeq.apply(x, self.tp_grid)
        return torch.cat(x.unbind(0), dim=1)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, S, D)`` -> the ranks' sequence slices ``(T, B, S/T, D)``
        (SP; over ranks this rank's ``(1, B, S/T, D)``); the identity
        otherwise."""
        if not self.seq_sharded():
            return x
        if self.over_ranks():
            return _ScatterSeq.apply(x, self.tp_grid)
        return torch.stack(x.chunk(self.tp_size(), dim=1))

    def reduce_output(self, parts: torch.Tensor) -> torch.Tensor:
        """Row-parallel output reduction of the ``(T, B, S, D)`` partial
        products: ``psum_tp``, then under SP each rank's sequence slice of
        the sum (the reference's ``psum_scatter``; over ranks a
        reduce-scatter in the tp group, adding in rank order)."""
        if self.seq_sharded() and self.over_ranks():
            return _ReduceScatterSeq.apply(parts, self.tp_grid)
        return self.scatter_seq(self.psum_tp(parts))

    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in (self.pod_axis, self.dp_axis) if a)

    def dp_size(self) -> int:
        return math.prod(self.sizes.get(a, 1) for a in self.dp_axes())

    def dp_shard_index(self, device=None) -> torch.Tensor:
        """Each peer's linear index over (pod, data), ``(P,)``: the peer
        axis itself, the order of ``P(('pod', 'data'))``."""
        return torch.arange(self.dp_size(), device=device)

    def psum_dp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a ``(P, ...)`` stack over the dp axes, held by every peer:
        the reference's ``psum`` on host devices, which adds the peers in
        rank order in fp32 and rounds the sum once to the stack's dtype
        (bf16 included)."""
        if not self.dp_axes():
            return x
        acc = x[0].to(torch.float32)
        for i in range(1, x.shape[0]):
            acc = acc + x[i].to(torch.float32)
        return acc.to(x.dtype)[None].expand_as(x)

    def pmax_dp(self, x: torch.Tensor) -> torch.Tensor:
        """Max of a ``(P, ...)`` stack over the dp axes, held by every
        peer."""
        if not self.dp_axes():
            return x
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def gather_dp_tiled(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The reference's tiled ``all_gather`` over every dp axis: ``(P,
        *slice)`` -> ``(P, *full)``, the P slices concatenated along
        ``axis`` of the unstacked tensor in peer order, held by every
        peer."""
        if not self.dp_axes():
            return x
        full = torch.cat(x.unbind(0), dim=axis)
        return full[None].expand(x.shape[0], *full.shape)

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


class _SumOverTp(torch.autograd.Function):
    """Megatron's "g" over the tp group: this rank's ``(1, ...)`` row ->
    the rows' ordered sum; the gradient passes through unchanged, since
    every rank computes the same one downstream."""

    @staticmethod
    def forward(ctx, x, grid):
        return collectives.psum(x, grid, collectives.MODEL)[0]

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0), None


class _CopyToTp(torch.autograd.Function):
    """Megatron's "f" over the tp group: the identity, whose gradient is
    the ordered sum of every tp rank's."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.psum(g.unsqueeze(0), ctx.grid,
                                collectives.MODEL)[0], None


def _gather_seq(x: torch.Tensor, grid) -> torch.Tensor:
    """This rank's ``(1, B, S/T, D)`` slice -> ``(B, S, D)``: the tp
    group's slices in rank order along the sequence."""
    rows = collectives.gather_peers(x, grid, collectives.MODEL)
    return torch.cat(rows.unbind(0), dim=1)


def _reduce_scatter_seq(x: torch.Tensor, grid) -> torch.Tensor:
    """``(B, S, D)`` on every tp rank -> ``(1, B, S/T, D)``: this rank's
    slice of the tp group's sum, added in rank order in ``x``'s dtype (one
    ``all_to_all`` of the T slices, then the ordered sum: the slice of
    ``psum_tp``'s sum, bit for bit)."""
    t = grid.tp
    b, s, d = x.shape
    sent = x.unflatten(1, (t, s // t)).movedim(1, 0).reshape(1, t, -1)
    got = collectives.all_to_all(sent, grid, collectives.MODEL)
    rows = got.view(t, b, s // t, d)
    return collectives._sum_in_order(rows, 0)


class _GatherSeq(torch.autograd.Function):
    """SP's gather over the tp group: the all-gather forward, the
    reduce-scatter backward (the "f" of the sublayer it feeds)."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return _gather_seq(x, grid)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.grid), None


class _ReduceScatterSeq(torch.autograd.Function):
    """SP's ``reduce_output`` over the tp group: this rank's ``(1, B, S,
    D)`` partial -> its ``(1, B, S/T, D)`` slice of the ordered sum; the
    backward gathers the slices' gradients, every rank's partial feeding
    the whole sequence."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return _reduce_scatter_seq(x[0], grid)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.grid).unsqueeze(0), None


class _ScatterSeq(torch.autograd.Function):
    """SP's entry over the tp group: ``(B, S, D)``, the same on every tp
    rank -> this rank's ``(1, B, S/T, D)`` slice; the backward gathers the
    slices' gradients, so the whole gradient reaches what came before."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        t = grid.index_on(collectives.MODEL)
        return x.chunk(grid.tp, dim=1)[t].unsqueeze(0).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.grid), None


# A no-parallelism context for single-peer use and references.
SINGLE = ParallelCtx()
