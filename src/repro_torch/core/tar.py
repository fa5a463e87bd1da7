"""Transpose AllReduce (TAR, §3.1) over the peer axis.

Counterpart of ``src/repro/core/tar.py`` up to line 445. Stage mapping
(DESIGN §2): stage 1 (shard exchange) -> ``collectives.all_to_all``;
reduce -> the drop-compensated masked mean (kernel B2 on the card); stage 2
(broadcast) -> ``collectives.all_gather``. Buckets are ``(P, L)`` stacks,
one row per peer. On a grid of pods or tp groups (``grid``, a
``collectives.Grid``) every schedule runs over the data axis in every pod
and tp group at once, and :func:`tar_allreduce` over the pod axis is the
hierarchical 2D form's outer reduce (§3.1.2).

The paper's explicit round schedule (Fig 5b) runs rounds r = 1..N-1 as
``collectives.ppermute`` calls, each over all P peers at once, issued in
groups of ``incast`` (``round_groups`` counts the groups). On one CUDA
stream a group boundary changes no value, so the groups are structure
only, as the reference's ``optimization_barrier`` chain is to its values.
The policies of the degraded, weighted and dead-link schedules (the virtual
ring of active peers, straggler-proportional shard plans, relays around
dead edges) are pure Python, copied from the reference. The reference's
per-device indices (``axis_index``, ``vpos[i]``, ``(k + r) % n``) become
``(P,)`` index tensors over the peer axis.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.masked_sum import masked_mean as _masked_mean_kernel

from . import collectives
from .collectives import ONE, Grid

round_groups = 0


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
    (receiver-major) -> ``(P, S)``. No mask -> the plain mean, its adds in
    sender order (a reduction's order may change with the row width, and
    weighted shards must give uniform ones' bits); with an arrival mask ->
    the compensated mean (one kernel launch for all receivers on the
    card)."""
    if mask is None:
        # jnp.mean's arithmetic: a bf16 stack (the FSDP reduce-scatter's
        # Identity wire) accumulates in fp32 and rounds once
        x = received.to(torch.float32)
        total = x[..., 0, :]
        for i in range(1, x.shape[-2]):
            total = total + x[..., i, :]
        return collectives.mean_of(total, x.shape[-2]).to(received.dtype)
    if received.dtype != torch.float32:
        # the kernel takes fp32; a bf16 wire computes in fp32 and rounds
        # once, as the plain version does
        return _masked_mean_kernel(received.to(torch.float32),
                                   mask).to(received.dtype)
    return _masked_mean_kernel(received, mask)


def tar_reduce_scatter(x: torch.Tensor, *,
                       mask: torch.Tensor | None = None, grid: Grid = ONE,
                       axis=collectives.DATA) -> torch.Tensor:
    """TAR stage 1 + reduce over ``axis`` (n peers): ``(P, L)`` -> each
    peer's aggregated shard ``(P, L / n)``. mask: ``(P, n, S)``, receiver
    r's arrivals in row r (its own row always 1; see drops.make_mask)."""
    n = collectives.axis_size(x, grid, axis)
    s = x.shape[-1] // n
    received = collectives.all_to_all(x.reshape(x.shape[0], n, s), grid,
                                      axis)
    return masked_mean(received, mask)


def tar_allreduce(x: torch.Tensor, *, mask: torch.Tensor | None = None,
                  grid: Grid = ONE, axis=collectives.DATA) -> torch.Tensor:
    """Full TAR over ``axis``: all_to_all -> compensated reduce ->
    all_gather. ``(P, L)`` -> ``(P, L)``."""
    own = tar_reduce_scatter(x, mask=mask, grid=grid, axis=axis)
    return collectives.all_gather(own, grid, axis)


def relay_via(src: int, dst: int, participants: Sequence[int],
              dead_links) -> int:
    """First participant that can relay src->dst around a dead edge.

    Both relay hops (src->m and m->dst) must themselves be live; raises
    when the dead-link set isolates the pair (the caller must eject one
    endpoint instead of rerouting).
    """
    dead = set(dead_links)
    for m in participants:
        if m in (src, dst):
            continue
        if (src, m) not in dead and (m, dst) not in dead:
            return m
    raise ValueError(f"no live relay for dead link {(src, dst)} "
                     f"among participants {tuple(participants)}")


def _grouped_rounds(n: int, incast: int, send_for_round,
                    perm_for_round=None, dead_links=(),
                    participants=None,
                    grid: Grid = ONE) -> list[torch.Tensor]:
    """Run rounds 1..n-1, ``incast`` of them to a group; returns each
    round's ``(P, ...)`` receive, round r at index r-1.

    In round r peer j sends to peer (j + r) % n and receives from
    (j - r) % n; ``perm_for_round`` overrides the permutation (the degraded
    schedules route over a virtual ring of active peers; ``n`` is then its
    size). A round whose permutation crosses a dead directed edge sends that
    pair through a two-hop relay over a live intermediate instead (two more
    single-pair permutes), and the receiver's row is ``direct + relayed``:
    the direct permute leaves the relayed destination zero, so the sum is
    the payload, as in the reference (which adds, so -0.0 arrives as +0.0).
    """
    global round_groups
    dead = {(int(s), int(d)) for (s, d) in dead_links}
    rows = []
    for first in range(1, n, incast):
        round_groups += 1
        for r in range(first, min(first + incast, n)):
            if perm_for_round is None:
                perm = [(j, (j + r) % n) for j in range(n)]
            else:
                perm = perm_for_round(r)
            dead_pairs = [p for p in perm
                          if p[0] != p[1] and (p[0], p[1]) in dead]
            live = [p for p in perm if p not in dead_pairs]
            send = send_for_round(r)
            recv = collectives.ppermute(send, live, grid)
            for (src, dst) in dead_pairs:
                m = relay_via(src, dst, participants
                              if participants is not None else range(n),
                              dead)
                mid = collectives.ppermute(send, [(src, m)], grid)
                recv = recv + collectives.ppermute(mid, [(m, dst)], grid)
            rows.append(recv)
    return rows


# ----------------------------------------------- degraded participation
def peer_lookup(active: tuple[int, ...],
                n: int) -> tuple[tuple[int, ...], tuple[float, ...]]:
    """Lookup tables for a degraded-participation set: ``(vpos,
    is_active)``, ``vpos[p]`` peer p's position on the virtual ring of
    active peers (0 for ejected peers, only read behind ``is_active``) and
    ``is_active[p]`` 1.0 or 0.0."""
    vpos = [0] * n
    ind = [0.0] * n
    for k, p in enumerate(active):
        vpos[p] = k
        ind[p] = 1.0
    return tuple(vpos), tuple(ind)


def _ring_perms(active: tuple[int, ...], n: int):
    """perm_for_round over the active virtual ring: active peer at position
    j sends to position (j+r) % A; ejected peers self-loop (their sends
    never enter the schedule)."""
    a = len(active)
    ejected = [p for p in range(n) if p not in set(active)]

    def perm_for_round(r: int):
        return ([(active[j], active[(j + r) % a]) for j in range(a)]
                + [(e, e) for e in ejected])
    return perm_for_round


# ------------------------------------------- weighted (non-uniform) shards
class ShardPlan(NamedTuple):
    """Contiguous block-aligned ownership of a padded bucket: virtual-ring
    position k owns ``sizes[k]`` elements from ``offsets[k]``; ``padded`` is
    the bucket length the plan covers and ``s_max`` the widest slice (the
    row width every round moves; narrower slices ride zero-padded)."""
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    padded: int
    s_max: int


def shard_plan(length: int, weights: Sequence[int],
               block: int = 1) -> ShardPlan:
    """Cut a bucket into straggler-proportional contiguous shards.

    ``weights`` are positive integer shard units, one per virtual-ring
    position. ``length`` is padded up to a multiple of ``sum(weights) *
    block`` (what ``pad_for_tar(x, sum(weights), block)`` produces), so
    every slice is ``w_k * unit`` elements with ``unit`` a multiple of
    ``block``: each element has one owner and no codec block straddles two.
    """
    ws = tuple(int(w) for w in weights)
    if not ws or any(w < 1 for w in ws):
        raise ValueError(f"shard weights must be positive integers, got "
                         f"{weights}")
    total = sum(ws)
    padded = length + ((-length) % (total * block))
    unit = padded // total
    sizes = tuple(w * unit for w in ws)
    offsets = tuple(sum(sizes[:k]) for k in range(len(sizes)))
    return ShardPlan(sizes, offsets, padded, max(sizes))


def weighted_rows(x: torch.Tensor, plan: ShardPlan) -> torch.Tensor:
    """``(..., padded)`` -> ``(..., A, s_max)``: row k is the slice owned by
    virtual position k, zero-padded to the common row width."""
    rows = []
    for size, off in zip(plan.sizes, plan.offsets):
        rows.append(F.pad(x[..., off:off + size], (0, plan.s_max - size)))
    return torch.stack(rows, dim=-2)


def weighted_flat(rows: torch.Tensor, plan: ShardPlan) -> torch.Tensor:
    """``(..., A, s_max)`` -> ``(..., padded)``, the inverse of
    :func:`weighted_rows` (zero-pad tails dropped)."""
    return torch.cat([rows[..., k, :size]
                      for k, size in enumerate(plan.sizes)], dim=-1)


def ring_order(active: tuple[int, ...], dead_links) -> tuple[int, ...]:
    """Link-avoiding virtual-ring order.

    A permutation of ``active`` in which no consecutive hop (the wrap
    included) crosses a dead directed edge; ``tuple(active)`` unchanged when
    no dead edge lies on a current hop (the bitwise-parity fast path).
    Raises ValueError when the dead set leaves no Hamiltonian cycle (the
    caller must fall back to ejection).
    """
    act = tuple(active)
    a = len(act)
    if a <= 1:
        return act
    members = set(act)
    dead = {(int(s), int(d)) for (s, d) in dead_links
            if int(s) in members and int(d) in members}
    if not dead:
        return act
    hops = {(act[j], act[(j + 1) % a]) for j in range(a)}
    if not (hops & dead):
        return act
    # depth-first search for a Hamiltonian cycle avoiding the dead edges
    start = act[0]
    order = [start]
    rest = set(act) - {start}

    def extend() -> bool:
        if not rest:
            return (order[-1], start) not in dead
        cur = order[-1]
        for p in sorted(rest):
            if (cur, p) in dead:
                continue
            order.append(p)
            rest.discard(p)
            if extend():
                return True
            order.pop()
            rest.add(p)
        return False

    if not extend():
        raise ValueError(f"no dead-link-avoiding ring order for "
                         f"active={act} dead={sorted(dead)}")
    return tuple(order)


def graft_inactive(full: torch.Tensor, active: tuple[int, ...],
                   grid: Grid = ONE) -> torch.Tensor:
    """Deliver the assembled ``(P, L)`` result to ejected peers.

    A degraded schedule assembles the reduced bucket only on active peers;
    ejected peers keep training, so they must still receive it. ``ceil(E /
    A)`` graft rounds pair each ejected peer with an active sender; the
    rounds are summed (unnamed destinations receive zeros), then a select
    keeps the active peers' own bytes, as in the reference.
    """
    n = collectives.axis_size(full, grid)
    ejected = [p for p in range(n) if p not in set(active)]
    if not ejected:
        return full
    a = len(active)
    _, is_active = peer_lookup(active, n)
    got = torch.zeros_like(full)
    for t in range(0, len(ejected), a):
        pairs = [(active[j], e) for j, e in enumerate(ejected[t:t + a])]
        got = got + collectives.ppermute(full, pairs, grid)
    keep = collectives.per_peer(tuple(int(v) for v in is_active),
                                full.device, grid)
    return torch.where(keep.view(-1, *([1] * (full.dim() - 1))) > 0, full,
                       got)


def _schedule(active: tuple[int, ...] | None, n: int):
    """(ring size, each peer's position on it, perm_for_round,
    participants) of a full or degraded round schedule over n peers."""
    if active is None:
        return n, tuple(range(n)), None, None
    vpos, _ = peer_lookup(active, n)
    return len(active), vpos, _ring_perms(active, n), active


def _by_sender(rows: list[torch.Tensor], own: torch.Tensor,
               k: tuple[int, ...], a: int, grid: Grid = ONE) -> torch.Tensor:
    """Place each round's receive at its sender's row: ``(P, a, ...)``,
    row q of peer p from virtual sender q. Round r reached peer p from
    position (k[p] - r) % a; ``own`` (round 0) is p's own row. Each round is
    one indexed write over all peers (the reference stacks by distance and
    scatters; the copies are the same)."""
    out = torch.empty((own.shape[0], a, *own.shape[1:]), dtype=own.dtype,
                      device=own.device)
    for r, recv in enumerate([own, *rows]):
        collectives.put_rows(out, tuple((kp - r) % a for kp in k), recv,
                             grid)
    return out


def tar_exchange_rounds(shards: torch.Tensor, *, incast: int = 1,
                        active: tuple[int, ...] | None = None,
                        dead_links=(), grid: Grid = ONE) -> torch.Tensor:
    """Stage-1 shard exchange on the explicit round schedule (Fig 5b).

    shards: ``(P, N, S)``, peer p's row j = its contribution to shard j.
    Returns the ``(P, N, S)`` received matrices in sender order (row q of
    peer p = peer q's shard for p), the layout ``collectives.all_to_all``
    gives. With a degraded set ``active`` the schedule runs over the virtual
    ring of active peers: shards has A = len(active) rows, rounds r =
    1..A-1, ejected peers self-loop, and rows are in virtual-sender order
    (an ejected peer's result is garbage, replaced by :func:`graft_inactive`
    after stage 2). Weighted shards are only rows of the matrix
    (:func:`weighted_rows`); ``dead_links`` relays around failed edges.
    """
    n = collectives.axis_size(shards, grid)
    a, k, perm_for_round, participants = _schedule(active, n)
    if shards.shape[1] != a:
        raise ValueError(f"the round schedule over {a} positions needs {a} "
                         f"shards a peer, got {shards.shape[1]}")

    def take(r: int) -> torch.Tensor:
        return collectives.take_rows(shards, tuple((kp + r) % a for kp in k),
                                     grid)

    rows = _grouped_rounds(a, max(1, int(incast)), take, perm_for_round,
                           dead_links, participants, grid)
    return _by_sender(rows, take(0), k, a, grid)


def tar_broadcast_rounds(own: torch.Tensor, *, incast: int = 1,
                         active: tuple[int, ...] | None = None,
                         dead_links=(), plan: ShardPlan | None = None,
                         grid: Grid = ONE) -> torch.Tensor:
    """Stage-2 broadcast of each peer's aggregated ``(P, S)`` shard on the
    mirrored round schedule. Returns the reassembled ``(P, N*S)`` bucket,
    the layout ``collectives.all_gather`` gives; over the virtual ring of
    ``active`` peers ``(P, A*S)`` in virtual-position order (route it to
    ejected peers with :func:`graft_inactive`). With a weighted ``plan``
    each row is zero-padded to ``s_max`` and the reassembly concatenates
    each position's valid slice (:func:`weighted_flat`)."""
    a, k, perm_for_round, participants = _schedule(
        active, collectives.axis_size(own, grid))
    rows = _grouped_rounds(a, max(1, int(incast)), lambda r: own,
                           perm_for_round, dead_links, participants, grid)
    out = _by_sender(rows, own, k, a, grid)
    if plan is not None:
        return weighted_flat(out, plan)
    return out.reshape(own.shape[0], a * own.shape[-1])


def tar_allreduce_rounds(x: torch.Tensor, *, incast: int = 1,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Round-structured TAR (Fig 5b): exchange -> compensated mean ->
    mirrored broadcast, 2 * ceil((N-1)/I) round groups. ``(P, L)`` ->
    ``(P, L)``; mask as in :func:`tar_reduce_scatter`."""
    p = collectives.axis_size(x)
    s = x.shape[-1] // p
    received = tar_exchange_rounds(x.reshape(p, p, s), incast=incast)
    return tar_broadcast_rounds(masked_mean(received, mask), incast=incast)
