"""Baseline collectives the paper compares against (§5.1.2) on the peer
axis: Gloo Ring, recursive halving-doubling ("NCCL Tree" stand-in), BCube,
and the plain mean over peers.

Counterpart of ``src/repro/core/ring.py``. Every hop is one
``collectives.ppermute`` over all P peers; the reference's per-device
indices (``k``, ``(k - h) % n``, the BCube digit, the tree's upper-half
test) become ``(P,)`` index tensors, applied with one indexed read or write
a hop. The ring also takes per-hop drop masks, so Ring's loss pathology (a
dropped hop loses the accumulated partial sum, §5.3) is in the dataflow.
Divisions by the peer count round as the reference's XLA rounds them
(``collectives.mean_of``). Where N is not a power of 2 (tree) or of the
base (BCube), both fall back to the plain mean, as the reference does.
On a grid of pods or tp groups (``grid``, a ``collectives.Grid``) every
schedule runs over the data axis of every pod and tp group at once
(``core/collectives.py``).
"""
from __future__ import annotations

import torch

from . import collectives
from .collectives import ONE, Grid, put_rows, take_rows
from .tar import (_ring_perms, peer_lookup, shard_plan, weighted_flat,
                  weighted_rows)


def psum_mean(x: torch.Tensor, grid: Grid = ONE) -> torch.Tensor:
    return collectives.pmean(x, grid)


def ring_allreduce(x: torch.Tensor, *,
                   hop_masks: torch.Tensor | None = None,
                   active: tuple[int, ...] | None = None,
                   weights: tuple[int, ...] | None = None,
                   grid: Grid = ONE) -> torch.Tensor:
    """Bandwidth-optimal ring allreduce (Patarasuk-Yuan): N-1
    reduce-scatter hops, then N-1 all-gather hops over the ring i -> i+1.

    x: ``(P, L)``, L % N == 0. hop_masks: ``(P, 2N-2, S)`` 0/1, what
    survived each hop into each peer (a dropped hop loses the accumulated
    partial sum). With a degraded set ``active`` the ring is the virtual
    ring of active peers **in the order given** (pass a
    ``tar.ring_order``-ed tuple to avoid dead links): A chunks, 2(A-1) hops,
    the mean over A contributions; ejected peers self-loop and their result
    must be replaced with ``tar.graft_inactive``. ``weights`` (positive
    units per virtual position) cut x, pre-padded to a multiple of
    ``sum(weights)``, into ``tar.shard_plan`` slices that ride the ring
    zero-padded to the widest.
    """
    p = collectives.axis_size(x, grid)
    if active is None and weights is not None:
        active = tuple(range(p))
    if active is None:
        ring_n, k = p, tuple(range(p))
        perm = [(j, (j + 1) % p) for j in range(p)]
    else:
        ring_n = len(active)
        k, _ = peer_lookup(active, p)
        perm = _ring_perms(active, p)(1)
    if weights is not None:
        if len(weights) != ring_n:
            raise ValueError(f"weights {weights} do not match ring size "
                             f"{ring_n}")
        plan = shard_plan(x.shape[-1], weights)
        if plan.padded != x.shape[-1]:
            raise ValueError(f"bucket length {x.shape[-1]} not a multiple "
                             f"of sum(weights)={sum(weights)}")
        chunks = weighted_rows(x, plan)
    else:
        plan = None
        chunks = x.reshape(x.shape[0], ring_n, x.shape[-1] // ring_n)

    def at(shift: int) -> tuple[int, ...]:
        return tuple((kp + shift) % ring_n for kp in k)

    acc = chunks.clone()   # acc[p, c]: peer p's running partial sum of c
    # reduce-scatter: after N-1 hops peer k holds the sum of chunk (k+1)%n
    for h in range(ring_n - 1):
        recv = collectives.ppermute(take_rows(acc, at(-h), grid), perm, grid)
        if hop_masks is not None:
            recv = recv * hop_masks[:, h]
        put_rows(acc, at(-h - 1), take_rows(acc, at(-h - 1), grid) + recv,
                 grid)
    own = collectives.mean_of(take_rows(acc, at(1), grid), ring_n)

    # all-gather ring
    out = torch.zeros_like(chunks)
    put_rows(out, at(1), own, grid)
    cur = own
    for h in range(ring_n - 1):
        cur = collectives.ppermute(cur, perm, grid)
        if hop_masks is not None:
            cur = cur * hop_masks[:, ring_n - 1 + h]
        put_rows(out, at(-h), cur, grid)
    if plan is not None:
        return weighted_flat(out, plan)
    return out.reshape(x.shape[0], -1)


def tree_allreduce(x: torch.Tensor, grid: Grid = ONE) -> torch.Tensor:
    """Recursive halving-doubling (the classic log-round tree allreduce,
    standing in for NCCL Tree): log2 N reduce-scatter + log2 N all-gather
    hops. After halving, peer i owns segment i; doubling reassembles them
    in order. ``(P, L)`` -> ``(P, L)``."""
    n = collectives.axis_size(x, grid)
    if n & (n - 1):
        return collectives.pmean(x, grid)
    upper = {}
    for d in (1 << t for t in range(n.bit_length() - 1)):
        # each peer's side of the pair exchanging at distance d
        upper[d] = collectives.per_peer(
            tuple(int(j & d != 0) for j in range(n)), x.device,
            grid).bool()[:, None]
    buf = x
    d = n // 2
    while d >= 1:
        perm = [(j, j ^ d) for j in range(n)]
        half = buf.shape[-1] // 2
        lo, hi = buf[:, :half], buf[:, half:]
        mine = torch.where(upper[d], hi, lo)      # half this peer reduces
        theirs = torch.where(upper[d], lo, hi)    # half its partner owns
        buf = mine + collectives.ppermute(theirs, perm, grid)
        d //= 2
    own = collectives.mean_of(buf, n)             # (P, L/N): segment i
    d = 1
    while d < n:
        recv = collectives.ppermute(own, [(j, j ^ d) for j in range(n)],
                                    grid)
        own = torch.where(upper[d], torch.cat([recv, own], dim=-1),
                          torch.cat([own, recv], dim=-1))
        d *= 2
    return own


def bcube_allreduce(x: torch.Tensor, *, base: int = 4,
                    grid: Grid = ONE) -> torch.Tensor:
    """Gloo-style BCube: k = log_base(N) stages. In each reduce stage the
    ``base`` peers of a group (peers differing in one base-``base`` digit)
    split their buffer into ``base`` parts and exchange, so each reduces
    the part of its digit; the all-gather mirrors the stages in reverse.
    base=2 is recursive halving-doubling. ``(P, L)`` -> ``(P, L)``."""
    n = collectives.axis_size(x, grid)
    k, m = 0, n
    while m > 1:
        if m % base:
            return collectives.pmean(x, grid)     # N not a power of base
        m //= base
        k += 1
    strides = [base ** t for t in range(k)]

    def group_perm(stride: int, o: int) -> list[tuple[int, int]]:
        # every peer j sends to the group member whose digit is digit(j)+o
        out = []
        for j in range(n):
            dj = (j // stride) % base
            out.append((j, j + ((((dj + o) % base) - dj) * stride)))
        return out

    def digits(stride: int, o: int) -> tuple[int, ...]:
        return tuple(((j // stride) + o) % base for j in range(n))

    buf = x
    for stride in strides:                        # reduce-scatter stages
        parts = buf.reshape(x.shape[0], base, -1)
        acc = take_rows(parts, digits(stride, 0), grid)   # my digit's part
        for o in range(1, base):
            send = take_rows(parts, digits(stride, o), grid)
            acc = acc + collectives.ppermute(send, group_perm(stride, o),
                                             grid)
        buf = acc
    own = collectives.mean_of(buf, n)

    for stride in reversed(strides):              # all-gather stages
        ordered = torch.empty((x.shape[0], base, own.shape[-1]),
                              dtype=own.dtype, device=own.device)
        put_rows(ordered, digits(stride, 0), own, grid)
        for o in range(1, base):
            # the chunk of the peer whose digit is mine - o
            put_rows(ordered, digits(stride, -o),
                     collectives.ppermute(own, group_perm(stride, o), grid),
                     grid)
        own = ordered.reshape(x.shape[0], -1)
    return own
