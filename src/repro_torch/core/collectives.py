"""The peer axis: the port's counterpart of the ``jax.lax`` axis primitives
the sync path uses.

The reference runs its N data ranks as ``shard_map`` over N devices. On one
card the port runs them as a leading peer axis of size P on stacked
tensors: row p of every stacked tensor is what rank p holds. Each
collective is then a reindexing of that axis, returned as a view where one
exists (no copy): the kernels read the strided views directly.
``ppermute`` is the exception: a permutation of the peer axis is one gather
(or, when it names only some destinations, one ``index_copy_`` into zeros)
over all P peers, and the module counter ``permutes`` counts its calls, as
the reference's tests count ``collective_permute`` sites in its HLO.

A ``torch.distributed`` (NCCL) backend behind this interface, one rank per
card, is the next multi-GPU slice (ROADMAP).
"""
from __future__ import annotations

import functools

import torch

permutes = 0


@functools.lru_cache(maxsize=512)
def index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor on ``device``, made once: the schedules'
    per-peer indices (``vpos[p]``, ``(k + r) % n``, ...) never change, and
    making them anew would copy from the host at every round."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def axis_size(x: torch.Tensor) -> int:
    return x.shape[0]


def axis_index(x: torch.Tensor) -> torch.Tensor:
    """Each peer's own index, ``(P,)``."""
    return torch.arange(x.shape[0], device=x.device)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Tiled all_to_all: ``(P, N, S)`` sender-major (row p = what peer p
    sends to each of N peers) -> receiver-major ``(N, P, S)`` (row j = the
    shards peer j received, one per sender)."""
    if x.shape[0] != x.shape[1]:
        raise ValueError(f"all_to_all over {x.shape[0]} peers needs "
                         f"{x.shape[0]} shards each, got {x.shape[1]}")
    return x.transpose(0, 1)


def all_gather(own: torch.Tensor) -> torch.Tensor:
    """Tiled all_gather: ``(P, S)`` -> ``(P, P*S)``, every peer holding the
    concatenation of all peers' shards (a broadcast view)."""
    p = own.shape[0]
    return own.reshape(1, -1).expand(p, -1)


def mean_of(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` rounded as the reference's XLA rounds a division by a
    constant: a multiply by the fp32 reciprocal (equal to the division when
    n is a power of two, within an ulp of it otherwise)."""
    return total * (1.0 / n)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over peers, held by every peer: ``(P, ...)`` -> ``(P, ...)``."""
    return mean_of(x.sum(dim=0, keepdim=True), x.shape[0]).expand_as(x)


def pmax(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=0, keepdim=True).expand_as(x)


def take_rows(x: torch.Tensor, rows: tuple[int, ...]) -> torch.Tensor:
    """Row ``rows[p]`` of each peer p's ``(P, R, ...)`` stack, ``(P, ...)``:
    the reference's ``jnp.take(x, i)`` with a per-device index, for all
    peers in one indexed read."""
    peers = index(tuple(range(x.shape[0])), x.device)
    return x[peers, index(tuple(rows), x.device)]


def put_rows(x: torch.Tensor, rows: tuple[int, ...],
             value: torch.Tensor) -> None:
    """``x[p, rows[p]] = value[p]`` for every peer, in one indexed write."""
    peers = index(tuple(range(x.shape[0])), x.device)
    x[peers, index(tuple(rows), x.device)] = value


def ppermute(x: torch.Tensor, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` on the peer axis: ``out[dst] = x[src]`` for each
    ``(src, dst)`` pair of ``perm``; a destination no pair names receives
    zeros (the reference's relays and grafts add such results)."""
    global permutes
    p = x.shape[0]
    pairs = [(int(s), int(d)) for s, d in perm]
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in pairs}) != len(pairs):
        raise ValueError(f"ppermute pairs {pairs} repeat a source or "
                         "destination")
    if any(not (0 <= i < p) for pair in pairs for i in pair):
        raise ValueError(f"ppermute pairs {pairs} outside the {p}-peer axis")
    permutes += 1
    if len(pairs) == p:                     # every peer receives: one gather
        src_of = [0] * p
        for s, d in pairs:
            src_of[d] = s
        return x.index_select(0, index(tuple(src_of), x.device))
    out = torch.zeros_like(x)
    if pairs:
        srcs = index(tuple(s for s, _ in pairs), x.device)
        out.index_copy_(0, index(tuple(dsts), x.device),
                        x.index_select(0, srcs))
    return out
