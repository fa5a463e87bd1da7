"""The peer grid: the port's counterpart of the ``jax.lax`` axis primitives
the sync path uses.

The reference runs its ranks as ``shard_map`` over a mesh whose data axis
has N devices, or over a ``(pod, data)`` mesh of G x N devices for the
hierarchical 2D TAR (§3.1.2). On one card the port runs them as a leading
peer axis of size P = G * N on stacked tensors, pod-major: row ``p = g * N
+ i`` of every stacked tensor is what rank (pod g, data i) holds, the order
of ``P(('pod', 'data'))``. ``pods`` (G, 1 when there is no pod axis) is
passed to every collective, and ``axis`` names the one it acts over:

  ``DATA``  within each pod, over its N data peers (the ring, tree and TAR
            schedules; ``ppermute`` pairs and per-peer rows are data
            indices, applied in every pod at once);
  ``POD``   across the G pods, at a fixed data index (the outer reduce);
  ``BOTH``  over all P peers (the psum topology, the quantizer's grids).

Each collective is a reindexing of the peer axis over all P peers at once,
so one kernel launch still covers every peer of a bucket in every pod. With
G = 1 the results are views where one exists (no copy: the kernels read the
strided views directly); over pods the transposes are copies.
``ppermute`` is one gather (or, when it names only some destinations, one
``index_copy_`` into zeros) over all P peers, and the module counter
``permutes`` counts its calls, as the reference's tests count
``collective_permute`` sites in its HLO.

A ``torch.distributed`` (NCCL) backend behind this interface, one rank per
card, is the next multi-GPU slice (ROADMAP).
"""
from __future__ import annotations

import functools

import torch

DATA = "data"
POD = "pod"
BOTH = (POD, DATA)

permutes = 0


@functools.lru_cache(maxsize=512)
def index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor on ``device``, made once: the schedules'
    per-peer indices (``vpos[p]``, ``(k + r) % n``, ...) never change, and
    making them anew would copy from the host at every round."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def per_peer(values: tuple[int, ...], device: torch.device,
             pods: int = 1) -> torch.Tensor:
    """``(P,)`` index tensor of a per-data-index table ``values`` (length
    N): peer ``g * N + i`` reads ``values[i]`` in every pod."""
    return index(tuple(values) * pods, device)


def _check_axis(axis) -> None:
    if axis not in (DATA, POD, BOTH):
        raise ValueError(f"unknown peer axis {axis!r}; one of "
                         f"{DATA!r}, {POD!r}, {BOTH!r}")


def axis_size(x: torch.Tensor, pods: int = 1, axis=DATA) -> int:
    """The size of ``axis`` on the grid of ``x``'s P peers: N, G or P."""
    _check_axis(axis)
    p = x.shape[0]
    if p % pods:
        raise ValueError(f"{p} peers do not fill {pods} pods")
    return {DATA: p // pods, POD: pods, BOTH: p}[axis]


def axis_index(x: torch.Tensor, pods: int = 1, axis=DATA) -> torch.Tensor:
    """Each peer's own index on ``axis``, ``(P,)``."""
    n = axis_size(x, pods)
    peers = torch.arange(x.shape[0], device=x.device)
    return {DATA: peers % n, POD: peers // n, BOTH: peers}[axis]


def on_grid(rows: torch.Tensor, x: torch.Tensor, pods: int = 1,
            axis=DATA) -> torch.Tensor:
    """Lay per-axis-index rows ``(n, ...)`` onto ``x``'s P peers: peer p
    takes the row of its index on ``axis`` (every pod the same rows over
    the data axis). ``rows`` itself when the axis spans every peer."""
    if rows.shape[0] == x.shape[0]:
        return rows
    return rows.index_select(0, axis_index(x, pods, axis))


def all_to_all(x: torch.Tensor, pods: int = 1, axis=DATA) -> torch.Tensor:
    """Tiled all_to_all over ``axis``: ``(P, n, S)`` sender-major (row p =
    what peer p sends to each of the axis's n peers) -> receiver-major
    ``(P, n, S)`` (row q = the shards peer q received, one per sender, in
    the senders' axis order)."""
    n = axis_size(x, pods, axis)
    if x.shape[1] != n:
        raise ValueError(f"all_to_all over {n} peers needs {n} shards each, "
                         f"got {x.shape[1]}")
    if axis == BOTH or (axis == DATA and pods == 1):
        return x.transpose(0, 1)
    if axis == POD and pods == 1:
        return x
    g, m, s = pods, x.shape[0] // pods, x.shape[2]
    if axis == DATA:                  # (g, i, j) -> (g, j, i)
        y = x.reshape(g, m, m, s).transpose(1, 2)
    else:                             # (h, i, g) -> (g, i, h)
        y = x.reshape(g, m, g, s).permute(2, 1, 0, 3)
    return y.reshape(x.shape)


def all_gather(own: torch.Tensor, pods: int = 1, axis=DATA) -> torch.Tensor:
    """Tiled all_gather over ``axis``: ``(P, S)`` -> ``(P, n*S)``, every
    peer holding the concatenation of its axis peers' shards in axis order
    (a broadcast view when the axis spans every peer)."""
    p = own.shape[0]
    n = axis_size(own, pods, axis)
    if axis == BOTH or (axis == DATA and pods == 1):
        return own.reshape(1, -1).expand(p, -1)
    if axis == POD and pods == 1:
        return own
    m = p // pods
    if axis == DATA:                  # pod g's N shards, for each of its N
        rows = own.reshape(pods, 1, m * own.shape[-1])
        return rows.expand(pods, m, -1).reshape(p, n * own.shape[-1])
    # the G shards at data index i, for each pod
    rows = own.reshape(pods, m, -1).transpose(0, 1).reshape(1, m, -1)
    return rows.expand(pods, m, -1).reshape(p, n * own.shape[-1])


def mean_of(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` rounded as the reference's XLA rounds a division by a
    constant: a multiply by the fp32 reciprocal (equal to the division when
    n is a power of two, within an ulp of it otherwise)."""
    return total * (1.0 / n)


def _grouped(x: torch.Tensor, pods: int, axis) -> tuple[torch.Tensor, int]:
    """``x`` as ``(G, N, ...)`` and the dim of ``axis`` in it."""
    m = x.shape[0] // pods
    return x.reshape(pods, m, *x.shape[1:]), (1 if axis == DATA else 0)


def pmean(x: torch.Tensor, pods: int = 1, axis=DATA) -> torch.Tensor:
    """Mean over ``axis``, held by every peer on it: ``(P, ...)`` ->
    ``(P, ...)``."""
    n = axis_size(x, pods, axis)
    if n == x.shape[0]:
        return mean_of(x.sum(dim=0, keepdim=True), n).expand_as(x)
    xs, d = _grouped(x, pods, axis)
    return mean_of(xs.sum(dim=d, keepdim=True), n).expand_as(xs) \
        .reshape(x.shape)


def pmax(x: torch.Tensor, pods: int = 1, axis=DATA) -> torch.Tensor:
    n = axis_size(x, pods, axis)
    if n == x.shape[0]:
        return x.amax(dim=0, keepdim=True).expand_as(x)
    xs, d = _grouped(x, pods, axis)
    return xs.amax(dim=d, keepdim=True).expand_as(xs).reshape(x.shape)


def take_rows(x: torch.Tensor, rows: tuple[int, ...],
              pods: int = 1) -> torch.Tensor:
    """Row ``rows[i]`` of each peer's ``(P, R, ...)`` stack, ``(P, ...)``,
    ``i`` the peer's data index: the reference's ``jnp.take(x, i)`` with a
    per-device index, for all peers in one indexed read."""
    peers = index(tuple(range(x.shape[0])), x.device)
    return x[peers, per_peer(rows, x.device, pods)]


def put_rows(x: torch.Tensor, rows: tuple[int, ...], value: torch.Tensor,
             pods: int = 1) -> None:
    """``x[p, rows[i]] = value[p]`` for every peer, in one indexed write."""
    peers = index(tuple(range(x.shape[0])), x.device)
    x[peers, per_peer(rows, x.device, pods)] = value


def ppermute(x: torch.Tensor, perm, pods: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` over the data axis: ``out[dst] = x[src]`` for
    each ``(src, dst)`` pair of data indices, in every pod; a destination no
    pair names receives zeros (the reference's relays and grafts add such
    results)."""
    global permutes
    n = axis_size(x, pods)
    pairs = [(int(s), int(d)) for s, d in perm]
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in pairs}) != len(pairs):
        raise ValueError(f"ppermute pairs {pairs} repeat a source or "
                         "destination")
    if any(not (0 <= i < n) for pair in pairs for i in pair):
        raise ValueError(f"ppermute pairs {pairs} outside the {n}-peer axis")
    permutes += 1
    lifted = [(g * n + s, g * n + d) for g in range(pods) for s, d in pairs]
    if len(pairs) == n:                     # every peer receives: one gather
        src_of = [0] * x.shape[0]
        for s, d in lifted:
            src_of[d] = s
        return x.index_select(0, index(tuple(src_of), x.device))
    out = torch.zeros_like(x)
    if pairs:
        srcs = index(tuple(s for s, _ in lifted), x.device)
        out.index_copy_(0, index(tuple(d for _, d in lifted), x.device),
                        x.index_select(0, srcs))
    return out
