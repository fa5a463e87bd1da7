"""The peer grid: the port's counterpart of the ``jax.lax`` axis primitives
the sync path uses, in two forms.

**Stacked (the default).** The reference runs its ranks as ``shard_map``
over a mesh whose data axis has N devices, or over a ``(pod, data)`` mesh
of G x N devices for the hierarchical 2D TAR (§3.1.2), with a ``model``
axis of T tensor-parallel ranks beside them. On one card the port runs them
as a leading peer axis of size P = T * G * N on stacked tensors, ordered
``(model, pod, data)``: row ``p = (t * G + g) * N + i`` of every stacked
tensor is what rank (pod g, data i, model t) holds. The model axis is
outermost, so each tp group is a contiguous copy of the pod-major ``(pod,
data)`` grid, the order of ``P(('pod', 'data'))``. A :class:`Grid` (G and
T; N is what a stack's P leaves) is passed to every collective, and
``axis`` names the one it acts over, always inside each tp group (the sync
never reduces the tp groups against each other):

  ``DATA``  within each pod, over its N data peers (the ring, tree and TAR
            schedules; ``ppermute`` pairs and per-peer rows are data
            indices, applied in every pod of every tp group at once);
  ``POD``   across the G pods, at a fixed data index (the outer reduce);
  ``BOTH``  over the G * N peers of a tp group (the psum topology, the
            quantizer's grids).

The grid's helpers (:meth:`Grid.by_group`, :meth:`Grid.group_rows`,
:meth:`Grid.group_offsets`) are the one place outside this module's
collectives that knows the model axis is outermost: the trainer and the
quantizing codec lay their per-tp-group tensors out through them.

Each collective is a reindexing of the peer axis over all P peers at once,
so one kernel launch still covers every peer of a bucket in every pod and
every tp group. With G = T = 1 the results are views where one exists (no
copy: the kernels read the strided views directly); over pods or tp groups
the transposes are copies.
``ppermute`` is one gather (or, when it names only some destinations, one
``index_copy_`` into zeros) over all P peers, and the module counter
``permutes`` counts its calls, as the reference's tests count
``collective_permute`` sites in its HLO.

**Over a process group (one rank a peer).** ``Grid(group=pg)`` (or
:func:`rank_grid`) puts the peers on the ranks of a ``torch.distributed``
process group, one peer a rank, as the reference puts one on each device:
a stack's leading axis holds this rank's one row, and each primitive gives
that row of the stacked form's result, bit for bit. With ``pods=G`` the
group's G * N ranks are the ``(pod, data)`` grid, pod-major (rank ``g * N
+ i``, the order of ``P(('pod', 'data'))``), and the grid carries two more
groups made from it (:func:`rank_grid`, the same ``new_group`` calls on
every rank): the data group of this rank's pod (ranks ``g * N ... g * N +
N - 1``) and the pod group of its data index (ranks ``i, N + i, ...``).
Each primitive runs in the group of its ``axis``: ``DATA`` the data group,
``POD`` the pod group, ``BOTH`` the whole grid. ``axis_size`` is that
group's size, ``axis_index``, ``per_peer``, ``take_rows`` and ``put_rows``
read the rank's own entry (its index on the axis: ``r mod N`` on the data
axis, ``r div N`` on the pod axis), ``all_to_all`` is
``all_to_all_single``, ``all_gather`` is ``all_gather_into_tensor`` (the
list form on gloo), :func:`all_gather_dim` the same gather of a rank's
tensor concatenated along one of its dims (the FSDP weight gather's over
the whole grid, the reference's ``all_gather(..., axis=dim, tiled=True)``
over ``('pod', 'data')``), ``ppermute`` an ``all_to_all_single`` in the
data group whose split sizes name the rank's one destination and one
source (a rank no pair names receives zeros; ``permutes`` counts each call
once, as above). ``pmean`` and ``pmax`` gather every row of the axis and
reduce them here, the sum in index order (a library ``all_reduce``
reorders its adds) and the max through ``amax`` (NaN passes, where NCCL's
``fmaxf`` may drop it). The module counters ``dist_bytes`` (bytes this
rank sends; ``dist_axis_bytes`` the same by the axis whose group carried
them) and ``dist_s`` (host seconds inside the library's calls) measure the
traffic. Over gloo a call returns when its data has moved, so
``dist_s`` is the whole wait; an NCCL call returns once its work is queued
on the card, so there ``dist_s`` is the enqueue only.

With ``tp=T`` (one pod) the group's N * T ranks are the reference's
``("data", "model")`` mesh, model innermost: rank ``r = i * T + t`` is
data index i, tp index t, so a tp group is T adjacent ranks. The grid
makes each data index's tp group (the ``MODEL`` axis) and each tp index's
data group (ranks ``t, T + t, ...``), once; ``DATA`` and ``BOTH`` run in
the data group, ``MODEL`` in the tp group. ``Grid.rank`` and
``index_on(DATA)`` are the data index ``r // T``, which keys the batch
rows and the masks, so every tp rank of a data index draws that index's,
as every tp group of the stacked form does; ``index_on(MODEL)`` is ``r mod
T``. A stack holds the rank's one row: the grid's ``tp_rows`` is 1, and
the sync sees one tp group (the codecs' grids ungrouped). :func:`psum`
over ``MODEL`` gathers the tp group's rows and adds them in rank order in
their dtype (no library ``all_reduce``), as ``pmean`` does. With one pod
``BOTH`` is the data group, so the FSDP weight gather over ``BOTH``
(FSDP x TP over ranks) joins the data shards of the rank's own tp chunk,
and a checkpoint's gather of a leaf cut both ways runs over ``BOTH``, then
``MODEL``. Pods and tp together over ranks are a later slice (ROADMAP
A18c).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

DATA = "data"
POD = "pod"
MODEL = "model"
BOTH = (POD, DATA)

permutes = 0
dist_bytes = 0           # bytes this rank sent through the process group
dist_s = 0.0             # host seconds inside the process group's calls
# dist_bytes by the axis whose group carried them: "data", "pod", "both",
# "model"
dist_axis_bytes: dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class Grid:
    """The layout of a stack's P peers: T tp groups (``tp``) of G pods
    (``pods``) of N data peers, ordered ``(model, pod, data)``. N is what a
    stack's P leaves, P / (T * G). With ``group`` (a ``torch.distributed``
    process group of G * N ranks, pod-major, or of N * T ranks, model
    innermost) the peers are the group's ranks, one a rank, and a stack
    holds this rank's row alone; ``data_group``, ``pod_group`` and
    ``model_group`` are this rank's data, pod and tp groups, made from
    ``group`` once a (group, pods, tp) (:func:`_subgroups`)."""
    pods: int = 1
    tp: int = 1
    group: Any = None
    data_group: Any = dataclasses.field(default=None, init=False,
                                        compare=False, repr=False)
    pod_group: Any = dataclasses.field(default=None, init=False,
                                       compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, init=False,
                                         compare=False, repr=False)

    def __post_init__(self):
        if self.pods < 1 or self.tp < 1:
            raise ValueError(f"pods and tp must be positive, got "
                             f"{self.pods} and {self.tp}")
        if self.group is None:
            return
        if self.pods > 1 and self.tp > 1:
            raise ValueError(
                f"pods x tp over ranks ({self.pods} pods, tp {self.tp}) is "
                "a later slice of ROADMAP A18c: a process group runs pods "
                "or tp groups, not both")
        if self.ranks % (self.pods * self.tp):
            raise ValueError(
                f"{self.ranks} ranks do not fill {self.pods} pods"
                if self.tp == 1 else
                f"{self.ranks} ranks do not fill tp groups of {self.tp}")
        data, pod, model = ((self.group, None, None)
                            if self.pods == self.tp == 1
                            else _subgroups(self.group, self.pods, self.tp))
        object.__setattr__(self, "data_group", data)
        object.__setattr__(self, "pod_group", pod)
        object.__setattr__(self, "model_group", model)

    @property
    def rank(self) -> int:
        """This process's index on the ``(pod, data)`` grid, pod-major
        (``g * N + i``): its rank in ``group`` over T (0 without)."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group) // self.tp

    @property
    def ranks(self) -> int:
        """The group's size, G * N * T (1 without a group)."""
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def tp_rows(self) -> int:
        """The tp groups a stack holds: T, or 1 over a process group (a
        rank's row is one tp rank's)."""
        return 1 if self.group is not None else self.tp

    def index_on(self, axis) -> int:
        """This rank's index on ``axis``: its data index ``r mod N``, its
        pod index ``r div N`` or ``r`` on ``BOTH`` (r its ``(pod, data)``
        index, :attr:`rank`), its tp index on ``MODEL``."""
        _check_axis(axis)
        if axis == MODEL:
            if self.group is None:
                return 0
            import torch.distributed as dist
            return dist.get_rank(self.group) % self.tp
        r, n = self.rank, self.ranks // (self.pods * self.tp)
        if axis == BOTH:
            return r
        return r % n if axis == DATA else r // n

    def axis_group(self, axis):
        """The process group an ``axis`` collective runs in: the data
        group, the pod group (None with one pod), the whole ``(pod,
        data)`` grid, or the tp group (None at tp 1)."""
        _check_axis(axis)
        if axis == BOTH:
            return self.group if self.tp == 1 else self.data_group
        return {DATA: self.data_group, POD: self.pod_group,
                MODEL: self.model_group}[axis]

    @property
    def blocks(self) -> int:
        """The data axis's blocks of N contiguous peers of a stack: T * G
        (G over a process group)."""
        return self.tp_rows * self.pods

    def data_size(self, p: int) -> int:
        """N, the data peers of each pod of a stack of ``p`` peers (the
        data group's ranks, where a stack holds one)."""
        if self.group is not None:
            if p != 1:
                raise ValueError(f"a process group's stack holds this "
                                 f"rank's one row, got {p}")
            return self.ranks // (self.pods * self.tp)
        if p % self.blocks:
            raise ValueError(f"{p} peers do not fill {self.tp} x "
                             f"{self.pods} pods")
        return p // self.blocks

    def by_group(self, x: torch.Tensor) -> torch.Tensor:
        """A ``(P, ...)`` stack as ``(T, G * N, ...)``, a tp group a row (a
        view; one row over a process group)."""
        return x.view(self.tp_rows, -1, *x.shape[1:])

    def group_rows(self, x: torch.Tensor) -> torch.Tensor:
        """One row of each tp group of a ``(P, ...)`` stack whose rows are
        equal within each group (a pmax over ``BOTH``): ``(...)`` when
        the stack holds one tp group, else ``(T, ...)``."""
        if self.tp_rows == 1:
            return x[0]
        return x[::x.shape[0] // self.tp]

    def group_offsets(self, p: int, stride: int,
                      device: torch.device) -> torch.Tensor:
        """``(P,)``: each of ``p`` peers' tp group times ``stride``, where
        its group's rows start in a ``(T * stride, ...)`` table."""
        per_group = p // self.tp_rows
        return index(tuple(q // per_group * stride for q in range(p)),
                     device)


ONE = Grid()


def rank_grid(group=None, pods: int = 1, tp: int = 1) -> Grid:
    """The grid of a process group's ranks, one peer a rank (the default
    group when None): ``pods`` pods of the group's size / ``pods`` data
    peers, pod-major, or data peers of ``tp`` tp ranks each, model
    innermost. Every rank must call it alike: over pods or tp it makes the
    subgroups (``dist.new_group``), once a (group, pods, tp)."""
    import torch.distributed as dist
    return Grid(pods=pods, tp=tp, group=dist.group.WORLD if group is None
                else group)


_subgroup_cache: dict = {}


def _subgroups(group, pods: int, tp: int = 1):
    """``(data group, pod group, tp group)`` of this rank on the grid of
    ``group``'s ranks, made once a (group, pods, tp), every rank making
    every group in the same order, as ``dist.new_group`` asks. Pods
    (pod-major, rank ``g * N + i``): every data group (``g * N ... g * N +
    N - 1``), then every pod group (``i, N + i, ...``); no tp group. tp
    (model innermost, rank ``i * T + t``): every tp group (``i * T ... i *
    T + T - 1``), then every data group (``t, T + t, ...``); no pod
    group."""
    import torch.distributed as dist
    cache_key = (id(group), pods, tp)
    if cache_key not in _subgroup_cache:
        ranks = dist.get_process_group_ranks(group)
        me = dist.get_rank(group)
        backend = dist.get_backend(group)
        if tp == 1:
            n = len(ranks) // pods
            made = [dist.new_group([ranks[g * n + i] for i in range(n)],
                                   backend=backend) for g in range(pods)]
            made += [dist.new_group([ranks[g * n + i] for g in range(pods)],
                                    backend=backend) for i in range(n)]
            mine = (made[me // n], made[pods + me % n], None)
        else:
            n = len(ranks) // tp
            made = [dist.new_group([ranks[i * tp + t] for t in range(tp)],
                                   backend=backend) for i in range(n)]
            made += [dist.new_group([ranks[i * tp + t] for i in range(n)],
                                    backend=backend) for t in range(tp)]
            mine = (made[n + me % tp], None, made[me // tp])
        # the group is kept beside its subgroups, so its id stays its own
        _subgroup_cache[cache_key] = (group, *mine)
    return _subgroup_cache[cache_key][1:]


@functools.lru_cache(maxsize=512)
def index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor on ``device``, made once: the schedules'
    per-peer indices (``vpos[p]``, ``(k + r) % n``, ...) never change, and
    making them anew would copy from the host at every round."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def per_peer(values: tuple[int, ...], device: torch.device,
             grid: Grid = ONE) -> torch.Tensor:
    """``(P,)`` index tensor of a per-data-index table ``values`` (length
    N): peer ``b * N + i`` reads ``values[i]`` in every block b of the
    grid (over a process group: the rank's own entry, its data index's,
    ``(1,)``)."""
    if grid.group is not None:
        return index((values[grid.index_on(DATA)],), device)
    return index(tuple(values) * grid.blocks, device)


def _check_axis(axis) -> None:
    if axis not in (DATA, POD, BOTH, MODEL):
        raise ValueError(f"unknown peer axis {axis!r}; one of "
                         f"{DATA!r}, {POD!r}, {BOTH!r}, {MODEL!r}")


def axis_size(x: torch.Tensor, grid: Grid = ONE, axis=DATA) -> int:
    """The size of ``axis`` on the grid of ``x``'s P peers: N, G, G * N
    or T."""
    _check_axis(axis)
    n = grid.data_size(x.shape[0])
    return {DATA: n, POD: grid.pods, BOTH: grid.pods * n,
            MODEL: grid.tp}[axis]


def axis_index(x: torch.Tensor, grid: Grid = ONE,
               axis=DATA) -> torch.Tensor:
    """Each peer's own index on ``axis``, ``(P,)``."""
    n = axis_size(x, grid)
    if grid.group is not None:
        return index((grid.index_on(axis),), x.device)
    peers = torch.arange(x.shape[0], device=x.device)
    return {DATA: peers % n, POD: (peers // n) % grid.pods,
            BOTH: peers % (grid.pods * n),
            MODEL: peers // (grid.pods * n)}[axis]


def on_grid(rows: torch.Tensor, x: torch.Tensor, grid: Grid = ONE,
            axis=DATA) -> torch.Tensor:
    """Lay per-axis-index rows ``(n, ...)`` onto ``x``'s P peers: peer p
    takes the row of its index on ``axis`` (every pod and tp group the same
    rows over the data axis). ``rows`` itself when the axis spans every
    peer."""
    if rows.shape[0] == x.shape[0]:
        return rows
    return rows.index_select(0, axis_index(x, grid, axis))


def _dist_call(fn, sent: int, axis) -> None:
    """Run one call of the process group's library in ``axis``'s group,
    counting the bytes this rank sends (also by axis) and the host seconds
    until it returns."""
    global dist_bytes, dist_s
    t0 = time.perf_counter()
    fn()
    dist_s += time.perf_counter() - t0
    dist_bytes += sent
    name = "both" if axis == BOTH else axis    # "data", "pod", "model"
    dist_axis_bytes[name] = dist_axis_bytes.get(name, 0) + sent


def _is_gloo(pg) -> bool:
    import torch.distributed as dist
    return dist.get_backend(pg) == "gloo"


def gather_peers(x: torch.Tensor, grid: Grid = ONE,
                 axis=DATA) -> torch.Tensor:
    """Every ``axis`` peer's row of a ``(P, ...)`` stack, ``(n, ...)`` in
    index order: the stack itself, or over a process group every rank's one
    row gathered in the axis's group (the stacked form's stack, bit for
    bit; the row itself on the pod axis of one pod)."""
    if grid.group is None:
        return x
    pg = grid.axis_group(axis)
    if pg is None:
        return x
    import torch.distributed as dist
    n = axis_size(x, grid, axis)
    row = x[0].contiguous()
    out = torch.empty((n, *row.shape), dtype=row.dtype, device=row.device)
    nbytes = row.numel() * row.element_size()
    if _is_gloo(pg):
        _dist_call(lambda: dist.all_gather(list(out.unbind(0)), row,
                                           group=pg), nbytes, axis)
    else:
        _dist_call(lambda: dist.all_gather_into_tensor(out, row, group=pg),
                   nbytes, axis)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, grid: Grid = ONE,
                   axis=BOTH) -> torch.Tensor:
    """Tiled all_gather of one rank's tensor along its dim ``dim``: every
    ``axis`` rank's ``x`` concatenated along ``dim`` in index order (on
    ``BOTH`` the whole grid, pod-major), held by every rank (a reliable
    gather, through :func:`gather_peers`). ``x`` itself without a process
    group, where a tensor is already whole."""
    if grid.group is None:
        return x
    rows = gather_peers(x.unsqueeze(0), grid, axis)
    return rows.movedim(0, dim).flatten(dim, dim + 1)


def _all_to_all_rows(x: torch.Tensor, grid: Grid, axis) -> torch.Tensor:
    """``(1, n, S)`` -> ``(1, n, S)`` over ``axis``'s process group: row j
    goes to its rank j, row i of the result came from its rank i."""
    import torch.distributed as dist
    send = x[0].contiguous()
    out = torch.empty_like(send)
    _dist_call(lambda: dist.all_to_all_single(
        out, send, group=grid.axis_group(axis)),
        send.numel() * send.element_size(), axis)
    return out.unsqueeze(0)


def all_to_all(x: torch.Tensor, grid: Grid = ONE, axis=DATA) -> torch.Tensor:
    """Tiled all_to_all over ``axis``: ``(P, n, S)`` sender-major (row p =
    what peer p sends to each of the axis's n peers) -> receiver-major
    ``(P, n, S)`` (row q = the shards peer q received, one per sender, in
    the senders' axis order)."""
    n = axis_size(x, grid, axis)
    if x.shape[1] != n:
        raise ValueError(f"all_to_all over {n} peers needs {n} shards each, "
                         f"got {x.shape[1]}")
    s, tp, pods = x.shape[2], grid.tp, grid.pods
    if grid.group is not None:
        if grid.axis_group(axis) is None:
            return x
        return _all_to_all_rows(x, grid, axis)
    if axis == POD:                   # (t, h, i, g) -> (t, g, i, h)
        if pods == 1:
            return x
        m = grid.data_size(x.shape[0])
        y = x.reshape(tp, pods, m, pods, s).permute(0, 3, 2, 1, 4)
        return y.reshape(x.shape)
    blocks = grid.blocks if axis == DATA else tp
    if blocks == 1:
        return x.transpose(0, 1)
    # within each block of n peers: (b, i, j) -> (b, j, i)
    return x.reshape(blocks, n, n, s).transpose(1, 2).reshape(x.shape)


def all_gather(own: torch.Tensor, grid: Grid = ONE,
               axis=DATA) -> torch.Tensor:
    """Tiled all_gather over ``axis``: ``(P, S)`` -> ``(P, n*S)``, every
    peer holding the concatenation of its axis peers' shards in axis order
    (a broadcast view when the axis spans every peer)."""
    p, tp, pods = own.shape[0], grid.tp, grid.pods
    n = axis_size(own, grid, axis)
    if grid.group is not None:
        if grid.axis_group(axis) is None:
            return own
        return gather_peers(own, grid, axis).reshape(1, n * own.shape[-1])
    if axis == POD:
        if pods == 1:
            return own
        m = grid.data_size(p)
        # the G shards at data index i, for each pod of each tp group
        rows = own.reshape(tp, pods, m, -1).transpose(1, 2).reshape(
            tp, 1, m, -1)
        return rows.expand(tp, pods, m, -1).reshape(p, n * own.shape[-1])
    blocks = grid.blocks if axis == DATA else tp
    if blocks == 1:
        return own.reshape(1, -1).expand(p, -1)
    # each block's n shards, for each of its n peers
    rows = own.reshape(blocks, 1, n * own.shape[-1])
    return rows.expand(blocks, n, -1).reshape(p, n * own.shape[-1])


def mean_of(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` rounded as the reference's XLA rounds a division by a
    constant: a multiply by the fp32 reciprocal (equal to the division when
    n is a power of two, within an ulp of it otherwise)."""
    return total * (1.0 / n)


def _grouped(x: torch.Tensor, grid: Grid, axis) -> torch.Tensor:
    """``x`` with the peers of each ``axis`` group on dim 1."""
    n = grid.data_size(x.shape[0])
    if axis == DATA:
        return x.reshape(grid.blocks, n, *x.shape[1:])
    if axis == POD:
        return x.reshape(grid.tp, grid.pods, n, *x.shape[1:])
    return x.reshape(grid.tp, grid.pods * n, *x.shape[1:])


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim``, kept, its adds in index order: the same bits
    whatever the other dims' sizes (a library reduction may reorder its
    adds with the row width), as the reference's psum adds in rank
    order."""
    parts = x.unbind(dim)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.unsqueeze(dim)


def psum(x: torch.Tensor, grid: Grid = ONE, axis=MODEL) -> torch.Tensor:
    """Sum over ``axis`` in index order and in ``x``'s dtype, held by every
    peer on it: ``(P, ...)`` -> ``(P, ...)``. Over a process group the
    axis's rows are gathered and added here (a library ``all_reduce``
    reorders its adds), so every rank holds the same bits; on stacked peers
    the model axis alone (the T tp groups' rows at each peer)."""
    if grid.group is not None:
        if grid.axis_group(axis) is None:
            return x
        return _sum_in_order(gather_peers(x, grid, axis), 0)
    if axis != MODEL:
        raise ValueError(f"psum of stacked peers sums the model axis, not "
                         f"{axis!r}")
    xs = x.reshape(grid.tp, -1, *x.shape[1:])
    return _sum_in_order(xs, 0).expand_as(xs).reshape(x.shape)


def pmean(x: torch.Tensor, grid: Grid = ONE, axis=DATA) -> torch.Tensor:
    """Mean over ``axis``, held by every peer on it: ``(P, ...)`` ->
    ``(P, ...)``."""
    n = axis_size(x, grid, axis)
    if grid.group is not None:
        if grid.axis_group(axis) is None:
            return x
        return mean_of(_sum_in_order(gather_peers(x, grid, axis), 0), n)
    if n == x.shape[0]:
        return mean_of(_sum_in_order(x, 0), n).expand_as(x)
    xs = _grouped(x, grid, axis)
    return mean_of(_sum_in_order(xs, 1), n).expand_as(xs).reshape(x.shape)


def pmax(x: torch.Tensor, grid: Grid = ONE, axis=DATA) -> torch.Tensor:
    """Max over ``axis``, held by every peer on it (``amax``: a NaN on any
    peer gives NaN)."""
    n = axis_size(x, grid, axis)
    if grid.group is not None:
        if grid.axis_group(axis) is None:
            return x
        return gather_peers(x, grid, axis).amax(dim=0, keepdim=True)
    if n == x.shape[0]:
        return x.amax(dim=0, keepdim=True).expand_as(x)
    xs = _grouped(x, grid, axis)
    return xs.amax(dim=1, keepdim=True).expand_as(xs).reshape(x.shape)


def take_rows(x: torch.Tensor, rows: tuple[int, ...],
              grid: Grid = ONE) -> torch.Tensor:
    """Row ``rows[i]`` of each peer's ``(P, R, ...)`` stack, ``(P, ...)``,
    ``i`` the peer's data index: the reference's ``jnp.take(x, i)`` with a
    per-device index, for all peers in one indexed read."""
    peers = index(tuple(range(x.shape[0])), x.device)
    return x[peers, per_peer(rows, x.device, grid)]


def put_rows(x: torch.Tensor, rows: tuple[int, ...], value: torch.Tensor,
             grid: Grid = ONE) -> None:
    """``x[p, rows[i]] = value[p]`` for every peer, in one indexed write."""
    peers = index(tuple(range(x.shape[0])), x.device)
    x[peers, per_peer(rows, x.device, grid)] = value


def ppermute(x: torch.Tensor, perm, grid: Grid = ONE) -> torch.Tensor:
    """``jax.lax.ppermute`` over the data axis: ``out[dst] = x[src]`` for
    each ``(src, dst)`` pair of data indices, in every pod and tp group; a
    destination no pair names receives zeros (the reference's relays and
    grafts add such results)."""
    global permutes
    n = axis_size(x, grid)
    pairs = [(int(s), int(d)) for s, d in perm]
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in pairs}) != len(pairs):
        raise ValueError(f"ppermute pairs {pairs} repeat a source or "
                         "destination")
    if any(not (0 <= i < n) for pair in pairs for i in pair):
        raise ValueError(f"ppermute pairs {pairs} outside the {n}-peer axis")
    permutes += 1
    if grid.group is not None:
        return _ppermute_rows(x, pairs, grid)
    lifted = [(b * n + s, b * n + d) for b in range(grid.blocks)
              for s, d in pairs]
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


def _ppermute_rows(x: torch.Tensor, pairs, grid: Grid) -> torch.Tensor:
    """``ppermute`` of a one-row stack over a process group: one
    ``all_to_all_single`` every rank of the data group joins, its split
    sizes naming this rank's destination and source (a self pair is a
    copy); zeros where no pair names the rank as a destination."""
    import torch.distributed as dist
    rank, n = grid.index_on(DATA), grid.data_size(1)
    dst = next((d for s_, d in pairs if s_ == rank), None)
    src = next((s_ for s_, d in pairs if d == rank), None)
    if src is None:
        out = torch.zeros_like(x)
    elif src == rank:
        out = x.clone()
    else:
        out = torch.empty_like(x)
    send = x.contiguous()
    width = send.numel()
    in_splits = [width if j == dst and dst != rank else 0 for j in range(n)]
    out_splits = [width if j == src and src != rank else 0
                  for j in range(n)]
    recv = out if sum(out_splits) else out.new_empty((0,))
    _dist_call(lambda: dist.all_to_all_single(
        recv.view(-1), send.view(-1) if sum(in_splits) else send.new_empty(
            (0,)), out_splits, in_splits, group=grid.data_group),
        sum(in_splits) * send.element_size(), DATA)
    return out
