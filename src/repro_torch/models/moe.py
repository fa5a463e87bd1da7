"""Top-k Mixture-of-Experts: capacity-based dispatch with scatter/gather.

Counterpart of ``src/repro/models/moe.py``. Under tensor parallelism the
reference shards the (padded) experts over the tp ranks: every rank routes
every token with the replicated router, computes only its ``E_pad / T``
experts, and the ranks' partial outputs are psum'd (``reduce_output``
under SP). The port computes all ``E_pad`` experts in one batched product
(an expert's output does not depend on the rank that holds it), then
adds the weighted slots, by the rank that owns their expert, into a ``(T,
B, S, D)`` stack of the ranks' partial outputs (one ``index_add``) and
reduces it in rank order, so the sum rounds as the reference's psum does.
No ``(T, E, C)`` one-hot is formed: the position of each (token, slot) within its expert comes from a
cumulative sum over the token-major, then slot, order of the assignments,
the reference's order, so the same tokens overflow an expert's capacity
and are dropped. The dispatch buffer is ``(G, E, C, D)`` for G routing
groups (1 but under the batch-sharded serving plan); a dropped assignment
adds a zero into its clamped slot, so the scatter-add (``index_put`` with
``accumulate``) is exact whatever order it adds in: each slot receives one
non-zero value.
Routing runs in fp32; the expert products in the activation dtype.

Over ranks (``pctx.over_ranks()``: one tp rank a process) a rank holds only
its own ``E_local = E_pad / T`` experts, ``we_gate`` / ``we_up`` ``(E_local,
D, F)`` and ``we_down`` ``(E_local, F, D)``, and the whole router. It routes
every token of its data index with the whole router as above (the same
capacity, from the global ``E_pad`` and the local token count, so the same
assignments overflow), dispatches only the assignments whose expert lies in
its own range ``[t E_local, (t+1) E_local)`` into an ``(E_local, C, D)``
buffer (the reference's ``is_local``, ``safe_e``, ``safe_p``), runs the
expert products on its own chunk, and forms its partial output as the
stacked form forms row t of its stack: its weighted slots added in fp32 (at
least) in slot order, rounded once; ``reduce_output`` then sums the partials
over the tp group. Both the block's input and the router go through
``pctx.copy_tp`` (Megatron's "f"): the K gates of a token are a softmax of
its K logits, so the gradient of every logit, and through it of the input
and the router, couples the token's K slots, while a rank's loss reaches
only the slots of its own experts. Each rank's input and router gradients
are therefore partial sums, and "f" adds them over the tp group, so every tp
rank holds the whole router gradient before the trainer takes tp rank 0's
copy of a leaf replicated over tp.

While decoding on the peer grid (``serve/engine.py``) two more forms are
the reference's. Under the batch-sharded plan each of the P data peers
routes its own B/P rows' tokens (``peers``): the capacity comes from the
peer's own token count, so routing the whole batch at once would drop other
tokens; the routing then runs on a ``(P, T/P, ...)`` stack. The
weights-stationary form (``pctx.moe_stationary`` under FSDP) keeps the
expert weights sharded over the data axes on D: peer i takes its D-slice of
its dispatch buffer and of ``we_gate`` / ``we_up`` (views of the stored
weight), the P partial products, each in the activation dtype, are
``psum_dp``'d, each peer computes its D-slice of ``we_down``'s output and a
tiled all_gather puts the slices together. Under the batch-sharded plan the
peers' buffers hold different tokens and the reference's psum adds them
together (ROADMAP C); the port computes the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import collectives

from .layers import activation_fn
from .parallel import SINGLE, ParallelCtx


class Routing(NamedTuple):
    """Each group's routing; the leading dims are the groups'."""
    logits: torch.Tensor      # (..., T, E_pad) fp32
    gate_idx: torch.Tensor    # (..., T, K) int64, each token's experts
    gates: torch.Tensor       # (..., T, K) fp32, softmax of the K logits
    pos: torch.Tensor         # (..., T, K) position within the expert
    keep: torch.Tensor        # (..., T, K) bool, pos < capacity
    capacity: int


def route(xt: torch.Tensor, router: torch.Tensor, *, top_k: int,
          n_experts: int, capacity_factor: float = 1.25) -> Routing:
    """Router logits, top-k experts and their gates, and each assignment's
    position in its expert's buffer. ``xt``: (..., T, D), each leading
    index a group routed on its own; ``router``: (D, E_pad); padded experts
    are masked to -1e30 and never picked."""
    *lead, t, _ = xt.shape
    e_pad = router.shape[-1]
    logits = (xt @ router.to(xt.dtype)).to(torch.float32)
    if e_pad > n_experts:
        pad = torch.arange(e_pad, device=xt.device) >= n_experts
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    gate_vals, gate_idx = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(gate_vals, dim=-1)
    capacity = max(1, int(capacity_factor * top_k * t / e_pad))
    # position of each (token, slot) within its expert, over all K slots
    onehot = F.one_hot(gate_idx, e_pad).to(torch.int32)    # (..., T, K, E)
    pos_flat = torch.cumsum(onehot.reshape(*lead, t * top_k, e_pad),
                            dim=-2) - 1
    pos = torch.gather(pos_flat.reshape(*lead, t, top_k, e_pad), -1,
                       gate_idx[..., None])[..., 0]
    return Routing(logits, gate_idx, gates, pos, pos < capacity, capacity)


def _d_slices(w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The n contiguous slices of ``w`` along ``dim``, stacked first: the
    data peers' FSDP shards of a weight stored whole."""
    shape = list(w.shape)
    shape[dim:dim + 1] = [n, shape[dim] // n]
    return w.reshape(shape).movedim(dim, 0)


def moe_block(x: torch.Tensor, w: dict, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25, activation: str = "silu",
              peers: int = 1, weights_stationary: bool = False,
              pctx: ParallelCtx | None = None) -> torch.Tensor:
    """x: (B, S, D). w: router (D, E_pad); we_gate / we_up (E_pad, D, F),
    we_down (E_pad, F, D) (over ranks the rank's ``E_local`` experts of
    them, :func:`_own_experts`). ``peers``: the batch's rows are that many data
    peers' (peer-major), each routed on its own. ``weights_stationary``:
    the expert products run on the D-slices of ``pctx``'s data peers.
    Returns (B, S, D)."""
    act = activation_fn(activation)
    pctx = pctx or SINGLE
    b, s, d = x.shape
    if b % peers:
        raise ValueError(f"batch {b} does not split over {peers} peers")
    router = w["router"]
    if pctx.over_ranks():
        x, router = pctx.copy_tp(x), pctx.copy_tp(router)
    xt = x.reshape(peers, b // peers * s, d)
    r = route(xt, router, top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor)
    if pctx.over_ranks():
        return _own_experts(xt, r, w, act, pctx).reshape(b, s, d)
    e_pad = w["router"].shape[-1]
    safe_p = r.pos.clamp(0, r.capacity - 1)
    group = torch.arange(peers, device=x.device)[:, None, None].expand_as(
        r.gate_idx)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    contrib = torch.where(r.keep[..., None], xt[:, :, None, :], zero)
    buf = torch.zeros((peers, e_pad, r.capacity, d), dtype=xt.dtype,
                      device=xt.device).index_put(
        (group, r.gate_idx, safe_p), contrib, accumulate=True)  # (G, E, C, D)
    if weights_stationary:
        n = pctx.dp_size()
        if d % n:
            raise ValueError(f"d_model {d} does not split over {n} data "
                             "peers")
        # peer i's D-slice of its own buffer (of the one buffer when the
        # batch is not sharded over the peers)
        d_l = d // n
        part = torch.stack([buf[i if peers == n else 0, ..., i * d_l:
                                (i + 1) * d_l] for i in range(n)])
        g = pctx.psum_dp(torch.matmul(
            part, _d_slices(w["we_gate"].to(xt.dtype), 1, n)))[0]
        u = pctx.psum_dp(torch.matmul(
            part, _d_slices(w["we_up"].to(xt.dtype), 1, n)))[0]
        out_slices = torch.matmul(act(g) * u,
                                  _d_slices(w["we_down"].to(xt.dtype), 2, n))
        out_buf = pctx.gather_dp_tiled(out_slices, 2)[0]        # (E, C, D)
        gathered = out_buf[r.gate_idx, safe_p]                  # (G, T, K, D)
    else:
        g = torch.matmul(buf, w["we_gate"].to(xt.dtype))
        u = torch.matmul(buf, w["we_up"].to(xt.dtype))
        out_buf = torch.matmul(act(g) * u, w["we_down"].to(xt.dtype))
        gathered = out_buf[group, r.gate_idx, safe_p]
    gathered = torch.where(r.keep[..., None], gathered, zero)
    weighted = gathered * r.gates[..., None].to(xt.dtype)     # (G, T, K, D)
    t = pctx.tp_size()
    if t == 1:
        return weighted.sum(dim=2).reshape(b, s, d)
    if e_pad % t:
        raise ValueError(f"{e_pad} experts do not split over {t} tp ranks")
    # tp rank j owns experts [j E/T, (j+1) E/T): its partial output sums
    # the slots its experts hold, in fp32 (at least) and rounded once as
    # the sum over K above; the T partials are then reduced in rank order
    n_tok = b * s
    owner = r.gate_idx // (e_pad // t)                        # (G, T, K)
    rows = owner * n_tok + torch.arange(
        n_tok, device=x.device).view(peers, -1, 1)            # (G, T, K)
    acc = torch.promote_types(xt.dtype, torch.float32)
    parts = torch.zeros((t * n_tok, d), dtype=acc, device=x.device).index_add(
        0, rows.reshape(-1), weighted.reshape(-1, d).to(acc))
    return pctx.reduce_output(parts.to(xt.dtype).view(t, b, s, d))


def _own_experts(xt: torch.Tensor, r: Routing, w: dict, act,
                 pctx: ParallelCtx) -> torch.Tensor:
    """Over ranks: this tp rank's experts on their assignments of ``xt``
    (``(G, T, D)``, routed as ``r``), its partial output summed over the tp
    group, ``(G, T, D)``."""
    e_local = w["we_gate"].shape[0]
    local = r.gate_idx - pctx.tp_grid.index_on(collectives.MODEL) * e_local
    own = (local >= 0) & (local < e_local) & r.keep            # (G, T, K)
    safe_e = local.clamp(0, e_local - 1)
    safe_p = r.pos.clamp(0, r.capacity - 1)
    groups, _, d = xt.shape
    group = torch.arange(groups, device=xt.device)[:, None, None].expand_as(
        r.gate_idx)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    contrib = torch.where(own[..., None], xt[:, :, None, :], zero)
    buf = torch.zeros((groups, e_local, r.capacity, d), dtype=xt.dtype,
                      device=xt.device).index_put(
        (group, safe_e, safe_p), contrib, accumulate=True)  # (G, E_l, C, D)
    g = torch.matmul(buf, w["we_gate"].to(xt.dtype))
    u = torch.matmul(buf, w["we_up"].to(xt.dtype))
    out_buf = torch.matmul(act(g) * u, w["we_down"].to(xt.dtype))
    gathered = torch.where(own[..., None], out_buf[group, safe_e, safe_p],
                           zero)
    weighted = gathered * r.gates[..., None].to(xt.dtype)     # (G, T, K, D)
    # the slots in order, in fp32 (at least), rounded once: the stacked
    # form's row of this rank (its other ranks' slots add zeros there)
    acc = torch.promote_types(xt.dtype, torch.float32)
    part = weighted[:, :, 0].to(acc)
    for k in range(1, weighted.shape[2]):
        part = part + weighted[:, :, k].to(acc)
    return pctx.reduce_output(part.to(xt.dtype)[None])


def moe_aux_loss(logits_f32: torch.Tensor, gate_idx: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss (mean gate prob x mean assignment)."""
    probs = torch.softmax(logits_f32, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], probs.shape[-1]).to(probs.dtype).mean(0)
    return n_experts * torch.sum(me * ce)
