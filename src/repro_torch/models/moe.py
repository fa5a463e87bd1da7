"""Top-k Mixture-of-Experts: capacity-based dispatch with scatter/gather.

Counterpart of ``src/repro/models/moe.py`` at one tensor-parallel rank
(experts over tp are ROADMAP A21c; ``param_table`` refuses them), so no
``pctx`` is taken. No ``(T, E, C)`` one-hot is formed: the position of
each (token, slot) within its expert comes from a cumulative sum over the
token-major, then slot, order of the assignments, the reference's order,
so the same tokens overflow an expert's capacity and are dropped. The
dispatch buffer is ``(E, C, D)``; a dropped assignment adds a zero into its
clamped slot, so the scatter-add (``index_put`` with ``accumulate``) is
exact whatever order it adds in: each slot receives one non-zero value.
Routing runs in fp32; the expert products in the activation dtype.

The weights-stationary form of serving (expert weights left sharded over
the data axes, the reference's ``pctx.moe_stationary``) belongs to the
serving slice (ROADMAP A21, serving) and raises here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import activation_fn


class Routing(NamedTuple):
    logits: torch.Tensor      # (T, E_pad) fp32
    gate_idx: torch.Tensor    # (T, K) int64, each token's experts, best first
    gates: torch.Tensor       # (T, K) fp32, softmax over the K picked logits
    pos: torch.Tensor         # (T, K) position within the expert
    keep: torch.Tensor        # (T, K) bool, pos < capacity
    capacity: int


def route(xt: torch.Tensor, router: torch.Tensor, *, top_k: int,
          n_experts: int, capacity_factor: float = 1.25) -> Routing:
    """Router logits, top-k experts and their gates, and each assignment's
    position in its expert's buffer. ``xt``: (T, D); ``router``: (D,
    E_pad); padded experts are masked to -1e30 and never picked."""
    t = xt.shape[0]
    e_pad = router.shape[-1]
    logits = (xt @ router.to(xt.dtype)).to(torch.float32)
    if e_pad > n_experts:
        pad = torch.arange(e_pad, device=xt.device) >= n_experts
        logits = torch.where(pad[None, :],
                             torch.full_like(logits, -1e30), logits)
    gate_vals, gate_idx = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(gate_vals, dim=-1)
    capacity = max(1, int(capacity_factor * top_k * t / e_pad))
    # position of each (token, slot) within its expert, over all K slots
    onehot = F.one_hot(gate_idx, e_pad).to(torch.int32)       # (T, K, E)
    pos_flat = torch.cumsum(onehot.reshape(t * top_k, e_pad), dim=0) - 1
    pos = torch.gather(pos_flat.reshape(t, top_k, e_pad), -1,
                       gate_idx[..., None])[..., 0]
    return Routing(logits, gate_idx, gates, pos, pos < capacity, capacity)


def moe_block(x: torch.Tensor, w: dict, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25, activation: str = "silu",
              weights_stationary: bool = False) -> torch.Tensor:
    """x: (B, S, D). w: router (D, E_pad); we_gate / we_up (E_pad, D, F),
    we_down (E_pad, F, D). Returns (B, S, D)."""
    if weights_stationary:
        raise NotImplementedError(
            "the weights-stationary MoE (expert weights kept sharded over "
            "the data axes while decoding) is part of serving: ROADMAP A21 "
            "(serving)")
    act = activation_fn(activation)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = route(xt, w["router"], top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor)
    e_pad = w["router"].shape[-1]
    safe_p = r.pos.clamp(0, r.capacity - 1)
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    contrib = torch.where(r.keep[..., None], xt[:, None, :], zero)
    buf = torch.zeros((e_pad, r.capacity, d), dtype=xt.dtype,
                      device=xt.device).index_put(
        (r.gate_idx, safe_p), contrib, accumulate=True)       # (E, C, D)
    g = torch.bmm(buf, w["we_gate"].to(xt.dtype))
    u = torch.bmm(buf, w["we_up"].to(xt.dtype))
    out_buf = torch.bmm(act(g) * u, w["we_down"].to(xt.dtype))
    gathered = torch.where(r.keep[..., None], out_buf[r.gate_idx, safe_p],
                           zero)                               # (T, K, D)
    combined = (gathered * r.gates[..., None].to(xt.dtype)).sum(dim=1)
    return combined.reshape(b, s, d)


def moe_aux_loss(logits_f32: torch.Tensor, gate_idx: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss (mean gate prob x mean assignment)."""
    probs = torch.softmax(logits_f32, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], probs.shape[-1]).to(probs.dtype).mean(0)
    return n_experts * torch.sum(me * ce)
