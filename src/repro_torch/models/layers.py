"""Transformer building blocks: RMS norm, RoPE, causal attention, gated MLP.

Counterpart of the dense-training part of ``src/repro/models/layers.py``,
with the reference's numerics: norms and softmax statistics in fp32 and cast
back, attention logits accumulated in fp32 (``preferred_element_type``), the
tanh GELU of ``jax.nn.gelu``, RoPE on split halves, and masking with -1e30.
Under tensor parallelism (``pctx`` with a ``tp_axis`` of T ranks) the
weights are the global, padded ones (``models/transformer.py``): the
column-parallel products run as one GEMM over the global weight, each q
head attends with the K / V head ``kv_heads`` names (the reference's
``kv_select`` / ``kv_map`` of its shard, on the global heads), and the
row-parallel products (``wo``, ``w_down``) are T partial products over the
weights' T row chunks, each rounded to the activation dtype, reduced by
``pctx.reduce_output`` (a psum in rank order, scattered over the sequence
under SP).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .parallel import ParallelCtx


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, *, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S). Rotates the two halves of the
    head dimension (not interleaved pairs), as the reference does."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta=theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 pctx: ParallelCtx) -> torch.Tensor:
    """``x @ w`` with ``w`` row-parallel over the tp ranks: rank t's
    partial product of its chunk of x's last dim and w's rows, rounded to
    x's dtype, ``(T, B, S, D)``, then ``pctx.reduce_output``."""
    t = pctx.tp_size()
    b, s, k = x.shape
    parts = torch.matmul(x.reshape(b * s, t, k // t).transpose(0, 1),
                         w.to(x.dtype).reshape(t, k // t, w.shape[-1]))
    return pctx.reduce_output(parts.view(t, b, s, w.shape[-1]))


def _tp(pctx: ParallelCtx | None) -> bool:
    return pctx is not None and pctx.tp_size() > 1


def attention_train(x: torch.Tensor, w: dict, *, positions: torch.Tensor,
                    rope_theta: float = 10000.0, causal: bool = True,
                    pctx: ParallelCtx | None = None,
                    kv_heads: torch.Tensor | None = None) -> torch.Tensor:
    """Full causal attention for training. x: (B, S, D); w holds wq
    (D, Hq*dh), wk/wv (D, Hkv*dh), wo (Hq*dh, D), ``head_dim`` and
    ``attn_chunk``. Under tensor parallelism ``kv_heads`` (int64 ``(Hq,)``)
    gives each q head's K / V head, and ``wo`` is row-parallel."""
    b, s, _ = x.shape
    dh = w["head_dim"]
    attn_chunk = w.get("attn_chunk", 0)
    if attn_chunk and s > attn_chunk:
        raise NotImplementedError(
            f"seq {s} > attn_chunk {attn_chunk}: chunked (flash-style) "
            "attention is not ported yet: ROADMAP A21")
    q = x @ w["wq"].to(x.dtype)
    k = x @ w["wk"].to(x.dtype)
    v = x @ w["wv"].to(x.dtype)
    hq, hkv = q.shape[-1] // dh, k.shape[-1] // dh
    q = apply_rope(q.reshape(b, s, hq, dh), positions, theta=rope_theta)
    k = apply_rope(k.reshape(b, s, hkv, dh), positions, theta=rope_theta)
    v = v.reshape(b, s, hkv, dh)
    if kv_heads is None:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
    else:
        k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * dh)
    if _tp(pctx):
        return row_parallel(ctx, w["wo"], pctx)
    return ctx @ w["wo"].to(x.dtype)


def activation_fn(activation: str):
    """``silu``, or ``gelu`` in the tanh form of ``jax.nn.gelu``."""
    if activation == "silu":
        return F.silu
    if activation == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def gated_mlp(x: torch.Tensor, w: dict, *, activation: str = "silu",
              pctx: ParallelCtx | None = None) -> torch.Tensor:
    """SwiGLU (or GELU-gated) MLP; under tensor parallelism ``w_gate`` and
    ``w_up`` column-parallel, ``w_down`` row-parallel."""
    act = activation_fn(activation)
    g = x @ w["w_gate"].to(x.dtype)
    u = x @ w["w_up"].to(x.dtype)
    if _tp(pctx):
        return row_parallel(act(g) * u, w["w_down"], pctx)
    return (act(g) * u) @ w["w_down"].to(x.dtype)
