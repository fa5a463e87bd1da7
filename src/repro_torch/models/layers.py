"""Transformer building blocks: RMS norm, layer norm, RoPE, causal attention
(training, prefill and one-token decode against a KV cache), gated MLP.

Counterpart of ``src/repro/models/layers.py``,
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
under SP). Over ranks (``pctx.over_ranks()``) the weights are this rank's
shards: its ``Hq/T`` padded q heads against its slices of ``wq``, ``wk``
and ``wv`` (``kv_heads`` then names its local K / V head of each of its q
heads), its column chunks of ``w_gate`` and ``w_up``, one partial product
of its rows of ``wo`` and ``w_down`` before the sum over the tp group; the
replicated input of the column-parallel products goes through
``pctx.copy_act`` (``copy_tp``; under SP the sequence gather before it is
the "f" already), and ``wk`` and ``wv`` through ``pctx.copy_tp`` where
they are replicated over tp (``kv_shared``): each rank's gradient of them
is its own q heads' part.

The KV cache holds the post-RoPE K and V before any expansion to the q
heads, ``(B, S, H_cache, dh)``; under tensor parallelism it is the global
cache of every rank's heads (``cache_heads`` names the K / V projection
head of each cache head when a rank keeps one head of a replicated
projection, the reference's ``kv_select``), and ``kv_map`` gives each q head
its cache head. ``attention_decode`` writes the new token's K and V at
``pos`` in place and attends over the whole cache with positions past
``pos`` masked to -1e30: fp32 logits from the activation-dtype operands, a
softmax cast back to the activation dtype, its product with V in that dtype.
With ``seq_shards`` P (a batch too small to shard, the reference's
flash-decoding split) the cache's sequence is P contiguous slices, one a
data peer: each peer's local max, the ``pmax`` over peers, fp32 numerators
and denominators ``psum``'d over peers (``pctx.psum_dp``), then one divide,
as the reference's sharded form rounds.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .parallel import ParallelCtx


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-5) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(acc)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``layer_norm``: mean and (biased) variance over the
    last axis in fp32, then scale and bias, cast back."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = xf.mean(dim=-1, keepdim=True)
    centered = xf - mu
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * scale.to(acc) + bias.to(acc)).to(x.dtype)


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


class KVCache(NamedTuple):
    """Decode-time cache. k / v: (B, S_max, H_cache, dh); stacked over a
    period position's repeats in the decode state."""
    k: torch.Tensor
    v: torch.Tensor


def _map_kv(k: torch.Tensor, hq: int, kv_map: torch.Tensor | None
            ) -> torch.Tensor:
    """Expand the cache heads to the q heads: ``kv_map`` (int64 ``(Hq,)``)
    gives each q head its cache head; None is the contiguous GQA
    grouping."""
    if kv_map is None:
        return _repeat_kv(k, hq // k.shape[2])
    return k.index_select(2, kv_map)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float,
                             chunk: int) -> torch.Tensor:
    """Flash-style causal attention over ``chunk``-long blocks with an
    online softmax, the (S, S) logits never whole (the reference's
    ``_chunked_causal_attention``, what a 32k prefill needs). q, k, v:
    ``(B, S, H, dh)``, the K / V heads already expanded to the q heads.
    Products as in the dense path: fp32 logits from q and k, ``p`` cast to
    V's dtype for the PV product, a running ``(o, m, l)`` in fp32.

    Query block i visits key blocks 0..i only. The reference visits all of
    them, but a block above the diagonal is masked whole: its logits are
    all -1e30, so ``m`` stays (block 0 holds the diagonal, so ``m`` is
    finite by then), ``p = exp(-1e30 - m)`` is 0, ``corr = exp(0)`` is 1,
    and ``l * 1 + 0 = l`` and ``o * 1 + 0 = o`` exactly whenever V is
    finite: skipping those blocks gives the same bits."""
    b, s, h, dh = q.shape
    if s % chunk:
        raise ValueError(
            f"chunked attention needs the sequence ({s}) to be a multiple "
            f"of attn_chunk ({chunk}); the reference fails reshaping it "
            "into blocks")
    idx = torch.arange(chunk, device=q.device)
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    outs = []
    for i in range(s // chunk):
        qi = qf[:, i * chunk:(i + 1) * chunk]
        o = torch.zeros((b, chunk, h, dh), dtype=torch.float32,
                        device=q.device)
        m = torch.full((b, h, chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l_sum = torch.zeros((b, h, chunk), dtype=torch.float32,
                            device=q.device)
        for j in range(i + 1):
            kj = kf[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            sc = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            if j == i:                     # the diagonal block
                mask = idx[:, None] >= idx[None, :]
                sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype),
                              vj).to(torch.float32)
            o = o * corr.transpose(1, 2)[..., None] + pv
            m = m_new
        outs.append(o / torch.clamp(l_sum.transpose(1, 2)[..., None],
                                    min=1e-30))
    return torch.cat(outs, dim=1).to(q.dtype)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 pctx: ParallelCtx) -> torch.Tensor:
    """``x @ w`` with ``w`` row-parallel over the tp ranks: rank t's
    partial product of its chunk of x's last dim and w's rows, rounded to
    x's dtype, ``(T, B, S, D)``, then ``pctx.reduce_output`` (over ranks
    ``x`` and ``w`` are the rank's chunks, its one partial product)."""
    t = pctx.tp_rows()
    b, s, k = x.shape
    parts = torch.matmul(x.reshape(b * s, t, k // t).transpose(0, 1),
                         w.to(x.dtype).reshape(t, k // t, w.shape[-1]))
    return pctx.reduce_output(parts.view(t, b, s, w.shape[-1]))


def _tp(pctx: ParallelCtx | None) -> bool:
    return pctx is not None and pctx.tp_size() > 1


def attention_train(x: torch.Tensor, w: dict, *, positions: torch.Tensor,
                    rope_theta: float = 10000.0, causal: bool = True,
                    pctx: ParallelCtx | None = None,
                    kv_heads: torch.Tensor | None = None,
                    cache_heads: torch.Tensor | None = None,
                    collect_kv: bool = False, kv_shared: bool = False):
    """Full causal attention for training and prefill. x: (B, S, D); w
    holds wq (D, Hq*dh), wk/wv (D, Hkv*dh), wo (Hq*dh, D), ``head_dim`` and
    ``attn_chunk``. Under tensor parallelism ``kv_heads`` (int64 ``(Hq,)``)
    gives each q head's K / V head, and ``wo`` is row-parallel; over ranks
    ``kv_shared`` says ``wk`` and ``wv`` are replicated over tp. With
    ``collect_kv`` also returns the post-RoPE ``KVCache`` before expansion
    (the heads ``cache_heads`` selects, when given)."""
    b, s, _ = x.shape
    dh = w["head_dim"]
    attn_chunk = w.get("attn_chunk", 0)
    wk, wv = w["wk"], w["wv"]
    if pctx is not None:
        x = pctx.copy_act(x)
        if kv_shared:
            wk, wv = pctx.copy_tp(wk), pctx.copy_tp(wv)
    q = x @ w["wq"].to(x.dtype)
    k = x @ wk.to(x.dtype)
    v = x @ wv.to(x.dtype)
    hq, hkv = q.shape[-1] // dh, k.shape[-1] // dh
    q = apply_rope(q.reshape(b, s, hq, dh), positions, theta=rope_theta)
    k = apply_rope(k.reshape(b, s, hkv, dh), positions, theta=rope_theta)
    v = v.reshape(b, s, hkv, dh)
    cache = None
    if collect_kv:
        cache = (KVCache(k, v) if cache_heads is None else
                 KVCache(k.index_select(2, cache_heads),
                         v.index_select(2, cache_heads)))
    if kv_heads is None:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
    else:
        k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
    scale = 1.0 / math.sqrt(dh)
    if attn_chunk and s > attn_chunk:
        # causal whatever ``causal`` says, as in the reference
        ctx = chunked_causal_attention(q, k, v, scale=scale,
                                       chunk=attn_chunk)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                              k.to(torch.float32)) * scale
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=x.device).tril()
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    ctx = ctx.reshape(b, s, hq * dh)
    out = (row_parallel(ctx, w["wo"], pctx) if _tp(pctx)
           else ctx @ w["wo"].to(x.dtype))
    return (out, cache) if collect_kv else out


def attention_decode(x: torch.Tensor, w: dict, cache: KVCache, *,
                     pos: torch.Tensor, rope_theta: float = 10000.0,
                     pctx: ParallelCtx | None = None,
                     kv_map: torch.Tensor | None = None,
                     cache_heads: torch.Tensor | None = None,
                     seq_shards: int = 1) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against a KV cache. x: (B, 1, D); ``pos``: a
    one-element int64 tensor, the token's position. Writes the token's K
    and V into ``cache`` at ``pos`` (in place) and returns ``(out,
    cache)``. ``seq_shards`` P > 1: the cache's sequence is P slices of
    S/P, one a data peer of ``pctx``, merged with partial-softmax
    statistics."""
    b = x.shape[0]
    dh = w["head_dim"]
    q = x @ w["wq"].to(x.dtype)
    k_new = x @ w["wk"].to(x.dtype)
    v_new = x @ w["wv"].to(x.dtype)
    hq, hkv = q.shape[-1] // dh, k_new.shape[-1] // dh
    posb = pos.reshape(1, 1).expand(b, 1)
    q = apply_rope(q.reshape(b, 1, hq, dh), posb, theta=rope_theta)
    k_new = apply_rope(k_new.reshape(b, 1, hkv, dh), posb, theta=rope_theta)
    v_new = v_new.reshape(b, 1, hkv, dh)
    if cache_heads is not None:
        k_new = k_new.index_select(2, cache_heads)
        v_new = v_new.index_select(2, cache_heads)
    # the peer that owns pos writes it: on the global cache, position pos
    cache.k.index_copy_(1, pos, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, pos, v_new.to(cache.v.dtype))
    s = cache.k.shape[1]
    kk = _map_kv(cache.k, hq, kv_map)
    vv = _map_kv(cache.v, hq, kv_map)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kk.to(torch.float32)) * scale       # (B, H, 1, S)
    valid = torch.arange(s, device=x.device) <= pos
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    if seq_shards == 1:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        # a cache narrower than the activations is promoted, as in jnp
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, vv.to(x.dtype))
    else:
        # partial softmax merge across the sequence shards: (P, B, H, 1,
        # S/P) and (P, B, S/P, H, dh) stacks of the peers' slices
        n = seq_shards
        lg = logits.reshape(b, hq, 1, n, s // n).movedim(3, 0)
        m = pctx.pmax_dp(lg.amax(dim=-1, keepdim=True))
        p = torch.exp(lg - m)
        vs = vv.reshape(b, n, s // n, hq, dh).movedim(1, 0)
        num = torch.einsum("pbhqk,pbkhd->pbqhd", p, vs.to(torch.float32))
        den = p.sum(dim=-1)                                  # (P, B, H, 1)
        num = pctx.psum_dp(num)[0]
        den = pctx.psum_dp(den)[0]
        ctx = (num / den.transpose(1, 2)[..., None]).to(x.dtype)
    ctx = ctx.reshape(b, 1, hq * dh)
    out = (row_parallel(ctx, w["wo"], pctx) if _tp(pctx)
           else ctx @ w["wo"].to(x.dtype))
    return out, cache


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
    if pctx is not None:
        x = pctx.copy_act(x)
    g = x @ w["w_gate"].to(x.dtype)
    u = x @ w["w_up"].to(x.dtype)
    if _tp(pctx):
        return row_parallel(act(g) * u, w["w_down"], pctx)
    return (act(g) * u) @ w["w_down"].to(x.dtype)
