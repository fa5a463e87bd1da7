"""Layered gradient-loss recovery beyond zero-fill (DESIGN §8).

Counterpart of ``src/repro/core/recovery.py``. The compensated masked mean
(core/tar.py) renormalizes over the senders that arrived, but a wire span no
sender delivered is zero-filled, and under bursty loss (core/drops.py
``pattern="burst"``) whole runs of packets share that fate. Three layered
mechanisms recover the lost mass; ``recovery="none"`` leaves the resolved
spec untouched:

  1. **Stale fill** (:class:`StaleFill`, ``recovery="stale"``): every lost
     (sender, span) wire entry is filled with the previous step's decoded
     bucket, re-encoded under this step's sign, and the reduce takes the
     plain mean over all N senders. The cache rides ``sync_packed(...,
     stale=...)`` and the codec's ``Encoded.stale`` slot through the stages.
  2. **Error feedback** (``recovery="ef"``; implies stale): each peer
     carries the gap between its contribution and what the fill applied in
     its stead (:func:`ef_residual`) into the next step's encode.
  3. **Loss budget** (``recovery="ef+budget"``): the launcher's phase-aware
     :class:`repro_torch.core.ubt.LossBudget` on the control plane.

Peer axis: the stale cache is one ``(B, E)`` copy every peer shares (the
synced arena is the same on every peer), encoded once as a ``(1, L)`` row
per bucket, as the Hadamard sign is one copy. The error-feedback state is
``(P, B, E)``, one residual per peer; :func:`ef_residual_arena` makes one
encode and one decode a bucket for all P peers. The senders' arrival masks
are redrawn through the step's :class:`Draws` provider, whose masks are a
pure function of (key, bucket, receiver), so the redraw equals the
exchange's draw.

Scope, as in the reference: a linear codec (Identity or Hadamard) and full
participation; quantizing codecs and ``active_peers`` are rejected.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import tar as tar_lib
from .hadamard import ht_decode, ht_encode

MODES = ("none", "stale", "ef", "ef+budget")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Parsed ``cfg.recovery`` knob: which mechanisms are armed."""
    mode: str = "none"

    @property
    def stale(self) -> bool:          # layered: ef implies stale
        return self.mode in ("stale", "ef", "ef+budget")

    @property
    def ef(self) -> bool:
        return self.mode in ("ef", "ef+budget")

    @property
    def budget(self) -> bool:
        return self.mode == "ef+budget"

    @property
    def any(self) -> bool:
        return self.mode != "none"


def parse(mode: str) -> RecoveryPolicy:
    if mode not in MODES:
        raise ValueError(f"unknown recovery mode {mode!r}; one of {MODES}")
    return RecoveryPolicy(mode)


# ------------------------------------------- mechanism 1: stale-value fill
@dataclasses.dataclass(frozen=True)
class StaleFill:
    """Codec wrapper: lost wire entries are predicted from the previous
    step's decoded bucket (``ctx.stale``), re-encoded under this step's sign.

    Every entry, arrived or filled, then weighs exactly 1/N, which makes the
    error-feedback split exact. Every hook but ``encode`` and ``reduce``
    delegates to ``inner``; with no stale cache or no mask the output is the
    inner codec's, bit for bit.
    """
    inner: object

    @property
    def linear(self) -> bool:
        return self.inner.linear

    def block(self, cfg) -> int:
        return self.inner.block(cfg)

    def encode(self, x, ctx):
        enc = self.inner.encode(x, ctx)
        if ctx.stale is None:
            return enc
        stale = ctx.stale.to(x.dtype)
        pad = x.shape[-1] - stale.shape[-1]
        if pad < 0:
            raise ValueError(f"stale cache ({stale.shape[-1]}) longer than "
                             f"the padded bucket ({x.shape[-1]})")
        if pad:
            stale = F.pad(stale, (0, pad))
        # one (1, L) row: every peer holds the same cache
        return dataclasses.replace(
            enc, stale=self.inner.encode(stale.reshape(1, -1), ctx).data)

    def reduce(self, received, mask, enc, ctx, shard_index=None):
        if mask is None or enc.stale is None:
            return self.inner.reduce(received, mask, enc, ctx,
                                     shard_index=shard_index)
        s = received.shape[-1]
        rows = enc.stale.reshape(-1, s)            # shard j in row j
        stale_shard = (rows[:received.shape[0]] if shard_index is None
                       else rows[shard_index]).to(received.dtype)
        # the reference's arithmetic, not torch.where: a non-finite stale
        # entry gives NaN where 0 * inf does
        filled = mask * received + (1.0 - mask) * stale_shard[:, None, :]
        ctx.stats["filled"] = ctx.stats.get("filled", 0.0) + \
            torch.sum(1.0 - mask)
        # plain mean over all N: the EF split relies on weight 1/N
        return self.inner.reduce(filled, None, enc, ctx,
                                 shard_index=shard_index)

    def encode_shard(self, own, enc, ctx, shard_index=None):
        return self.inner.encode_shard(own, enc, ctx, shard_index=shard_index)

    def decode_gathered(self, gathered, enc, ctx):
        return self.inner.decode_gathered(gathered, enc, ctx)

    def decode_values(self, vals, enc, ctx):
        return self.inner.decode_values(vals, enc, ctx)


def wrap_codec(codec, cfg):
    """Fold ``cfg.recovery`` into a strategy's codec: unchanged for
    ``"none"``, else :class:`StaleFill` after the preconditions."""
    pol = parse(cfg.recovery)
    if not pol.stale:
        return codec
    if not codec.linear:
        raise ValueError(
            f"recovery={cfg.recovery!r} needs a linear codec (Identity/"
            f"Hadamard); {type(codec).__name__} codes are not linearly "
            "decodable")
    if cfg.active_peers is not None:
        raise ValueError(
            "recovery does not compose with degraded participation "
            "(the residual/stale reconstruction assumes the full sender "
            "set); clear active_peers or set recovery='none'")
    return StaleFill(inner=codec)


# --------------------------------------- mechanism 2: error feedback (EF)
def sender_arrival_masks(draws, bucket: int, n: int, s: int) -> torch.Tensor:
    """``(n, n*s)`` sender-major arrival matrix for one bucket's stage 1:
    row i concatenates, over owners j, sender i's arrival mask at receiver
    j, each receiver's mask redrawn as the exchange draws it (the
    reference's ``fold_in(key, j)``, own row forced)."""
    from .pipeline import draw_masks
    masks = draw_masks(draws, [(bucket, j, j) for j in range(n)], n,
                       s)                              # (owner, sender, s)
    return masks.transpose(0, 1).reshape(n, n * s)


def ef_residual(bucket: torch.Tensor, ctx, n: int, me,
                stale: torch.Tensor | None = None) -> torch.Tensor:
    """Peers ``me``'s undelivered gradient mass for one bucket.

    ``bucket`` ``(R, L)``: row r is peer ``me[r]``'s contribution (gradient
    plus carried residual); ``ctx`` is the bucket's context (its draws and
    sign); ``stale`` ``(L,)`` the prediction the receivers substituted for
    lost entries. Returns ``decode((1 - arrival_me) * (encode(bucket) -
    encode(stale)))``, so ``decode(m*w + (1-m)*w_stale) + residual ==
    bucket``. One encode and one decode for all R rows.
    """
    cfg = ctx.cfg
    if cfg.drop_rate <= 0.0:
        return torch.zeros_like(bucket)
    basis = bucket if stale is None else bucket - stale.to(bucket.dtype)
    block = cfg.hadamard_block if cfg.use_hadamard else 1
    x, length = tar_lib.pad_for_tar(basis, n, block)
    s = x.shape[-1] // n
    arrival = sender_arrival_masks(ctx.draws, ctx.bucket, n, s)
    rows = me if isinstance(me, int) else list(me)
    mine = arrival[torch.as_tensor(rows, device=arrival.device)]
    if cfg.use_hadamard:
        sign = ctx.sign(block)
        w = ht_encode(x, sign, block=block)
        resid = ht_decode((1.0 - mine) * w, sign, block=block)
    else:
        resid = (1.0 - mine) * x
    return resid[..., :length].to(bucket.dtype)


def ef_residual_arena(arena: torch.Tensor, ctx,
                      stale: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`ef_residual` over a packed ``(P, B, E)`` arena, every peer
    ``p`` taking row ``p`` of each bucket's arrival matrix; bucket b draws
    under ``ctx.for_bucket(b)`` as the sync engine does. ``stale`` is the
    ``(B, E)`` cache the fill consumed this step (pre-update). Returns a
    new ``(P, B, E)`` tensor."""
    peers = arena.shape[0]
    out = torch.empty_like(arena)
    for b in range(arena.shape[1]):
        out[:, b] = ef_residual(arena[:, b], ctx.for_bucket(b), peers,
                                range(peers),
                                stale=None if stale is None else stale[b])
    return out


def init_state(policy: RecoveryPolicy, nbuckets: int, bucket_elems: int,
               peers: int = 1, *,
               device: torch.device | str = "cpu") -> dict:
    """Zero recovery state as the trainer threads it: ``stale`` ``(B, E)``
    fp32, one copy (every peer decodes the same buckets), and ``ef``
    ``(P, B, E)`` fp32, one residual per peer. A zero cache makes step 0
    behave as zero-fill."""
    state = {}
    if policy.stale:
        state["stale"] = torch.zeros((nbuckets, bucket_elems),
                                     dtype=torch.float32, device=device)
    if policy.ef:
        state["ef"] = torch.zeros((peers, nbuckets, bucket_elems),
                                  dtype=torch.float32, device=device)
    return state
