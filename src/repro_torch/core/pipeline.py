"""Composable collective pipeline: Topology × Transport × Codec (DESIGN §3).

Counterpart of ``src/repro/core/pipeline.py``: every gradient-sync strategy
is a :class:`CollectiveSpec` composing a Topology (:class:`TarTopology`
with the all_to_all or the paper's round schedule, :class:`RingTopology`
for the ring / tree / BCube baselines, :class:`PsumTopology`), a Transport
(:class:`Reliable`, :class:`Lossy`, :class:`AdaptiveTransport`) and a
Codec (:class:`Identity`, :class:`Hadamard`, :class:`HTQuant`). A strategy
name resolves through the registry, every name of the reference among them.
The participation policies (``active_peers``, ``shard_weights``,
``dead_links``, on the data axis) and the loss-recovery codec
(``cfg.recovery``, core/recovery.py) run as in the reference, and so does
:class:`WireTransport`, whose masks are observed on a host wire
(``repro_torch/net``).

The reference runs one rank per device inside ``shard_map``; here every
stage works on ``(P, ...)`` stacks over the peer grid
(``core/collectives.py``), so one kernel launch serves all P peers of a
bucket. With a pod axis (``cfg.pod_axis`` and ``SyncContext.grid.pods`` =
G > 1) the P = G * N peers are pod-major and the schedules run over the data
axis in every pod at once; a TAR topology joins the pods between its two
stages (``outer``: the hierarchical 2D TAR of §3.1.2, or a pmean), a ring
folds them with a pmean after its own reduce, psum averages over both axes.
With T tensor-parallel groups (``SyncContext.grid.tp``) P = T * G * N,
model-major: every tp group syncs its own peers in the same call (one
kernel launch a bucket for all of them), and the groups never mix.
:meth:`CollectiveSpec.reduce_scatter` is TAR stage 1 on one tensor over one
axis, the FSDP gradient reduction (``core/allreduce.reduce_scatter_axis``).
The randomness the reference draws from keys inside the stages (the
Hadamard sign, each receiver's arrival mask, the quantizer's
stochastic-rounding noise) comes from the context's :class:`Draws` provider:
:class:`ThreefryDraws` gives the reference's own bits, and a test can hand
in others.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, ClassVar, Protocol

import torch
import torch.nn.functional as F

from . import collectives
from . import drops as drops_lib
from . import ring as ring_lib
from . import tar as tar_lib
from repro_torch.kernels.dequant_reduce import dequant_masked_mean
from repro_torch.kernels.quant import grid_quant

from .hadamard import (ht_decode, ht_encode, ht_encode_amax, ht_encode_quant,
                       rademacher_signs)
from . import keys as keys_lib
from .keys import Key, fold_in
from .ubt import UbtState


# ------------------------------------------------------------- configuration
@dataclasses.dataclass(frozen=True)
class OptiReduceConfig:
    """Static configuration for gradient sync: the reference's fields."""
    strategy: str = "optireduce"
    data_axis: str = "data"
    pod_axis: str | None = None
    # UBT drop model (stand-in for timeouts/loss on a lossy fabric)
    drop_rate: float = 0.0
    drop_pattern: str = "tail"           # bernoulli | tail | straggler | burst
    packet_elems: int = 256
    # Hadamard transform
    use_hadamard: bool = True
    hadamard_block: int = 4096
    # the reference picks Pallas or jnp with this; the port always launches
    # the kernel on a CUDA tensor, and True additionally demands one (a CPU
    # tensor raises, as kernel mode 'kernel' does)
    use_kernels: bool = False
    skip_threshold: float = 0.10
    # round-form incast (rounds schedules only; the a2a schedule ignores it)
    incast: int = 1
    quant_bits: int = 8
    rs_wire_bits: int = 0
    # degraded participation (DESIGN §5): the active peers (None or the full
    # set: everyone); ejected peers' contributions are excluded and they
    # still receive the result
    active_peers: tuple[int, ...] | None = None
    # straggler-proportional shard units per active peer (DESIGN §10; None
    # or uniform: equal shards); rounds-scheduled TAR and the ring only
    shard_weights: tuple[int, ...] | None = None
    # dead directed (src, dst) edges: the rounds relay around them, the ring
    # reorders itself (DESIGN §10)
    dead_links: tuple[tuple[int, int], ...] = ()
    recovery: str = "none"

    def check(self) -> None:
        if self.drop_pattern not in ("bernoulli", "tail", "straggler",
                                     "burst"):
            raise ValueError(f"unknown drop pattern {self.drop_pattern!r}")


# A draw's site: a bucket index b of the step's sync key (the reference's
# fold_in(sync_key, b)), or a key path below the step key naming one FSDP
# gather site (``()``: the step key itself, ``(l,)``: fold_in(step_key, l)).
Site = int | tuple[int, ...]


class Draws(Protocol):
    """Where a sync step's random operands come from. ``bucket`` names the
    draw's :data:`Site`; the reference keys every draw of a site on the
    site's key alone, never on a pod index, so every pod draws the same."""

    def sign(self, bucket: Site, block: int) -> torch.Tensor:
        """The site's Hadamard sign, ``(block,)`` fp32 of +-1."""

    def mask(self, bucket: Site, receiver: int, n: int, s: int,
             self_index: int | None = None) -> torch.Tensor:
        """Receiver's ``(n, s)`` fp32 arrival mask for the site's stage-1
        exchange, drawn under the receiver's data-axis id; row
        ``self_index`` (the receiver's own, unless a degraded round
        schedule indexes rows by virtual position) all ones."""

    def noise(self, bucket: Site, salt: int,
              shape: tuple[int, ...]) -> torch.Tensor:
        """Uniform [0, 1) fp32 stochastic-rounding noise of the site's
        quantizer ``salt`` (3: stage 1, 4: stage 2, 9: the FSDP
        reduce-scatter), one copy shared by every peer."""


@dataclasses.dataclass(frozen=True)
class ThreefryDraws:
    """The default provider: the reference's own draws, bit for bit
    (``core/keys.py``). The sign is ``bernoulli(site_key, 0.5, (block,))``
    (``fold_in(key, b)`` for bucket b, ``key`` folded with each element of
    a path), a receiver's mask comes from ``fold_in(site_key, receiver)``,
    a quantizer's noise is ``uniform(fold_in(site_key, salt), shape)``.
    ``key`` is the step's sync key for bucket draws, the step key for FSDP
    gather sites. The batched forms (:meth:`signs`, :meth:`masks`,
    :meth:`noises`) draw many sites or receivers in one kernel launch on
    the card. A site's sign is drawn once and kept (the encode and the
    decode of a bucket read the same one); a provider serves one step."""
    key: Key
    cfg: OptiReduceConfig
    device: torch.device
    _signs: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def _site(self, bucket: Site) -> Key:
        path = bucket if isinstance(bucket, tuple) else (bucket,)
        k = self.key
        for d in path:
            k = fold_in(k, d)
        return k

    def signs(self, buckets, block: int) -> torch.Tensor:
        buckets = list(buckets)
        new = [b for b in dict.fromkeys(buckets)
               if (b, block) not in self._signs]
        if new:
            drawn = rademacher_signs([self._site(b) for b in new], block,
                                     self.device)
            self._signs.update({(b, block): row
                                for b, row in zip(new, drawn)})
        if len(buckets) == 1:
            return self._signs[buckets[0], block][None]
        return torch.stack([self._signs[b, block] for b in buckets])

    def sign(self, bucket: Site, block: int) -> torch.Tensor:
        return self.signs([bucket], block)[0]

    def masks(self, rows, n: int, s: int) -> torch.Tensor:
        """``(K, n, s)``: one mask a ``(bucket, receiver, self_index)``
        row."""
        return drops_lib.make_masks(
            self.cfg.drop_pattern,
            [fold_in(self._site(b), r) for b, r, _ in rows], n, s,
            rate=self.cfg.drop_rate, packet_elems=self.cfg.packet_elems,
            self_index=[i for _, _, i in rows], device=self.device)

    def mask(self, bucket: Site, receiver: int, n: int, s: int,
             self_index: int | None = None) -> torch.Tensor:
        return self.masks([(bucket, receiver, receiver if self_index is None
                            else self_index)], n, s)[0]

    def noises(self, buckets, salt: int,
               shape: tuple[int, ...]) -> torch.Tensor:
        return keys_lib.uniform_batch(
            [fold_in(self._site(b), salt) for b in buckets],
            math.prod(shape), self.device).view(-1, *shape)

    def noise(self, bucket: Site, salt: int,
              shape: tuple[int, ...]) -> torch.Tensor:
        return self.noises([bucket], salt, shape)[0]


@dataclasses.dataclass(frozen=True)
class KeyedDraws(ThreefryDraws):
    """:class:`ThreefryDraws` keyed on ``key`` itself at every site: the
    reference's host peer (``repro/net/peer.py``) keys a step's sign, masks
    and noise on the step key, no bucket folded in."""

    def _site(self, bucket: Site) -> Key:
        return self.key


def draw_masks(draws: Draws, rows, n: int, s: int) -> torch.Tensor:
    """``(K, n, s)`` arrival masks, one a ``(bucket, receiver,
    self_index)`` row: one batched draw where the provider has one
    (``masks``), else one ``mask`` call a row."""
    many = getattr(draws, "masks", None)
    if many is not None:
        return many(rows, n, s)
    return torch.stack([draws.mask(b, r, n, s) if i == r else
                        draws.mask(b, r, n, s, self_index=i)
                        for b, r, i in rows])


def interleave(t: torch.Tensor, g: int) -> torch.Tensor:
    """``(B, ..., L)`` -> ``(..., B * L)``, ``g``-element runs of the B
    items taken in turn: run k of item b lands at run ``k * B + b``. A
    batched sync lays its B buckets out so, ``g`` being the codec's block:
    every cut a schedule makes at a multiple of ``g`` in one bucket is the
    same cut, at a multiple of ``B * g``, of the interleaved row."""
    b, length = t.shape[0], t.shape[-1]
    mid = t.shape[1:-1]
    return t.reshape(b, *mid, length // g, g).movedim(0, -2).reshape(
        *mid, b * length)


def deinterleave(x: torch.Tensor, b: int, g: int) -> torch.Tensor:
    """The inverse of :func:`interleave`: ``(..., B * L)`` -> ``(B, ...,
    L)``."""
    mid, length = x.shape[:-1], x.shape[-1] // b
    return x.reshape(*mid, length // g, b, g).movedim(-2, 0).reshape(
        b, *mid, length)


def draw_signs(draws: Draws, buckets, block: int) -> torch.Tensor:
    """``(B, block)`` signs of several sites, in one draw where the
    provider batches them (``signs``)."""
    many = getattr(draws, "signs", None)
    if many is not None:
        return many(buckets, block)
    return torch.stack([draws.sign(b, block) for b in buckets])


def draw_noises(draws: Draws, buckets, salt: int,
                shape: tuple[int, ...]) -> torch.Tensor:
    """``(B, *shape)`` noises of several sites, in one draw where the
    provider batches them (``noises``)."""
    many = getattr(draws, "noises", None)
    if many is not None:
        return many(buckets, salt, shape)
    return torch.stack([draws.noise(b, salt, shape) for b in buckets])


@dataclasses.dataclass
class SyncContext:
    """Per-step (and, inside the engine, per-bucket) context. ``stale`` is
    the bucket's previous decoded value ``(L,)``, set by the sync engine
    when a stale-fill recovery codec is armed (None otherwise). ``grid``
    lays out the stacks' P peers (``collectives.Grid``: T tp groups of G
    pods of N, the sizes the reference reads from its mesh).

    ``buckets`` (the batched sync, ``sync_packed(mode='vmap')``) names the
    sites of a stack that holds B buckets interleaved ``interleave``
    elements at a time (:func:`interleave`): the sign is then ``(B,
    block)`` (row i of the blocks takes sign ``i % B``), a noise and each
    receiver's mask are the B sites' own, interleaved the same way, all
    drawn in one batch."""
    cfg: OptiReduceConfig
    draws: Draws
    bucket: Site = 0
    stats: dict = dataclasses.field(default_factory=dict)
    stale: torch.Tensor | None = None
    grid: collectives.Grid = collectives.ONE
    buckets: tuple | None = None
    interleave: int = 1

    def __post_init__(self):
        if self.grid.pods > 1 and self.cfg.pod_axis is None:
            raise ValueError(f"a grid of {self.grid.pods} pods needs "
                             "cfg.pod_axis set")

    def for_bucket(self, bucket: Site,
                   stale: torch.Tensor | None = None) -> "SyncContext":
        """This step's context for one bucket or gather site (stats
        shared)."""
        return SyncContext(cfg=self.cfg, draws=self.draws, bucket=bucket,
                           stats=self.stats, stale=stale, grid=self.grid)

    def for_buckets(self, buckets: tuple, interleave: int,
                    stale: torch.Tensor | None = None) -> "SyncContext":
        """This step's context for a batch of buckets laid out by
        :func:`interleave` in runs of ``interleave`` (stats shared)."""
        return SyncContext(cfg=self.cfg, draws=self.draws, stats=self.stats,
                           stale=stale, grid=self.grid,
                           buckets=tuple(buckets), interleave=interleave)

    @property
    def batch(self) -> int:
        """The buckets a stack holds: 1, or B in a batched sync."""
        return 1 if self.buckets is None else len(self.buckets)

    def data_axes(self):
        """The axes of the data-parallel group, as collective axes: the
        pod axis joins the data axis when one is configured."""
        if self.cfg.pod_axis is not None:
            return collectives.BOTH
        return collectives.DATA

    def sign(self, block: int) -> torch.Tensor:
        if self.buckets is None:
            return self.draws.sign(self.bucket, block)
        return draw_signs(self.draws, self.buckets, block)

    def noise(self, salt: int, shape: tuple[int, ...]) -> torch.Tensor:
        """``shape``: the noise's ``(rows, block)``; in a batched sync the
        rows are the B buckets' own, interleaved row by row."""
        if self.buckets is None:
            return self.draws.noise(self.bucket, salt, shape)
        b = self.batch
        per = draw_noises(self.draws, self.buckets, salt,
                          (shape[0] // b, *shape[1:]))
        return per.transpose(0, 1).reshape(shape)

    def arrival_masks(self, n: int, s: int, own) -> torch.Tensor:
        """``(len(own), n, s)``: receiver r's arrival mask in row r, its own
        row ``own[r]`` kept; in a batched sync each bucket's masks over its
        ``s / B`` entries, interleaved. Over a process group the rank draws
        its own receiver's mask alone, ``(1, n, s)``: its data index's,
        the same in every pod."""
        rows = list(enumerate(own))
        if self.grid.group is not None:
            rows = [rows[self.grid.index_on(collectives.DATA)]]
        if self.buckets is None:
            return draw_masks(self.draws, [(self.bucket, r, i)
                                           for r, i in rows], n, s)
        b = self.batch
        masks = draw_masks(self.draws, [(k, r, i) for k in self.buckets
                                        for r, i in rows], n, s // b)
        return interleave(masks.view(b, len(rows), n, s // b),
                          self.interleave)

    def loss_fraction(self) -> torch.Tensor:
        """Observed entry-loss fraction this step, averaged over receivers
        (the reference's ``pmean`` of dropped/total over ``data_axes()``:
        every pod draws the data axis's masks alike, so the mean over the N
        receivers is the mean over both axes). Over a process group every
        rank's count is gathered over the data group first (each pod's
        counts are alike), so each rank holds the same value."""
        if "total" not in self.stats:
            return torch.zeros(())
        dropped = collectives.gather_peers(self.stats["dropped"], self.grid)
        frac = dropped / max(self.stats["total"], 1.0)
        return frac.mean()


def active_subset(cfg: OptiReduceConfig, n: int) -> tuple[int, ...] | None:
    """The sorted degraded-participation set for an n-peer axis, or None
    when everyone takes part: the full set normalises to None, so a policy
    naming every peer stays on the full-participation trace bitwise."""
    ap = cfg.active_peers
    if ap is None:
        return None
    ap = tuple(sorted({int(p) for p in ap}))
    if not ap:
        raise ValueError("active_peers must name at least one peer")
    if ap[0] < 0 or ap[-1] >= n:
        raise ValueError(f"active_peers {ap} outside the {n}-peer axis")
    return None if len(ap) == n else ap


def weights_subset(cfg: OptiReduceConfig,
                   n_active: int) -> tuple[int, ...] | None:
    """The shard units of an ``n_active``-peer schedule, or None when they
    are uniform (normalised away, as :func:`active_subset` does)."""
    w = cfg.shard_weights
    if w is None:
        return None
    w = tuple(int(u) for u in w)
    if len(w) != n_active:
        raise ValueError(f"shard_weights {w} do not match the "
                         f"{n_active}-peer active set")
    if any(u < 1 for u in w):
        raise ValueError(f"shard_weights must be positive integers, got {w}")
    return None if all(u == w[0] for u in w) else w


def dead_link_set(cfg: OptiReduceConfig,
                  n: int) -> tuple[tuple[int, int], ...]:
    """The dead directed edges, sorted and deduplicated."""
    out = tuple(sorted({(int(s), int(d)) for (s, d) in cfg.dead_links or ()}))
    for (s, d) in out:
        if not (0 <= s < n and 0 <= d < n) or s == d:
            raise ValueError(f"dead link {(s, d)} outside the {n}-peer axis")
    return out


# ------------------------------------------------------------------- codecs
@dataclasses.dataclass
class Encoded:
    """A codec's wire form of one ``(P, L)`` bucket stack: ``data`` is what
    travels (fp32 values or uint8 codes); ``lo`` / ``step`` are a
    quantizing codec's per-Hadamard-block grids, ``(L / block,)``, one copy
    shared by every peer, or ``(T, L / block)``, one copy a tp group (None
    otherwise); ``stale`` is the previous step's
    bucket encoded under this step's sign, ``(1, L)``, the prediction a
    :class:`~repro_torch.core.recovery.StaleFill` codec puts in lost
    entries (None without recovery)."""
    data: torch.Tensor | None
    lo: torch.Tensor | None = None
    step: torch.Tensor | None = None
    stale: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Codec:
    """Identity codec — also the base class defining the codec protocol:
    ``encode`` before stage 1, ``reduce`` the received ``(P, N, S)``
    shards, ``encode_shard`` for stage 2, ``decode_gathered`` after it, and
    ``decode_values`` for a bucket that a topology reduced internally (the
    ring). ``linear`` marks codecs whose decode commutes with averaging, the
    only ones a ring composes with. ``shard_index`` ``(P,)``, where given,
    names the shard each receiver reduces (the virtual position of a
    degraded round schedule); None means receiver r reduces shard r."""
    linear: ClassVar[bool] = True

    def block(self, cfg: OptiReduceConfig) -> int:
        return 1

    def encode(self, x: torch.Tensor, ctx: SyncContext) -> Encoded:
        return Encoded(x)

    def reduce(self, received: torch.Tensor, mask: torch.Tensor | None,
               enc: Encoded, ctx: SyncContext,
               shard_index: torch.Tensor | None = None) -> torch.Tensor:
        return tar_lib.masked_mean(received, mask)

    def encode_shard(self, own: torch.Tensor, enc: Encoded,
                     ctx: SyncContext,
                     shard_index: torch.Tensor | None = None) -> torch.Tensor:
        return own

    def decode_gathered(self, gathered: torch.Tensor, enc: Encoded,
                        ctx: SyncContext) -> torch.Tensor:
        return gathered

    def decode_values(self, vals: torch.Tensor, enc: Encoded,
                      ctx: SyncContext) -> torch.Tensor:
        return vals


class Identity(Codec):
    """Raw wire values: no rotation, no compression."""


class Hadamard(Codec):
    """Blockwise randomized Hadamard transform (§3.3)."""

    def block(self, cfg: OptiReduceConfig) -> int:
        return cfg.hadamard_block

    def encode(self, x, ctx):
        block = ctx.cfg.hadamard_block
        return Encoded(ht_encode(x, ctx.sign(block), block=block))

    def decode_gathered(self, gathered, enc, ctx):
        block = ctx.cfg.hadamard_block
        return ht_decode(gathered, ctx.sign(block), block=block)

    decode_values = decode_gathered


def shared_amax(amax: torch.Tensor, ctx: SyncContext) -> torch.Tensor:
    """The grids' amax shared by the whole data-parallel group: the max of
    every peer's ``(P, L / block)`` over both axes, ``(L / block,)``; with
    T tp groups one row a group, ``(T, L / block)`` (each tp rank's grids
    come from its own data-parallel group, as in the reference)."""
    return ctx.grid.group_rows(collectives.pmax(amax, ctx.grid,
                                                ctx.data_axes()))


@dataclasses.dataclass(frozen=True)
class HTQuant(Codec):
    """Hadamard rotation + THC-style shared-grid uniform stochastic
    quantization (the reference's beyond-paper ``optireduce_q``).

    Per-block ``[-amax_b, amax_b]`` grids are pmax'd over the peers, so every
    peer derives the same grids and the codes are homomorphic. The encode is
    split around that pmax: :meth:`local_amax` (kernel B3: rotate + per-block
    amax, the rotated bucket never written) before it, and
    :meth:`encode_given_amax` (kernel B4: rotate + quantize) after it. The
    receive side dequantizes and takes the compensated mean in one pass
    (kernel B5), the aggregated shard is re-quantized for stage 2 (kernel
    B6), and :meth:`decode_gathered` dequantizes and decodes (kernel B1).
    Both noises are one copy shared by every peer, drawn under
    ``noise_salt`` and ``stage2_salt`` (the reference's ``fold_in(key, 3)``
    and ``fold_in(key, 4)``); the grids are shared by every peer of both
    axes. The code width is ``bits``, or ``cfg.quant_bits`` when None
    (``core.allreduce.rs_spec`` passes ``cfg.rs_wire_bits`` and salt 9).
    Not ``linear``: a ring cannot average its codes.
    """
    bits: int | None = None
    noise_salt: int = 3        # stage-1 stochastic-rounding noise
    stage2_salt: int = 4       # stage-2 (broadcast) noise
    linear = False

    def _bits(self, cfg: OptiReduceConfig) -> int:
        bits = cfg.quant_bits if self.bits is None else self.bits
        if not 1 <= bits <= 8:
            raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
        return bits

    def block(self, cfg: OptiReduceConfig) -> int:
        return cfg.hadamard_block

    @staticmethod
    def _grids(enc: Encoded, nblk: int, shard_index: torch.Tensor | None,
               grid: collectives.Grid) -> tuple[torch.Tensor, torch.Tensor]:
        """Each receiver's slice of the bucket's grids, ``(P, nblk)`` (the
        reference's ``_grids(enc, shard_index, nblk)``, all receivers at
        once): receiver r's is shard r's, or shard ``shard_index[r]``'s
        of its tp group's grids."""
        lo, step = enc.lo.view(-1, nblk), enc.step.view(-1, nblk)
        if shard_index is None:
            return lo, step
        if grid.tp_rows > 1:
            # receiver r of tp group t reads row t * n + shard_index[r]
            shard_index = shard_index + grid.group_offsets(
                shard_index.shape[0], lo.shape[0] // grid.tp_rows,
                shard_index.device)
        return lo[shard_index], step[shard_index]

    def local_amax(self, x: torch.Tensor,
                   ctx: SyncContext) -> tuple[torch.Tensor, torch.Tensor]:
        """Pre-``pmax`` half of :meth:`encode`: ``(x, amax)`` with each
        peer's per-block amax ``(P, L / block)``; x stays un-rotated (the
        quantize kernel rotates again)."""
        block = ctx.cfg.hadamard_block
        return x, ht_encode_amax(x, ctx.sign(block), block=block)

    def encode_given_amax(self, x: torch.Tensor, amax: torch.Tensor,
                          ctx: SyncContext) -> Encoded:
        """Post-``pmax`` half of :meth:`encode`: quantize onto the grids
        derived from the peer-shared ``amax`` ``(L / block,)``."""
        block = ctx.cfg.hadamard_block
        bits = self._bits(ctx.cfg)
        levels = (1 << bits) - 1
        amax = torch.clamp(amax, min=1e-12)
        # a true division on every device: CUDA divides by a Python scalar
        # as a multiply by its reciprocal, one ulp off for some amax
        step = 2.0 * amax / torch.full_like(amax, levels)
        lo = -amax
        noise = ctx.noise(self.noise_salt, (x.shape[-1] // block, block))
        codes = ht_encode_quant(x, ctx.sign(block), noise, lo, step,
                                block=block, bits=bits)
        return Encoded(codes, lo=lo, step=step)

    def encode(self, x, ctx):
        x1, amax = self.local_amax(x, ctx)
        return self.encode_given_amax(x1, shared_amax(amax, ctx), ctx)

    def reduce(self, received, mask, enc, ctx, shard_index=None):
        block = ctx.cfg.hadamard_block
        lo, step = self._grids(enc, received.shape[-1] // block, shard_index,
                               ctx.grid)
        return dequant_masked_mean(received, lo, step, mask, block=block)

    def encode_shard(self, own, enc, ctx, shard_index=None):
        block = ctx.cfg.hadamard_block
        n, s = own.shape
        lo, step = self._grids(enc, s // block, shard_index, ctx.grid)
        noise = ctx.noise(self.stage2_salt, (s // block, block))
        # row i of the (n * s / block) rows reads grid i: receiver r's rows
        # its own shard's grids
        codes = grid_quant(own.reshape(-1, block), noise, lo.reshape(-1),
                           step.reshape(-1), bits=self._bits(ctx.cfg))
        return codes.view(n, s)

    def decode_gathered(self, gathered, enc, ctx):
        block = ctx.cfg.hadamard_block
        shape = gathered.shape
        # each tp group's peers read their group's grids
        groups, nblk = ctx.grid.tp_rows, enc.lo.shape[-1]
        step = enc.step.view(groups, 1, nblk, 1)
        lo = enc.lo.view(groups, 1, nblk, 1)
        vals = (gathered.reshape(groups, -1, nblk, block).to(torch.float32)
                * step + lo).reshape(shape)
        return ht_decode(vals, ctx.sign(block), block=block)

    # a value-domain shard decodes as the rotation alone
    decode_values = Hadamard.decode_values


# --------------------------------------------------------------- transports
class Reliable:
    """Everything arrives (TCP-class transports): no mask, no loss stats.
    ``incast`` is the round schedules' I.

    ``payload``, when the topology can offer it, is the stage-1 wire state:
    the ``(P, n, S)`` shard stack about to be exchanged (row p: what peer p
    sends, one shard a receiver). The synthetic transports ignore it;
    :class:`WireTransport` really sends those bytes over a host wire
    backend and masks by what arrived."""

    def arrival_mask(self, ctx: SyncContext, n: int, s: int,
                     self_index: tuple[int, ...] | None = None,
                     payload: torch.Tensor | None = None
                     ) -> torch.Tensor | None:
        return None

    def incast(self, ctx: SyncContext) -> int:
        return ctx.cfg.incast


class Lossy(Reliable):
    """UBT best-effort delivery: the drop model (core/drops.py) decides each
    receiver's arrivals, ``(n, n, S)`` with the receiver of axis index r in
    row r, and the loss counts feed ``ctx.loss_fraction``. A receiver's
    mask is drawn under its index on the exchange's axis, so over the data
    axis every pod drops the same spans (the reference keys it on
    ``axis_index(axis)``); the topology lays the rows onto the peer grid
    (``collectives.on_grid``). ``self_index``, one entry per receiver,
    names the row each receiver never drops when it is not the receiver's
    id (a degraded round schedule's virtual positions); the draws stay
    keyed on the receiver's id either way."""

    def arrival_mask(self, ctx, n, s, self_index=None, payload=None):
        if ctx.cfg.drop_rate <= 0.0:
            return None
        mask = ctx.arrival_masks(n, s, range(n) if self_index is None
                                 else self_index)
        dropped = (1.0 - mask).sum(dim=(1, 2))
        ctx.stats["dropped"] = ctx.stats.get("dropped", 0.0) + dropped
        ctx.stats["total"] = ctx.stats.get("total", 0.0) + float(n * s)
        return mask


class AdaptiveTransport(Lossy):
    """§3.2 control plane in the sync loop: a :class:`Lossy` transport whose
    next-step recommendations come from the runtime ``ControlPlane`` (the
    UBT controllers plus the straggler detector; ``repro_torch/runtime/``).

    A thin adapter, as in the reference: run a step, call
    ``observe(loss_frac, stage_time=...)``, and when it returns True (the
    policy moved) rebuild or cache-switch the step with ``apply(cfg)``.
    ``launch/train.py --adaptive`` wires the ControlPlane in directly.
    """

    def __init__(self, control=None, use_hadamard: bool | None = None, *,
                 state: UbtState | None = None):
        from repro_torch.runtime import ControlPlane, StragglerDetector
        if control is None:
            if state is None:
                raise ValueError("AdaptiveTransport needs a ControlPlane "
                                 "(or a UbtState via state=)")
            control = ControlPlane(
                state=state,
                detector=StragglerDetector(state.incast.n_nodes))
        self.control = control
        # only an explicit argument overrides the controller's current
        # codec recommendation (a wrapped ControlPlane may already have
        # crossed the activation threshold)
        if use_hadamard is not None:
            self.control.use_hadamard = bool(use_hadamard)

    @classmethod
    def create(cls, n_nodes: int, **kw) -> "AdaptiveTransport":
        from repro_torch.runtime import ControlPlane
        return cls(control=ControlPlane.create(n_nodes=n_nodes, **kw))

    @property
    def state(self) -> UbtState:
        return self.control.state

    @property
    def use_hadamard(self) -> bool:
        return self.control.use_hadamard

    @use_hadamard.setter
    def use_hadamard(self, value: bool) -> None:
        self.control.use_hadamard = bool(value)

    def incast(self, ctx: SyncContext | None = None) -> int:
        return self.control.policy().incast

    def observe(self, loss_frac: float, *, stage_time: float | None = None,
                timed_out: bool = False, peer_stage_times=None) -> bool:
        """Feed one step's observations; True if the recommendation moved."""
        from repro_torch.runtime import StepTelemetry
        return self.control.observe(StepTelemetry(
            step=self.control.steps, loss_frac=float(loss_frac),
            timed_out=timed_out, step_time=stage_time,
            peer_stage_times=(None if peer_stage_times is None
                              else tuple(peer_stage_times))))

    def apply(self, cfg: OptiReduceConfig) -> OptiReduceConfig:
        """Fold the current recommendation into a sync config."""
        return self.control.apply(cfg)


class WireTransport(Lossy):
    """Arrival masks observed from a *real* host wire exchange (DESIGN §7).

    The engine keeps its collectives (they move the authoritative data),
    but each bucket's stage-1 shard stack is also really packetized and
    exchanged between host peers over a ``repro_torch.net`` backend
    (in-memory loopback or localhost UDP). ``bridge`` is
    ``HostRing.bridge_exchange`` or any ``(n, n, S) stack -> (n, n, S)
    mask`` callable: one call a bucket with all n peers' shards, returning
    on the stack's device the fp32 mask observed on the *previous* exchange
    (all-ones on the priming call; bitwise that bucket's own mask when the
    loss schedule ignores the exchange counter, an equal-distribution
    sample otherwise). The bytes cross the wire under the adaptive
    per-round deadline, and the mask — missing, late, duplicated,
    out-of-order packets already resolved — is bit-compatible with a
    ``core/drops.py`` mask; per peer/round stage times, timeout flags and
    received fractions accumulate on the ring for the launcher to drain
    into ``StepTelemetry``. The loss counts are the receivers' ``(n,)``,
    as :class:`Lossy` keeps them.

    Caveats, as in the reference: only stage-1 exchanges of
    full-participation TAR schedules over one data axis offer the payload
    (degraded round schedules exchange over a virtual ring the bridge does
    not model), and the calls must come one a bucket in bucket order
    (``sync_packed``'s scan and pipelined modes).
    """

    def __init__(self, bridge):
        self._bridge = bridge

    def arrival_mask(self, ctx, n, s, self_index=None, payload=None):
        if ctx.buckets is not None:
            raise NotImplementedError(
                "WireTransport exchanges one bucket a call, in bucket order; "
                "a batched (vmap) sync has no per-bucket exchange to bridge")
        if payload is None or self_index is not None:
            raise NotImplementedError(
                "WireTransport needs the stage-1 payload hook of a "
                "full-participation TAR schedule (degraded virtual-ring "
                "rounds are not bridged to the host wire)")
        if tuple(payload.shape[:2]) != (n, n):
            raise NotImplementedError(
                f"the host wire bridges one data axis of {n} peers; got a "
                f"{tuple(payload.shape[:2])} stack (pods or tp groups)")
        mask = self._bridge(payload).to(device=payload.device,
                                        dtype=torch.float32)
        dropped = (1.0 - mask).sum(dim=(1, 2))
        ctx.stats["dropped"] = ctx.stats.get("dropped", 0.0) + dropped
        ctx.stats["total"] = ctx.stats.get("total", 0.0) + float(n * s)
        return mask


# --------------------------------------------------------------- topologies
class Topology:
    """Exchange-schedule protocol, split into three stage callables so the
    engine can skew them across buckets (``sync_packed(mode='pipelined')``):
    ``encode_stage`` (pad + codec encode), ``exchange_stage`` (the
    collectives and the reduce between them) and ``decode_stage`` (codec
    decode + unpad). Stage state is a tuple of tensors (None in a slot
    the codec does not use)."""

    def validate(self, transport: Reliable, codec: Codec) -> None:
        pass

    def pad_units(self, cfg: OptiReduceConfig, n: int) -> int:
        """The units ``encode_stage`` pads a bucket to a multiple of (times
        the codec's block) on an n-peer axis."""
        return 1

    def encode_stage(self, bucket: torch.Tensor, transport: Reliable,
                     codec: Codec, ctx: SyncContext) -> tuple:
        raise NotImplementedError

    def exchange_stage(self, state: tuple, transport: Reliable,
                       codec: Codec, ctx: SyncContext) -> tuple:
        raise NotImplementedError

    def decode_stage(self, state: tuple, length: int, transport: Reliable,
                     codec: Codec, ctx: SyncContext) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce(self, bucket: torch.Tensor, transport: Reliable,
                   codec: Codec, ctx: SyncContext) -> torch.Tensor:
        state = self.encode_stage(bucket, transport, codec, ctx)
        state = self.exchange_stage(state, transport, codec, ctx)
        return self.decode_stage(state, bucket.shape[-1], transport, codec,
                                 ctx)


class PsumTopology(Topology):
    """The native all-reduce: a mean over every peer of both axes."""

    def validate(self, transport, codec):
        if not isinstance(codec, Identity) or isinstance(transport, Lossy):
            raise ValueError("psum bypasses the codec and cannot model "
                             "drops (use a TAR topology)")

    def encode_stage(self, bucket, transport, codec, ctx):
        cfg, n = ctx.cfg, collectives.axis_size(bucket, ctx.grid)
        if active_subset(cfg, n) is not None:
            raise ValueError(
                "psum cannot exclude peers: degraded participation needs a "
                "TAR or ring topology")
        if weights_subset(cfg, n) is not None or dead_link_set(cfg, n):
            raise ValueError(
                "psum cannot rebalance shards or route around links: use a "
                "rounds-scheduled TAR or ring topology")
        return (bucket,)

    def exchange_stage(self, state, transport, codec, ctx):
        return (collectives.pmean(state[0], ctx.grid, ctx.data_axes()),)

    def decode_stage(self, state, length, transport, codec, ctx):
        return state[0]


@dataclasses.dataclass(frozen=True)
class RingTopology(Topology):
    """Baseline schedules that reduce internally: Gloo Ring, recursive
    halving-doubling ("NCCL Tree"), Gloo BCube. They compose with a
    *linear* codec (decode commutes with the internal averaging) and a
    reliable transport; a pod axis is folded in with a pmean."""
    kind: str = "ring"                   # ring | tree | bcube

    def __post_init__(self):
        if self.kind not in ("ring", "tree", "bcube"):
            raise ValueError(f"unknown ring topology kind {self.kind!r}")

    def validate(self, transport, codec):
        if isinstance(transport, Lossy):
            raise ValueError(
                f"{self.kind} reduces in-flight partial sums; the UBT drop "
                "model needs TAR's receive structure (Lossy -> TarTopology)")
        if not codec.linear:
            raise ValueError(
                f"codec {type(codec).__name__} does not commute with "
                f"{self.kind}'s internal reduction")

    def _geometry(self, cfg: OptiReduceConfig, n: int):
        """(active, order, weights): the degraded set, the (possibly
        link-rewired) virtual ring order and the per-position shard weights;
        None, None, None on the uniform full-participation trace. A dead
        (i -> j) edge reorders the virtual ring around it (ring hops are all
        distance 1) instead of ejecting j; weights follow their peer."""
        active = active_subset(cfg, n)
        part = active if active is not None else tuple(range(n))
        weights = weights_subset(cfg, len(part))
        dead = dead_link_set(cfg, n)
        if (active is not None or weights is not None or dead) \
                and self.kind != "ring":
            raise ValueError(
                f"{self.kind} exchanges over a rigid power-of-base "
                "structure; degraded participation, shard weights and dead "
                "links need kind='ring' (or a TAR topology)")
        order = tar_lib.ring_order(part, dead) if dead else part
        if weights is not None and order != part:
            weights = tuple(weights[part.index(p)] for p in order)
        if active is None and order == part and weights is None:
            return None, None, None
        return active, order, weights

    def _pad_n(self, cfg: OptiReduceConfig, n: int) -> int:
        _, order, weights = self._geometry(cfg, n)
        if weights is not None:
            return sum(weights)
        return n if order is None else len(order)

    pad_units = _pad_n

    def encode_stage(self, bucket, transport, codec, ctx):
        n = collectives.axis_size(bucket, ctx.grid)
        x, _ = tar_lib.pad_for_tar(bucket, self._pad_n(ctx.cfg, n),
                                   codec.block(ctx.cfg))
        return (codec.encode(x, ctx).data,)

    def exchange_stage(self, state, transport, codec, ctx):
        (data,) = state
        grid = ctx.grid
        n = collectives.axis_size(data, grid)
        active, order, weights = self._geometry(ctx.cfg, n)
        if order is not None:
            # the virtual ring of active peers in link-avoiding order; the
            # graft replaces the ejected peers' garbage before the pod
            # reduction can see it
            out = ring_lib.ring_allreduce(data, active=order, weights=weights,
                                          grid=grid)
            if active is not None:
                out = tar_lib.graft_inactive(out, active, grid)
        elif self.kind == "ring":
            out = ring_lib.ring_allreduce(data, grid=grid)
        elif self.kind == "tree":
            out = ring_lib.tree_allreduce(data, grid)
        else:
            out = ring_lib.bcube_allreduce(data, base=4 if n % 4 == 0 else 2,
                                           grid=grid)
        if grid.pods > 1:
            out = collectives.pmean(out, grid, collectives.POD)
        return (out,)

    def decode_stage(self, state, length, transport, codec, ctx):
        # the stage-1 encode output is gone by now: data=None says so
        return codec.decode_values(state[0], Encoded(None), ctx)[..., :length]


@dataclasses.dataclass(frozen=True)
class TarTopology(Topology):
    """Transpose AllReduce (§3.1): stage-1 shard exchange -> codec reduce ->
    stage-2 broadcast.

    ``schedule``: ``'a2a'`` runs the stages as ``collectives.all_to_all``
    and ``all_gather`` views; ``'rounds'`` runs the paper's explicit
    2 * ceil((N-1)/I) round schedule of ``collectives.ppermute`` calls,
    taking I from the transport. ``outer`` says how a pod axis joins
    between the stages: ``'tar'`` nests a TAR over the pods (§3.1.2
    hierarchical 2D; a pmean where the shard does not cut into G parts),
    ``'pmean'`` folds them with a plain pmean (what a quantizing codec
    needs: values, not codes, cross the pods).

    Degraded participation (``cfg.active_peers`` a proper subset): the
    rounds schedule is regenerated over the virtual ring of active peers
    (A shards, 2(A-1) rounds, ejected peers self-loop) plus ceil(E/A) graft
    rounds to the ejected peers; the a2a schedule keeps its N shards and
    zeroes ejected senders' rows of the arrival mask at every receiver.
    Either way the result is the mean over active contributions, and every
    peer, ejected or not, holds it.
    """
    schedule: str = "a2a"                # a2a | rounds
    outer: str = "tar"                   # tar | pmean

    def __post_init__(self):
        if self.schedule not in ("a2a", "rounds"):
            raise ValueError(f"unknown TAR schedule {self.schedule!r}")
        if self.outer not in ("tar", "pmean"):
            raise ValueError(f"unknown TAR outer mode {self.outer!r}")

    def _outer_reduce(self, own: torch.Tensor,
                      ctx: SyncContext) -> torch.Tensor:
        """Join each data index's G pod replicas of its reduced shard."""
        g = ctx.grid.pods
        if g <= 1:
            return own
        # one bucket's shard decides, as in an unbatched sync
        if self.outer == "tar" and (own.shape[-1] // ctx.batch) % g == 0:
            return tar_lib.tar_allreduce(own, grid=ctx.grid,
                                         axis=collectives.POD)
        return collectives.pmean(own, ctx.grid, collectives.POD)

    def _participation(self, cfg: OptiReduceConfig, n: int):
        """(active, n_shards, weights, dead): the rounds schedule shards
        over the active set (straggler-proportionally under ``weights``)
        and relays around ``dead`` links; a2a keeps N uniform shards and
        excludes by mask."""
        active = active_subset(cfg, n)
        part = active if active is not None else tuple(range(n))
        weights = weights_subset(cfg, len(part))
        dead = dead_link_set(cfg, n)
        if (weights is not None or dead) and self.schedule != "rounds":
            raise ValueError(
                "the a2a TAR schedule can neither resize its tiles nor avoid "
                "an edge: use schedule='rounds' for shard_weights / "
                "dead_links")
        if active is not None and self.schedule == "rounds":
            return active, len(active), weights, dead
        return active, n, weights, dead

    def pad_units(self, cfg: OptiReduceConfig, n: int) -> int:
        _, n_shards, weights, _ = self._participation(cfg, n)
        return n_shards if weights is None else sum(weights)

    @staticmethod
    def _check_weighted(cfg: OptiReduceConfig, codec) -> None:
        if not codec.linear:
            raise ValueError(
                "shard_weights require a linear codec: a quantizing codec "
                "grids the bucket by uniform shard geometry")
        if cfg.recovery != "none":
            raise ValueError(
                "shard_weights are incompatible with gradient recovery: "
                "stale-fill indexes the bucket by uniform shard geometry")

    def encode_stage(self, bucket, transport, codec, ctx):
        cfg = ctx.cfg
        n = collectives.axis_size(bucket, ctx.grid)
        _, n_shards, weights, _ = self._participation(cfg, n)
        if weights is not None:
            self._check_weighted(cfg, codec)
            # pad so the bucket cuts into sum(weights) block-aligned units
            n_shards = sum(weights)
        x, _ = tar_lib.pad_for_tar(bucket, n_shards, codec.block(cfg))
        if hasattr(codec, "local_amax"):
            # split encode (quantizing codec): only the pre-collective half
            # here; the grid pmax and the quantize ride the exchange stage,
            # as in the reference's pipelined schedule (StaleFill never
            # wraps a quantizing codec)
            return (*codec.local_amax(x, ctx), None)
        enc = codec.encode(x, ctx)
        # 3rd slot: the re-encoded stale bucket a recovery codec attaches,
        # carried to this bucket's reduce through the skew
        return (enc.data, None, enc.stale)

    def exchange_stage(self, state, transport, codec, ctx):
        data, amax, stale = state
        cfg = ctx.cfg
        grid = ctx.grid
        lo = step = None
        if amax is not None:
            # deferred half of the split encode: share the grids over the
            # whole group, then quantize
            enc = codec.encode_given_amax(data, shared_amax(amax, ctx), ctx)
            data, lo, step = enc.data, enc.lo, enc.step
        enc = Encoded(data, lo=lo, step=step, stale=stale)
        n = collectives.axis_size(data, grid)
        active, n_shards, weights, dead = self._participation(cfg, n)
        rounds = self.schedule == "rounds"
        if weights is not None:
            self._check_weighted(cfg, codec)
            plan = tar_lib.shard_plan(data.shape[-1], weights,
                                      codec.block(cfg))
            if plan.padded != data.shape[-1]:
                raise ValueError(
                    f"bucket length {data.shape[-1]} not a multiple of "
                    f"sum(shard_weights)={sum(weights)} units")
            shards = tar_lib.weighted_rows(data, plan)
        else:
            plan = None
            shards = data.view(data.shape[0], n_shards, -1)
        s = shards.shape[-1]
        if rounds:
            received = tar_lib.tar_exchange_rounds(
                shards, incast=transport.incast(ctx), active=active,
                dead_links=dead, grid=grid)
        else:
            received = collectives.all_to_all(shards, grid)
        # receiver p reduces shard p (None), or its data index's shard over
        # pods and tp groups, or its virtual position's on a degraded round
        # schedule
        shard_index = (None if grid.blocks == 1 and grid.group is None
                       else collectives.axis_index(data, grid))
        if rounds and active is not None:
            # rows are in virtual-ring order; so are shard ownership and the
            # self row of the drop mask
            vpos, _ = tar_lib.peer_lookup(active, n)
            shard_index = collectives.per_peer(vpos, data.device, grid)
            mask = transport.arrival_mask(ctx, n_shards, s, self_index=vpos)
        else:
            # the stage-1 payload of a uniform schedule (the reference
            # offers none under shard weights)
            mask = transport.arrival_mask(
                ctx, n_shards, s, payload=shards if plan is None else None)
            if active is not None:
                # a2a: exclude ejected senders' rows at EVERY receiver (the
                # ejected peer's own row included, so replicas agree); the
                # compensated mean treats them as dropped
                _, is_active = tar_lib.peer_lookup(active, n)
                rows = collectives.index(tuple(int(v) for v in is_active),
                                         data.device).to(torch.float32)
                rows = rows[:, None]
                mask = rows.expand(n, n, s) if mask is None else mask * rows
        if mask is not None:
            mask = collectives.on_grid(mask, data, grid)
        own = codec.reduce(received, mask, enc, ctx, shard_index=shard_index)
        own = self._outer_reduce(own, ctx)
        wire = codec.encode_shard(own, enc, ctx, shard_index=shard_index)
        if rounds:
            gathered = tar_lib.tar_broadcast_rounds(
                wire, incast=transport.incast(ctx), active=active,
                dead_links=dead, plan=plan, grid=grid)
            if active is not None:
                gathered = tar_lib.graft_inactive(gathered, active, grid)
        else:
            gathered = collectives.all_gather(wire, grid)
        return (gathered, lo, step)         # stale consumed in the reduce

    def decode_stage(self, state, length, transport, codec, ctx):
        # only the quantization grids survive the exchange
        gathered, lo, step = state
        out = codec.decode_gathered(gathered, Encoded(None, lo=lo, step=step),
                                    ctx)
        return out[..., :length]

    def reduce_scatter(self, g: torch.Tensor, axis, dim: int,
                       transport: Reliable, codec: Codec,
                       ctx: SyncContext) -> torch.Tensor:
        """TAR stage 1 + the compensated reduce on one tensor, scattering
        ``dim`` over ``axis`` (``collectives.DATA`` or ``POD``): the FSDP
        gradient reduction, whose deferred stage 2 is the next use's
        gather. ``g``: ``(P, *shape)``, each peer's full tensor; returns
        ``(P, *shard)``, peer p's reduced slice of ``dim`` (its index on
        ``axis``). A Hadamard or quantizing codec rotates in fp32 (the sign
        promotes a bf16 gradient, as jnp does); Identity keeps the wire
        dtype. The caller casts back."""
        cfg, grid, p = ctx.cfg, ctx.grid, g.shape[0]
        n = collectives.axis_size(g, grid, axis)
        active = active_subset(cfg, n)
        part_n = n if active is None else len(active)
        if weights_subset(cfg, part_n) is not None or dead_link_set(cfg, n):
            raise ValueError(
                "reduce_scatter runs as an all_to_all (the FSDP a2a form): "
                "shard_weights / dead_links need the rounds schedule")
        g2 = g.movedim(dim + 1, 1)
        lead, rest = g2.shape[1], g2.shape[2:]
        if lead % n:
            raise ValueError(f"dim {dim} of length {lead} does not split "
                             f"over {n} peers")
        rows = g2.reshape(p, n, -1)                    # row j -> shard j
        row_len = rows.shape[-1]
        pad = (-row_len) % codec.block(cfg)
        if not isinstance(codec, Identity):
            rows = rows.to(torch.float32)
        if pad:
            rows = F.pad(rows, (0, pad))
        enc = codec.encode(rows.reshape(p, -1), ctx)
        shards = enc.data.view(p, n, -1)
        received = collectives.all_to_all(shards, grid, axis)
        s = received.shape[-1]
        mask = transport.arrival_mask(ctx, n, s, payload=shards)
        if active is not None:           # the same a2a exclusion as TAR
            _, is_active = tar_lib.peer_lookup(active, n)
            on = collectives.index(tuple(int(v) for v in is_active),
                                   g.device).to(torch.float32)[:, None]
            mask = on.expand(n, n, s) if mask is None else mask * on
        if mask is not None:
            if grid.group is not None and axis != collectives.DATA:
                # a rank draws its data index's receiver (arrival_masks)
                raise ValueError("over a process group a reduce-scatter "
                                 "models drops on the data axis only")
            mask = collectives.on_grid(mask, g, grid, axis)
        shard_index = (None if n == p
                       else collectives.axis_index(g, grid, axis))
        own = codec.reduce(received, mask, enc, ctx, shard_index=shard_index)
        own = codec.decode_values(own, enc, ctx)[..., :row_len]
        out = own.reshape(p, lead // n, *rest)
        return out.movedim(1, dim + 1)


# ------------------------------------------------------------ spec + registry
@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """One gradient-sync strategy = Topology × Transport × Codec."""
    topology: Topology
    transport: Reliable
    codec: Codec

    def __post_init__(self):
        self.topology.validate(self.transport, self.codec)

    def all_reduce(self, bucket: torch.Tensor,
                   ctx: SyncContext) -> torch.Tensor:
        """Reduce one ``(P, L)`` bucket stack to its (approximate) mean,
        held by every peer."""
        return self.topology.all_reduce(bucket, self.transport, self.codec,
                                        ctx)

    def encode_stage(self, bucket: torch.Tensor, ctx: SyncContext) -> tuple:
        return self.topology.encode_stage(bucket, self.transport, self.codec,
                                          ctx)

    def exchange_stage(self, state: tuple, ctx: SyncContext) -> tuple:
        return self.topology.exchange_stage(state, self.transport,
                                            self.codec, ctx)

    def decode_stage(self, state: tuple, length: int,
                     ctx: SyncContext) -> torch.Tensor:
        return self.topology.decode_stage(state, length, self.transport,
                                          self.codec, ctx)

    def reduce_scatter(self, g: torch.Tensor, axis, dim: int,
                       ctx: SyncContext) -> torch.Tensor:
        """Scatter ``dim`` of each peer's ``(P, *shape)`` tensor over
        ``axis``, returning each peer's reduced shard (the FSDP form)."""
        return self.topology.reduce_scatter(g, axis, dim, self.transport,
                                            self.codec, ctx)


_REGISTRY: dict[str, Callable[[OptiReduceConfig], CollectiveSpec]] = {}


def _recovered(codec: Codec, cfg: OptiReduceConfig):
    """Fold ``cfg.recovery`` into a lossy strategy's codec; ``"none"``
    returns the codec itself, so the spec is the one without recovery."""
    if cfg.recovery == "none":
        return codec
    from . import recovery as recovery_lib
    return recovery_lib.wrap_codec(codec, cfg)


def register_strategy(name: str, spec: CollectiveSpec | None = None):
    """Register a named strategy: a spec instance, or (as a decorator) a
    factory ``cfg -> CollectiveSpec``."""
    if spec is not None:
        _REGISTRY[name] = lambda cfg: spec
        return spec

    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def strategy_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    cfg.check()
    factory = _REGISTRY.get(cfg.strategy)
    if factory is None:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; one of "
                         f"{strategy_names()}")
    return factory(cfg)


register_strategy("psum",
                  CollectiveSpec(PsumTopology(), Reliable(), Identity()))
register_strategy("gloo_ring",
                  CollectiveSpec(RingTopology("ring"), Reliable(), Identity()))
register_strategy("nccl_tree",
                  CollectiveSpec(RingTopology("tree"), Reliable(), Identity()))
register_strategy("bcube",
                  CollectiveSpec(RingTopology("bcube"), Reliable(),
                                 Identity()))
register_strategy("tar_tcp",
                  CollectiveSpec(TarTopology(), Reliable(), Identity()))
register_strategy("tar_rounds",
                  CollectiveSpec(TarTopology(schedule="rounds", outer="pmean"),
                                 Reliable(), Identity()))


@register_strategy("optireduce")
@register_strategy("optireduce_2d")   # cfg.pod_axis drives the 2D path
def _optireduce_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    codec = Hadamard() if cfg.use_hadamard else Identity()
    return CollectiveSpec(TarTopology(), Lossy(), _recovered(codec, cfg))


# The next three are factories, as in the reference, though their specs
# ignore the config: the launcher's --adaptive tests whether a codec flip
# matters by the identity of the two resolved specs, and a factory answers
# "it does" as the reference's does (ROADMAP C).
@register_strategy("optireduce_q")
def _optireduce_q_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    """The quantized exchange: TAR x Lossy x HTQuant; values, not codes,
    cross the pods."""
    # _recovered rejects recovery over quantized codes
    return CollectiveSpec(TarTopology(outer="pmean"), Lossy(),
                          _recovered(HTQuant(), cfg))


@register_strategy("optireduce_rounds")
def _optireduce_rounds_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    """The paper's round schedule with drops and the rotation."""
    return CollectiveSpec(TarTopology(schedule="rounds", outer="pmean"),
                          Lossy(), _recovered(Hadamard(), cfg))


@register_strategy("tar_rounds_q")
def _tar_rounds_q_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    """The round schedule with the quantized exchange."""
    return CollectiveSpec(TarTopology(schedule="rounds", outer="pmean"),
                          Lossy(), _recovered(HTQuant(), cfg))


# Gloo's ring over rotated buckets
register_strategy("ring_ht",
                  CollectiveSpec(RingTopology("ring"), Reliable(), Hadamard()))
