"""Composable collective pipeline: Topology × Transport × Codec (DESIGN §3).

Counterpart of ``src/repro/core/pipeline.py``: every gradient-sync strategy
is a :class:`CollectiveSpec` composing a Topology (:class:`TarTopology`
with the all_to_all or the paper's round schedule, :class:`RingTopology`
for the ring / tree / BCube baselines, :class:`PsumTopology`), a Transport
(:class:`Reliable`, :class:`Lossy`, :class:`AdaptiveTransport`) and a
Codec (:class:`Identity`, :class:`Hadamard`, :class:`HTQuant`). A strategy
name resolves through the registry: every name of the reference but
``optireduce_2d`` (the pod axis, ROADMAP A15). The participation policies
(``active_peers``, ``shard_weights``, ``dead_links``) and the loss-recovery
codec (``cfg.recovery``, core/recovery.py) run as in the reference; the
wire transport waits for a later slice.

The reference runs one rank per device inside ``shard_map``; here every
stage works on ``(P, ...)`` stacks over the peer axis
(``core/collectives.py``), so one kernel launch serves all P peers of a
bucket. The randomness the reference draws from keys inside the stages
(the Hadamard sign, each receiver's arrival mask, the quantizer's
stochastic-rounding noise) comes from the context's :class:`Draws` provider
instead, so a test can hand in the reference's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Protocol

import torch

from . import collectives
from . import drops as drops_lib
from . import ring as ring_lib
from . import tar as tar_lib
from repro_torch.kernels.dequant_reduce import dequant_masked_mean
from repro_torch.kernels.quant import grid_quant

from .hadamard import (ht_decode, ht_encode, ht_encode_amax, ht_encode_quant,
                       rademacher_sign)
from .keys import Key, fold_in, generator
from .ubt import UbtState


# ------------------------------------------------------------- configuration
@dataclasses.dataclass(frozen=True)
class OptiReduceConfig:
    """Static configuration for gradient sync: the reference's fields, with
    the values this slice does not run rejected by :meth:`check`."""
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
        """Raise ``NotImplementedError`` naming the ROADMAP item for every
        field value this slice does not run."""
        todo = []
        if self.pod_axis is not None:
            todo.append("pod_axis (2D TAR): ROADMAP A15")
        if self.rs_wire_bits:
            todo.append("rs_wire_bits (FSDP reduce-scatter): ROADMAP A15")
        if todo:
            raise NotImplementedError("not ported yet: " + "; ".join(todo))
        if self.drop_pattern not in ("bernoulli", "tail", "straggler",
                                     "burst"):
            raise ValueError(f"unknown drop pattern {self.drop_pattern!r}")


class Draws(Protocol):
    """Where a sync step's random operands come from."""

    def sign(self, bucket: int, block: int) -> torch.Tensor:
        """The bucket's Hadamard sign, ``(block,)`` fp32 of +-1."""

    def mask(self, bucket: int, receiver: int, n: int, s: int,
             self_index: int | None = None) -> torch.Tensor:
        """Receiver's ``(n, s)`` fp32 arrival mask for the bucket's stage-1
        exchange, drawn under the receiver's id; row ``self_index`` (the
        receiver's own, unless a degraded round schedule indexes rows by
        virtual position) all ones."""

    def noise(self, bucket: int, salt: int,
              shape: tuple[int, ...]) -> torch.Tensor:
        """Uniform [0, 1) fp32 stochastic-rounding noise of the bucket's
        quantizer ``salt`` (3: stage 1, 4: stage 2), one copy shared by
        every peer."""


@dataclasses.dataclass(frozen=True)
class GeneratorDraws:
    """The default provider: ``torch.Generator``s seeded from the key path
    of the reference — sign from the bucket key ``fold_in(key, b)``, a
    receiver's mask from ``fold_in(bucket_key, receiver)``, a quantizer's
    noise from ``fold_in(bucket_key, salt)``."""
    key: Key                              # the sync key of this step
    cfg: OptiReduceConfig
    device: torch.device

    def sign(self, bucket: int, block: int) -> torch.Tensor:
        return rademacher_sign(
            generator(fold_in(self.key, bucket), self.device), block)

    def mask(self, bucket: int, receiver: int, n: int, s: int,
             self_index: int | None = None) -> torch.Tensor:
        gen = generator(fold_in(fold_in(self.key, bucket), receiver),
                        self.device)
        return drops_lib.make_mask(self.cfg.drop_pattern, gen, n, s,
                                   rate=self.cfg.drop_rate,
                                   packet_elems=self.cfg.packet_elems,
                                   self_index=receiver if self_index is None
                                   else self_index)

    def noise(self, bucket: int, salt: int,
              shape: tuple[int, ...]) -> torch.Tensor:
        gen = generator(fold_in(fold_in(self.key, bucket), salt), self.device)
        return torch.rand(shape, generator=gen, device=self.device)


@dataclasses.dataclass
class SyncContext:
    """Per-step (and, inside the engine, per-bucket) context. ``stale`` is
    the bucket's previous decoded value ``(L,)``, set by the sync engine
    when a stale-fill recovery codec is armed (None otherwise)."""
    cfg: OptiReduceConfig
    draws: Draws
    bucket: int = 0
    stats: dict = dataclasses.field(default_factory=dict)
    stale: torch.Tensor | None = None

    def for_bucket(self, bucket: int,
                   stale: torch.Tensor | None = None) -> "SyncContext":
        """This step's context for one bucket (stats shared)."""
        return SyncContext(cfg=self.cfg, draws=self.draws, bucket=bucket,
                           stats=self.stats, stale=stale)

    def sign(self, block: int) -> torch.Tensor:
        return self.draws.sign(self.bucket, block)

    def noise(self, salt: int, shape: tuple[int, ...]) -> torch.Tensor:
        return self.draws.noise(self.bucket, salt, shape)

    def loss_fraction(self) -> torch.Tensor:
        """Observed entry-loss fraction this step, averaged over receivers
        (the reference's ``pmean`` of dropped/total)."""
        if "total" not in self.stats:
            return torch.zeros(())
        frac = self.stats["dropped"] / max(self.stats["total"], 1.0)
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
    shared by every peer (None otherwise); ``stale`` is the previous step's
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


_STAGE1_SALT = 3     # stage-1 stochastic-rounding noise
_STAGE2_SALT = 4     # stage-2 (broadcast) noise


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
    ``_STAGE1_SALT`` and ``_STAGE2_SALT`` (the reference's ``fold_in(key,
    3)`` and ``fold_in(key, 4)``). The code width is ``cfg.quant_bits``.
    Not ``linear``: a ring cannot average its codes.
    """
    linear = False

    @staticmethod
    def _bits(cfg: OptiReduceConfig) -> int:
        bits = cfg.quant_bits
        if not 1 <= bits <= 8:
            raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
        return bits

    def block(self, cfg: OptiReduceConfig) -> int:
        return cfg.hadamard_block

    @staticmethod
    def _grids(enc: Encoded, nblk: int, shard_index: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Each receiver's slice of the bucket's grids, ``(P, nblk)`` (the
        reference's ``_grids(enc, shard_index, nblk)``, all receivers at
        once): receiver r's is shard r's, or shard ``shard_index[r]``'s."""
        lo, step = enc.lo.view(-1, nblk), enc.step.view(-1, nblk)
        if shard_index is None:
            return lo, step
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
        noise = ctx.noise(_STAGE1_SALT, (x.shape[-1] // block, block))
        codes = ht_encode_quant(x, ctx.sign(block), noise, lo, step,
                                block=block, bits=bits)
        return Encoded(codes, lo=lo, step=step)

    def encode(self, x, ctx):
        x1, amax = self.local_amax(x, ctx)
        return self.encode_given_amax(x1, collectives.pmax(amax)[0], ctx)

    def reduce(self, received, mask, enc, ctx, shard_index=None):
        block = ctx.cfg.hadamard_block
        lo, step = self._grids(enc, received.shape[-1] // block, shard_index)
        return dequant_masked_mean(received, lo, step, mask, block=block)

    def encode_shard(self, own, enc, ctx, shard_index=None):
        block = ctx.cfg.hadamard_block
        n, s = own.shape
        lo, step = self._grids(enc, s // block, shard_index)
        noise = ctx.noise(_STAGE2_SALT, (s // block, block))
        # row i of the (n * s / block) rows reads grid i: receiver r's rows
        # its own shard's grids
        codes = grid_quant(own.reshape(-1, block), noise, lo.reshape(-1),
                           step.reshape(-1), bits=self._bits(ctx.cfg))
        return codes.view(n, s)

    def decode_gathered(self, gathered, enc, ctx):
        block = ctx.cfg.hadamard_block
        shape = gathered.shape
        vals = (gathered.reshape(*shape[:-1], -1, block).to(torch.float32)
                * enc.step[:, None] + enc.lo[:, None]).reshape(shape)
        return ht_decode(vals, ctx.sign(block), block=block)

    # a value-domain shard decodes as the rotation alone
    decode_values = Hadamard.decode_values


# --------------------------------------------------------------- transports
class Reliable:
    """Everything arrives (TCP-class transports): no mask, no loss stats.
    ``incast`` is the round schedules' I."""

    def arrival_mask(self, ctx: SyncContext, n: int, s: int,
                     self_index: tuple[int, ...] | None = None
                     ) -> torch.Tensor | None:
        return None

    def incast(self, ctx: SyncContext) -> int:
        return ctx.cfg.incast


class Lossy(Reliable):
    """UBT best-effort delivery: the drop model (core/drops.py) decides each
    receiver's arrivals, ``(P, n, S)`` with receiver r in row r, and the
    loss counts feed ``ctx.loss_fraction``. ``self_index``, one row per
    receiver, names the row each receiver never drops when it is not the
    receiver's id (a degraded round schedule's virtual positions); the
    draws stay keyed on the receiver's id either way."""

    def arrival_mask(self, ctx, n, s, self_index=None):
        if ctx.cfg.drop_rate <= 0.0:
            return None
        if self_index is None:
            mask = torch.stack([ctx.draws.mask(ctx.bucket, r, n, s)
                                for r in range(n)])
        else:
            mask = torch.stack([ctx.draws.mask(ctx.bucket, r, n, s,
                                               self_index=i)
                                for r, i in enumerate(self_index)])
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
    """The native all-reduce: a mean over the peer axis."""

    def validate(self, transport, codec):
        if not isinstance(codec, Identity) or isinstance(transport, Lossy):
            raise ValueError("psum bypasses the codec and cannot model "
                             "drops (use a TAR topology)")

    def encode_stage(self, bucket, transport, codec, ctx):
        cfg, n = ctx.cfg, collectives.axis_size(bucket)
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
        return (collectives.pmean(state[0]),)

    def decode_stage(self, state, length, transport, codec, ctx):
        return state[0]


@dataclasses.dataclass(frozen=True)
class RingTopology(Topology):
    """Baseline schedules that reduce internally: Gloo Ring, recursive
    halving-doubling ("NCCL Tree"), Gloo BCube. They compose with a
    *linear* codec (decode commutes with the internal averaging) and a
    reliable transport."""
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

    def encode_stage(self, bucket, transport, codec, ctx):
        n = collectives.axis_size(bucket)
        x, _ = tar_lib.pad_for_tar(bucket, self._pad_n(ctx.cfg, n),
                                   codec.block(ctx.cfg))
        return (codec.encode(x, ctx).data,)

    def exchange_stage(self, state, transport, codec, ctx):
        (data,) = state
        n = collectives.axis_size(data)
        active, order, weights = self._geometry(ctx.cfg, n)
        if order is not None:
            # the virtual ring of active peers in link-avoiding order; the
            # graft replaces the ejected peers' garbage
            out = ring_lib.ring_allreduce(data, active=order, weights=weights)
            if active is not None:
                out = tar_lib.graft_inactive(out, active)
        elif self.kind == "ring":
            out = ring_lib.ring_allreduce(data)
        elif self.kind == "tree":
            out = ring_lib.tree_allreduce(data)
        else:
            out = ring_lib.bcube_allreduce(data, base=4 if n % 4 == 0 else 2)
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
    taking I from the transport. ``outer`` says how a pod axis would join
    (``'tar'`` or ``'pmean'``); the pod axis itself waits for ROADMAP A15,
    so here it only names the reference's composition.

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
        n = collectives.axis_size(bucket)
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
        lo = step = None
        if amax is not None:
            # deferred half of the split encode: share the grids over the
            # peers, then quantize
            enc = codec.encode_given_amax(data, collectives.pmax(amax)[0],
                                          ctx)
            data, lo, step = enc.data, enc.lo, enc.step
        enc = Encoded(data, lo=lo, step=step, stale=stale)
        n = collectives.axis_size(data)
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
            shards = data.view(n, n_shards, -1)
        s = shards.shape[-1]
        if rounds:
            received = tar_lib.tar_exchange_rounds(
                shards, incast=transport.incast(ctx), active=active,
                dead_links=dead)
        else:
            received = collectives.all_to_all(shards)
        shard_index = None
        if rounds and active is not None:
            # rows are in virtual-ring order; so are shard ownership and the
            # self row of the drop mask
            vpos, _ = tar_lib.peer_lookup(active, n)
            shard_index = collectives.index(vpos, data.device)
            mask = transport.arrival_mask(ctx, n_shards, s, self_index=vpos)
        else:
            mask = transport.arrival_mask(ctx, n_shards, s)
            if active is not None:
                # a2a: exclude ejected senders' rows at EVERY receiver (the
                # ejected peer's own row included, so replicas agree); the
                # compensated mean treats them as dropped
                _, is_active = tar_lib.peer_lookup(active, n)
                rows = collectives.index(tuple(int(v) for v in is_active),
                                         data.device).to(torch.float32)
                rows = rows[:, None]
                mask = rows.expand(n, n, s) if mask is None else mask * rows
        own = codec.reduce(received, mask, enc, ctx, shard_index=shard_index)
        wire = codec.encode_shard(own, enc, ctx, shard_index=shard_index)
        if rounds:
            gathered = tar_lib.tar_broadcast_rounds(
                wire, incast=transport.incast(ctx), active=active,
                dead_links=dead, plan=plan)
            if active is not None:
                gathered = tar_lib.graft_inactive(gathered, active)
        else:
            gathered = collectives.all_gather(wire)
        return (gathered, lo, step)         # stale consumed in the reduce

    def decode_stage(self, state, length, transport, codec, ctx):
        # only the quantization grids survive the exchange
        gathered, lo, step = state
        out = codec.decode_gathered(gathered, Encoded(None, lo=lo, step=step),
                                    ctx)
        return out[..., :length]


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


_REGISTRY: dict[str, Callable[[OptiReduceConfig], CollectiveSpec]] = {}

# reference strategies that wait for a later slice, with their ROADMAP item
_NOT_PORTED = {"optireduce_2d": "A15"}


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
        item = _NOT_PORTED.get(cfg.strategy)
        if item is not None:
            raise NotImplementedError(f"strategy {cfg.strategy!r} is not "
                                      f"ported yet: ROADMAP {item}")
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
def _optireduce_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    codec = Hadamard() if cfg.use_hadamard else Identity()
    return CollectiveSpec(TarTopology(), Lossy(), _recovered(codec, cfg))


# The next three are factories, as in the reference, though their specs
# ignore the config: the launcher's --adaptive tests whether a codec flip
# matters by the identity of the two resolved specs, and a factory answers
# "it does" as the reference's does (ROADMAP C).
@register_strategy("optireduce_q")
def _optireduce_q_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    """The quantized exchange: TAR x Lossy x HTQuant (the reference's
    TarTopology(outer="pmean"); the pod axis it names is not ported)."""
    # _recovered rejects recovery over quantized codes
    return CollectiveSpec(TarTopology(), Lossy(), _recovered(HTQuant(), cfg))


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
