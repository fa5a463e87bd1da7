"""Composable collective pipeline: Topology × Transport × Codec (DESIGN §3).

Counterpart of ``src/repro/core/pipeline.py``, main-path subset: every
gradient-sync strategy is a :class:`CollectiveSpec` composing a Topology
(:class:`TarTopology` with the all_to_all schedule, :class:`PsumTopology`),
a Transport (:class:`Reliable`, :class:`Lossy`) and a Codec
(:class:`Identity`, :class:`Hadamard`, :class:`HTQuant`). A strategy name
resolves through the registry (``psum``, ``tar_tcp``, ``optireduce``,
``optireduce_q``).

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
from typing import Callable, Protocol

import torch

from . import collectives
from . import drops as drops_lib
from . import tar as tar_lib
from repro_torch.kernels.dequant_reduce import dequant_masked_mean
from repro_torch.kernels.quant import grid_quant

from .hadamard import (ht_decode, ht_encode, ht_encode_amax, ht_encode_quant,
                       rademacher_sign)
from .keys import Key, fold_in, generator


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
    active_peers: tuple[int, ...] | None = None
    shard_weights: tuple[int, ...] | None = None
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
        if self.active_peers is not None:
            todo.append("active_peers (degraded participation): ROADMAP A14")
        if self.shard_weights is not None:
            todo.append("shard_weights (rebalanced shards): ROADMAP A14")
        if self.dead_links:
            todo.append("dead_links (ring rewiring): ROADMAP A14")
        if self.recovery != "none":
            todo.append(f"recovery={self.recovery!r}: ROADMAP A16")
        if todo:
            raise NotImplementedError("not ported yet: " + "; ".join(todo))
        if self.drop_pattern not in ("bernoulli", "tail", "straggler",
                                     "burst"):
            raise ValueError(f"unknown drop pattern {self.drop_pattern!r}")


class Draws(Protocol):
    """Where a sync step's random operands come from."""

    def sign(self, bucket: int, block: int) -> torch.Tensor:
        """The bucket's Hadamard sign, ``(block,)`` fp32 of +-1."""

    def mask(self, bucket: int, receiver: int, n: int,
             s: int) -> torch.Tensor:
        """Receiver's ``(n, s)`` fp32 arrival mask for the bucket's stage-1
        exchange, its own row all ones."""

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

    def mask(self, bucket: int, receiver: int, n: int,
             s: int) -> torch.Tensor:
        gen = generator(fold_in(fold_in(self.key, bucket), receiver),
                        self.device)
        return drops_lib.make_mask(self.cfg.drop_pattern, gen, n, s,
                                   rate=self.cfg.drop_rate,
                                   packet_elems=self.cfg.packet_elems,
                                   self_index=receiver)

    def noise(self, bucket: int, salt: int,
              shape: tuple[int, ...]) -> torch.Tensor:
        gen = generator(fold_in(fold_in(self.key, bucket), salt), self.device)
        return torch.rand(shape, generator=gen, device=self.device)


@dataclasses.dataclass
class SyncContext:
    """Per-step (and, inside the engine, per-bucket) context."""
    cfg: OptiReduceConfig
    draws: Draws
    bucket: int = 0
    stats: dict = dataclasses.field(default_factory=dict)

    def for_bucket(self, bucket: int) -> "SyncContext":
        """This step's context for one bucket (stats shared)."""
        return SyncContext(cfg=self.cfg, draws=self.draws, bucket=bucket,
                           stats=self.stats)

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


# ------------------------------------------------------------------- codecs
@dataclasses.dataclass
class Encoded:
    """A codec's wire form of one ``(P, L)`` bucket stack: ``data`` is what
    travels (fp32 values or uint8 codes); ``lo`` / ``step`` are a
    quantizing codec's per-Hadamard-block grids, ``(L / block,)``, one copy
    shared by every peer (None otherwise)."""
    data: torch.Tensor | None
    lo: torch.Tensor | None = None
    step: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Codec:
    """Identity codec — also the base class defining the codec protocol:
    ``encode`` before stage 1, ``reduce`` the received ``(P, N, S)``
    shards, ``encode_shard`` for stage 2, ``decode_gathered`` after it."""

    def block(self, cfg: OptiReduceConfig) -> int:
        return 1

    def encode(self, x: torch.Tensor, ctx: SyncContext) -> Encoded:
        return Encoded(x)

    def reduce(self, received: torch.Tensor, mask: torch.Tensor | None,
               enc: Encoded, ctx: SyncContext) -> torch.Tensor:
        return tar_lib.masked_mean(received, mask)

    def encode_shard(self, own: torch.Tensor, enc: Encoded,
                     ctx: SyncContext) -> torch.Tensor:
        return own

    def decode_gathered(self, gathered: torch.Tensor, enc: Encoded,
                        ctx: SyncContext) -> torch.Tensor:
        return gathered


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
    """

    @staticmethod
    def _bits(cfg: OptiReduceConfig) -> int:
        bits = cfg.quant_bits
        if not 1 <= bits <= 8:
            raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
        return bits

    def block(self, cfg: OptiReduceConfig) -> int:
        return cfg.hadamard_block

    @staticmethod
    def _grids(enc: Encoded, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Each receiver's slice of the bucket's grids: ``(n, S / block)``
        (the reference's ``_grids(enc, shard_index, nblk)``, all at once)."""
        return enc.lo.view(n, -1), enc.step.view(n, -1)

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

    def reduce(self, received, mask, enc, ctx):
        n = received.shape[0]
        lo, step = self._grids(enc, n)
        return dequant_masked_mean(received, lo, step, mask,
                                   block=ctx.cfg.hadamard_block)

    def encode_shard(self, own, enc, ctx):
        block = ctx.cfg.hadamard_block
        n, s = own.shape
        noise = ctx.noise(_STAGE2_SALT, (s // block, block))
        codes = grid_quant(own.reshape(-1, block), noise, enc.lo, enc.step,
                           bits=self._bits(ctx.cfg))
        return codes.view(n, s)

    def decode_gathered(self, gathered, enc, ctx):
        block = ctx.cfg.hadamard_block
        shape = gathered.shape
        vals = (gathered.reshape(*shape[:-1], -1, block).to(torch.float32)
                * enc.step[:, None] + enc.lo[:, None]).reshape(shape)
        return ht_decode(vals, ctx.sign(block), block=block)


# --------------------------------------------------------------- transports
class Reliable:
    """Everything arrives (TCP-class transports): no mask, no loss stats."""

    def arrival_mask(self, ctx: SyncContext, n: int,
                     s: int) -> torch.Tensor | None:
        return None


class Lossy(Reliable):
    """UBT best-effort delivery: the drop model (core/drops.py) decides each
    receiver's arrivals, ``(P, N, S)`` with receiver r in row r, and the
    loss counts feed ``ctx.loss_fraction``."""

    def arrival_mask(self, ctx, n, s):
        if ctx.cfg.drop_rate <= 0.0:
            return None
        mask = torch.stack([ctx.draws.mask(ctx.bucket, r, n, s)
                            for r in range(n)])
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
        return (bucket,)

    def exchange_stage(self, state, transport, codec, ctx):
        return (collectives.pmean(state[0]),)

    def decode_stage(self, state, length, transport, codec, ctx):
        return state[0]


@dataclasses.dataclass(frozen=True)
class TarTopology(Topology):
    """Transpose AllReduce (§3.1): stage-1 shard exchange -> codec reduce ->
    stage-2 broadcast. Only the ``'a2a'`` schedule is ported; the paper's
    round schedule waits for ROADMAP A14."""
    schedule: str = "a2a"

    def __post_init__(self):
        if self.schedule == "rounds":
            raise NotImplementedError(
                "TarTopology(schedule='rounds') is not ported yet: "
                "ROADMAP A14")
        if self.schedule != "a2a":
            raise ValueError(f"unknown TAR schedule {self.schedule!r}")

    def encode_stage(self, bucket, transport, codec, ctx):
        n = collectives.axis_size(bucket)
        x, _ = tar_lib.pad_for_tar(bucket, n, codec.block(ctx.cfg))
        if hasattr(codec, "local_amax"):
            # split encode (quantizing codec): only the pre-collective half
            # here; the grid pmax and the quantize ride the exchange stage,
            # as in the reference's pipelined schedule
            return codec.local_amax(x, ctx)
        return (codec.encode(x, ctx).data, None)

    def exchange_stage(self, state, transport, codec, ctx):
        data, amax = state
        lo = step = None
        if amax is not None:
            # deferred half of the split encode: share the grids over the
            # peers, then quantize
            enc = codec.encode_given_amax(data, collectives.pmax(amax)[0],
                                          ctx)
            data, lo, step = enc.data, enc.lo, enc.step
        n = collectives.axis_size(data)
        s = data.shape[-1] // n
        received = collectives.all_to_all(data.view(n, n, s))
        mask = transport.arrival_mask(ctx, n, s)
        enc = Encoded(data, lo=lo, step=step)
        own = codec.reduce(received, mask, enc, ctx)
        wire = codec.encode_shard(own, enc, ctx)
        return (collectives.all_gather(wire), lo, step)

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
_NOT_PORTED = {
    "gloo_ring": "A14", "nccl_tree": "A14", "bcube": "A14",
    "tar_rounds": "A14", "optireduce_rounds": "A14", "ring_ht": "A14",
    "tar_rounds_q": "A14", "optireduce_2d": "A15",
}


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
register_strategy("tar_tcp",
                  CollectiveSpec(TarTopology(), Reliable(), Identity()))


@register_strategy("optireduce")
def _optireduce_spec(cfg: OptiReduceConfig) -> CollectiveSpec:
    codec = Hadamard() if cfg.use_hadamard else Identity()
    return CollectiveSpec(TarTopology(), Lossy(), codec)


# the quantized exchange: TAR x Lossy x HTQuant (the reference's
# TarTopology(outer="pmean"); the pod axis it names is not ported)
register_strategy("optireduce_q",
                  CollectiveSpec(TarTopology(), Lossy(), HTQuant()))
