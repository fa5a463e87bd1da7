"""Deterministic in-memory loopback backend with scripted loss/delay.

The port's copy of ``src/repro/net/inproc.py``: the drop scripts are
host integer hashes of the header, so they decide every packet as the
reference's do.

The CI stand-in for a real network: per-peer mailboxes, a *virtual* clock
(each receive phase starts at t=0; a packet's arrival time is whatever the
delay schedule says), and scripted per-packet drop/delay functions of
``(src, dst, PacketHeader)`` — so a test can make the wire lose *exactly*
the packets a ``core/drops.py`` mask names (the bitwise-parity pin) or make
one peer persistently slow (the straggler-detector feed).

Scripts only apply to DATA-kind packets; CTRL packets (quantization grids)
always arrive with zero delay — they model the small reliable control
channel.  All scheduling is a pure function of the packet header, so runs
are exactly reproducible.
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from .backend import Backend, PhaseBarrier
from .wire import KIND_CTRL, KIND_DATA1, PacketHeader

DropFn = Callable[[int, int, PacketHeader], bool]
DelayFn = Callable[[int, int, PacketHeader], float]


_M64 = (1 << 64) - 1


def _splitmix64(h: int) -> int:
    h = (h + 0x9E3779B97F4A7C15) & _M64
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
    return h ^ (h >> 31)


def bernoulli_drops(rate: float, seed: int = 0) -> DropFn:
    """I.i.d. per-packet loss at ``rate``, deterministic in the header.

    The draw is a splitmix64 mix of the header fields, not a Generator —
    this runs per DATA packet on the send path (thousands per step in wire
    training), where constructing an ``np.random`` Generator each time is
    ~100x the cost for the same header-pure determinism.
    """
    threshold = int(rate * (1 << 64))

    def drop(src: int, dst: int, hdr: PacketHeader) -> bool:
        if rate <= 0.0:
            return False
        h = seed & _M64
        for v in (src, dst, hdr.step, hdr.bucket, hdr.round, hdr.seq):
            h = _splitmix64(h ^ v)
        return h < threshold
    return drop


def burst_drops(rate: float, seed: int = 0,
                mean_burst: float = 8.0) -> DropFn:
    """Gilbert–Elliott bursty loss, deterministic in the header.

    Mirrors ``core.drops.burst_mask``: a two-state Markov chain per packet
    *stream* — one chain per ``(src, dst, step, bucket, round)``, stepped
    along ``seq`` — with the shared ``gilbert_elliott_params(rate,
    mean_burst)`` parameterization, so wire bursts have the same run-length
    statistics as the synthetic masks.  The chain is sequential in ``seq`` but
    header-pure: each stream's state prefix is cached and extended with
    splitmix64 uniforms keyed by (stream, seq), so out-of-order calls give
    the same answer and the amortized cost is one mix per packet.  Applies
    to stage-1 DATA packets only (drop scripts never touch CTRL).
    """
    from repro_torch.core.drops import gilbert_elliott_params
    p, r = gilbert_elliott_params(rate, mean_burst)
    rate_c = min(max(rate, 0.0), 0.999)
    # per-stream loss-state prefix: stream key -> list of bools, state[i]
    # is the chain's Bad indicator for seq i
    prefixes: dict[tuple, list[bool]] = {}

    def uniform(stream_h: int, seq: int) -> float:
        return _splitmix64(stream_h ^ _splitmix64(seed ^ seq)) / float(1 << 64)

    def drop(src: int, dst: int, hdr: PacketHeader) -> bool:
        if rate_c <= 0.0 or hdr.kind != KIND_DATA1:
            return False
        stream = (src, dst, hdr.step, hdr.bucket, hdr.round)
        h = seed & _M64
        for v in stream:
            h = _splitmix64(h ^ v)
        states = prefixes.setdefault(stream, [])
        while len(states) <= hdr.seq:
            i = len(states)
            u = uniform(h, i)
            if i == 0:
                bad = u < rate_c                    # stationary start
            elif states[i - 1]:
                bad = u >= r                        # Bad: stay unless recover
            else:
                bad = u < p                         # Good: enter burst w.p. p
            states.append(bad)
        return states[hdr.seq]
    return drop


def mask_scripted_drops(masks: dict[int, np.ndarray],
                        packet_elems: int) -> DropFn:
    """Drop exactly the packets a per-receiver drops-mask names.

    ``masks[receiver]`` is the (n_peers, shard_elems) 0/1 arrival mask the
    synthetic ``Lossy`` transport would generate for that receiver; stage-1
    packet ``seq`` of sender ``src`` is dropped iff the mask zeroes its
    span — what pins wire-observed masks bitwise to ``core/drops.py``
    masks.  Stage-2 packets always pass: the drop model applies to stage 1
    only (the aggregated shard is authoritative; DESIGN §2).
    """

    def drop(src: int, dst: int, hdr: PacketHeader) -> bool:
        if hdr.kind != KIND_DATA1:
            return False
        mask = masks.get(dst)
        if mask is None:
            return False
        return bool(mask[src, hdr.seq * packet_elems] == 0.0)
    return drop


def peer_factor_delays(base: float = 1e-4,
                       factors: tuple[float, ...] | None = None) -> DelayFn:
    """Per-sender latency: ``base * factors[src]`` plus a small
    header-hashed jitter (deterministic), mirroring
    ``sim.netsim.NetworkModel.peer_factors``."""

    def delay(src: int, dst: int, hdr: PacketHeader) -> float:
        f = 1.0 if factors is None else float(factors[src])
        jitter = ((src * 131 + dst * 17 + hdr.seq * 7 + hdr.round) % 97) / 97.0
        return base * f * (1.0 + 0.1 * jitter)
    return delay


class InprocBackend(Backend):
    """Deterministic loopback fabric (see module docstring)."""

    virtual_time = True

    def __init__(self, n_peers: int, *, drop_fn: DropFn | None = None,
                 delay_fn: DelayFn | None = None):
        self.n_peers = int(n_peers)
        self.drop_fn = drop_fn
        self.delay_fn = delay_fn or peer_factor_delays()
        self._lock = threading.Lock()
        self._mail: list[list[tuple[bytes, float]]] = \
            [[] for _ in range(self.n_peers)]
        self._fence = PhaseBarrier(self.n_peers)
        self.sent = 0
        self.dropped = 0

    def send(self, src: int, dst: int, datagram: bytes) -> None:
        hdr, _ = PacketHeader.decode(datagram)
        self.sent += 1
        if hdr.kind == KIND_CTRL:                   # reliable control channel
            t = 0.0
        else:
            if self.drop_fn is not None and self.drop_fn(src, dst, hdr):
                self.dropped += 1
                return
            t = float(self.delay_fn(src, dst, hdr))
        with self._lock:
            self._mail[dst].append((datagram, t))

    def poll(self, me: int) -> list[tuple[bytes, float]]:
        with self._lock:
            out, self._mail[me] = self._mail[me], []
        return out

    def now(self, me: int) -> float:
        return 0.0                                  # each phase starts at t=0

    def wait(self, me: int, timeout: float) -> bool:
        return False                                # one drain sees everything

    def barrier(self, timeout: float | None = None) -> None:
        self._fence.wait(timeout=timeout)
