"""UBT packet codec: packetize/reassemble bucket payloads (DESIGN §7).

The port's copy of ``src/repro/net/wire.py``: the bytes on the wire are
the reference's, header and payload alike.

A bucket payload (raw fp32 gradients or HTQuant uint8 codes — the wire does
not care, it moves ``dtype`` elements) is split into fixed-size sequenced
datagrams of ``packet_elems`` elements each, the same packet granularity the
synthetic drop model uses (``OptiReduceConfig.packet_elems``), so an
observed arrival mask is *bit-compatible* with a ``core/drops.py`` mask:
packet ``seq`` covers elements ``[seq*packet_elems, (seq+1)*packet_elems)``
and a missing packet zeroes exactly that mask span (the tail packet is
short when ``n_elems % packet_elems != 0``, matching ``drops._expand``).

Header (16 bytes, network byte order)::

    version  B   wire-format version (`WIRE_VERSION`)
    kind     B   DATA1 (stage-1 shard) | DATA2 (stage-2 broadcast) | CTRL
    sender   H   sending peer's rank
    step     I   training step (stale packets are discarded on mismatch)
    bucket   H   bucket index within the step
    round    H   TAR round the payload belongs to
    seq      H   packet index within the stream
    n_seq    H   total packets in the stream

Reassembly is order-free: duplicates are ignored, out-of-order arrivals
land by ``seq``, and a stream is never *blocked* on a missing packet — the
receiver evaluates whatever arrived before its deadline and masks the rest
(the UBT semantics the compensated mean absorbs).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

WIRE_VERSION = 1
HEADER_FMT = "!BBHIHHHH"
HEADER_BYTES = struct.calcsize(HEADER_FMT)          # 16

KIND_DATA1 = 1      # stage-1 shard exchange payload
KIND_DATA2 = 2      # stage-2 aggregated-shard broadcast payload
KIND_CTRL = 3       # small reliable-ish control payloads (HTQuant amax)
KIND_RELAY = 4      # dead-link reroute: payload is a complete inner datagram

_KINDS = (KIND_DATA1, KIND_DATA2, KIND_CTRL, KIND_RELAY)


class WireError(ValueError):
    """A datagram that cannot belong to this wire format."""


@dataclasses.dataclass(frozen=True)
class PacketHeader:
    """Decoded header of one datagram (see module docstring)."""
    kind: int
    sender: int
    step: int
    bucket: int
    round: int
    seq: int
    n_seq: int

    def encode(self) -> bytes:
        return struct.pack(HEADER_FMT, WIRE_VERSION, self.kind, self.sender,
                           self.step, self.bucket, self.round, self.seq,
                           self.n_seq)

    @classmethod
    def decode(cls, datagram: bytes) -> tuple["PacketHeader", bytes]:
        """Split a datagram into (header, payload fragment)."""
        if len(datagram) < HEADER_BYTES:
            raise WireError(f"datagram of {len(datagram)} bytes is shorter "
                            f"than the {HEADER_BYTES}-byte header")
        version, kind, sender, step, bucket, rnd, seq, n_seq = \
            struct.unpack_from(HEADER_FMT, datagram)
        if version != WIRE_VERSION:
            raise WireError(f"wire version {version} != {WIRE_VERSION}")
        if kind not in _KINDS:
            raise WireError(f"unknown packet kind {kind}")
        return cls(kind=kind, sender=sender, step=step, bucket=bucket,
                   round=rnd, seq=seq, n_seq=n_seq), datagram[HEADER_BYTES:]

    def stream(self) -> tuple[int, int, int, int]:
        """The reassembly stream this packet belongs to."""
        return (self.kind, self.bucket, self.round, self.sender)


def n_packets(n_elems: int, packet_elems: int) -> int:
    """Packets needed for a stream of ``n_elems`` elements."""
    return max(1, -(-n_elems // packet_elems))


def wrap_relay(relay_src: int, final_dst: int, step: int,
               inner: bytes) -> bytes:
    """Wrap a datagram for a two-hop dead-link reroute.

    The outer header's ``sender`` is the peer posting the wrap (so fabric
    accounting stays truthful) and ``bucket`` carries the *final*
    destination rank; the payload is the complete inner datagram, which the
    relay peer re-sends verbatim — the receiver sees the original sender's
    header, and any per-(src, dst) drop schedule sees the relay hop's
    physical endpoints, which is exactly why the reroute survives a dead
    directed edge.
    """
    hdr = PacketHeader(kind=KIND_RELAY, sender=relay_src, step=step,
                       bucket=final_dst, round=0, seq=0, n_seq=1)
    return hdr.encode() + inner


def unwrap_relay(datagram: bytes) -> tuple[int, bytes]:
    """(final_dst, inner datagram) of a ``KIND_RELAY`` wrap."""
    hdr, inner = PacketHeader.decode(datagram)
    if hdr.kind != KIND_RELAY:
        raise WireError(f"not a relay datagram (kind {hdr.kind})")
    return hdr.bucket, inner


def packetize(payload: np.ndarray, *, kind: int, sender: int, step: int,
              bucket: int, round: int, packet_elems: int) -> list[bytes]:
    """Split a flat array into sequenced datagrams (header + raw bytes)."""
    payload = np.ascontiguousarray(payload)
    if payload.ndim != 1:
        raise WireError(f"payload must be flat, got shape {payload.shape}")
    n = payload.shape[0]
    total = n_packets(n, packet_elems)
    out = []
    for seq in range(total):
        frag = payload[seq * packet_elems:(seq + 1) * packet_elems]
        hdr = PacketHeader(kind=kind, sender=sender, step=step, bucket=bucket,
                           round=round, seq=seq, n_seq=total)
        out.append(hdr.encode() + frag.tobytes())
    return out


class Reassembly:
    """Order-free reassembly of one stream into payload + arrival mask.

    ``payload()`` zero-fills missing spans (the compensated mean never reads
    them — the mask excludes the span) and ``mask()`` is bit-compatible with
    a ``core/drops.py`` mask row: per-packet arrival expanded to element
    granularity with the same repeat-then-truncate rule as ``drops._expand``.
    """

    def __init__(self, n_elems: int, dtype, packet_elems: int):
        if n_elems <= 0 or packet_elems <= 0:
            raise WireError("n_elems and packet_elems must be positive")
        self.n_elems = int(n_elems)
        self.dtype = np.dtype(dtype)
        self.packet_elems = int(packet_elems)
        self.n_seq = n_packets(self.n_elems, self.packet_elems)
        self._buf = np.zeros(self.n_elems, self.dtype)
        self._have = np.zeros(self.n_seq, bool)
        self.duplicates = 0

    def _frag_elems(self, seq: int) -> int:
        lo = seq * self.packet_elems
        return min(self.packet_elems, self.n_elems - lo)

    def add(self, header: PacketHeader, fragment: bytes) -> bool:
        """Accept one datagram's payload; False for duplicates/garbage."""
        if header.n_seq != self.n_seq or not 0 <= header.seq < self.n_seq:
            return False                         # not this stream's geometry
        if self._have[header.seq]:
            self.duplicates += 1
            return False
        want = self._frag_elems(header.seq) * self.dtype.itemsize
        if len(fragment) != want:
            return False                         # truncated/padded garbage
        lo = header.seq * self.packet_elems
        frag = np.frombuffer(fragment, self.dtype)
        self._buf[lo:lo + frag.shape[0]] = frag
        self._have[header.seq] = True
        return True

    @property
    def complete(self) -> bool:
        return bool(self._have.all())

    @property
    def received_packets(self) -> int:
        return int(self._have.sum())

    def frac_received(self) -> float:
        return self.received_packets / self.n_seq

    def payload(self) -> np.ndarray:
        """The reassembled stream, zeros where packets are missing."""
        return self._buf

    def packet_mask(self) -> np.ndarray:
        return self._have.astype(np.float32)

    def mask(self) -> np.ndarray:
        """(n_elems,) 0/1 arrival mask — drops-mask bit-compatible."""
        m = np.repeat(self.packet_mask(), self.packet_elems)
        return m[:self.n_elems]
