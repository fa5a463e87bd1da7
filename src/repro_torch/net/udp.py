"""Real UDP datagram backend on localhost (non-blocking sockets).

The port's copy of ``src/repro/net/udp.py``.

Each peer binds its own ``127.0.0.1`` socket (ephemeral port by default);
sends are fire-and-forget ``sendto`` calls and receives are non-blocking
drains timestamped on the monotonic clock, so the peer's receive loop
enforces the adaptive per-round deadline against *real* elapsed time —
packets genuinely in flight past the deadline are masked, exactly the UBT
semantics.  An optional ``drop_fn`` injects loss at the sender (localhost
UDP itself rarely drops; tests and the demo script use it to emulate a
lossy path), and CTRL-kind packets are sent ``ctrl_redundancy`` times —
the cheap stand-in for the reliable control channel (duplicates are
discarded by reassembly).

Two deployment shapes share the datagram mechanics:

* :class:`UdpBackend` — N sockets in *one* process (the HostRing's
  threaded peers), with a built-in phase fence;
* :class:`UdpProcessBackend` — *one* socket for one OS process (the
  multi-process worker), destination addresses resolved
  through a rendezvous membership view (``addr_of``) instead of a local
  socket list; phase fencing belongs to the rendezvous barriers, never
  this backend.

``scramble_seed`` adds deterministic *reordering* injection: DATA packets
of a stream are buffered until its last sequence number is offered, then
sent in a header-keyed shuffled order — real UDP on localhost virtually
never reorders, and the recovery suite needs to prove the reassembly path
is order-free under loss + reordering together.

Restricted environments commonly forbid socket binding;
:func:`udp_available` probes that so tests can auto-skip instead of fail.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable

from .backend import Backend, PhaseBarrier
from .wire import KIND_CTRL, PacketHeader

_RCVBUF = 1 << 22
_M64 = (1 << 64) - 1


def _mix64(h: int) -> int:
    h = (h + 0x9E3779B97F4A7C15) & _M64
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
    return h ^ (h >> 31)


def _scramble_order(seed: int, src: int, dst: int, hdr: PacketHeader,
                    count: int) -> list[int]:
    """Header-keyed Fisher–Yates permutation of a stream's send order."""
    h = seed & _M64
    for v in (src, dst, hdr.kind, hdr.step, hdr.bucket, hdr.round):
        h = _mix64(h ^ v)
    order = list(range(count))
    for i in range(count - 1, 0, -1):
        h = _mix64(h)
        j = h % (i + 1)
        order[i], order[j] = order[j], order[i]
    return order


def udp_available() -> bool:
    """Can this process bind a localhost UDP socket?"""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.bind(("127.0.0.1", 0))
        finally:
            s.close()
        return True
    except OSError:
        return False


class UdpBackend(Backend):
    """Localhost UDP fabric (see module docstring)."""

    virtual_time = False

    def __init__(self, n_peers: int, *, drop_fn=None, ctrl_redundancy: int = 3,
                 poll_sleep: float = 2e-4, scramble_seed: int | None = None):
        self.n_peers = int(n_peers)
        self.drop_fn = drop_fn
        self.ctrl_redundancy = max(1, int(ctrl_redundancy))
        self.poll_sleep = float(poll_sleep)
        self.scramble_seed = scramble_seed
        self._pending: dict[tuple, list[bytes]] = {}
        self._fence = PhaseBarrier(self.n_peers)
        self._socks: list[socket.socket] = []
        self._addrs: list[tuple[str, int]] = []
        self.sent = 0
        self.dropped = 0
        self._lock = threading.Lock()
        try:
            for _ in range(self.n_peers):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind(("127.0.0.1", 0))
                s.setblocking(False)
                try:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _RCVBUF)
                except OSError:
                    pass                      # best-effort: default is fine
                self._socks.append(s)
                self._addrs.append(s.getsockname())
        except OSError:
            self.close()
            raise

    def send(self, src: int, dst: int, datagram: bytes) -> None:
        hdr, _ = PacketHeader.decode(datagram)
        with self._lock:
            self.sent += 1
        reps = self.ctrl_redundancy if hdr.kind == KIND_CTRL else 1
        dropped = hdr.kind != KIND_CTRL and self.drop_fn is not None \
            and self.drop_fn(src, dst, hdr)
        if dropped:
            with self._lock:
                self.dropped += 1
        if self.scramble_seed is not None and hdr.kind != KIND_CTRL:
            # reordering injection: hold the stream until its final seq is
            # offered (packetize emits seqs in order), then release in a
            # header-keyed shuffle — losses simply leave the buffer shorter
            key = (src, dst, hdr.kind, hdr.step, hdr.bucket, hdr.round)
            with self._lock:
                buf = self._pending.setdefault(key, [])
                if not dropped:
                    buf.append(datagram)
                if hdr.seq != hdr.n_seq - 1:
                    return
                del self._pending[key]
            order = _scramble_order(self.scramble_seed, src, dst, hdr,
                                    len(buf))
            for i in order:
                self._sendto(src, dst, buf[i])
            return
        if dropped:
            return
        for _ in range(reps):
            if not self._sendto(src, dst, datagram):
                return

    def _sendto(self, src: int, dst: int, datagram: bytes) -> bool:
        try:
            self._socks[src].sendto(datagram, self._addrs[dst])
            return True
        except (BlockingIOError, OSError):
            with self._lock:              # kernel buffer full = network loss
                self.dropped += 1
            return False

    def poll(self, me: int) -> list[tuple[bytes, float]]:
        out = []
        sock = self._socks[me]
        while True:
            try:
                data, _ = sock.recvfrom(1 << 16)
            except (BlockingIOError, OSError):
                break
            out.append((data, time.monotonic()))
        return out

    def now(self, me: int) -> float:
        return time.monotonic()

    def wait(self, me: int, timeout: float) -> bool:
        time.sleep(min(self.poll_sleep, max(timeout, 0.0)))
        return True

    def barrier(self, timeout: float | None = None) -> None:
        self._fence.wait(timeout=timeout)

    def close(self) -> None:
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        self._socks = []


class UdpProcessBackend(Backend):
    """One OS process's single-socket UDP fabric endpoint.

    The multi-process worker backend: binds one non-blocking
    socket *before* rank assignment (the advertised port rides the
    rendezvous JOIN), then :meth:`attach` wires in the assigned rank and a
    rendezvous address resolver — ``resolver(dst) -> (host, port) | None``,
    None meaning "that rank is not live" (the datagram is accounted as
    dropped; the membership-aware peer normally skips dead ranks before
    reaching here).  There is no in-process fence across peers to offer:
    :meth:`barrier` raises — multi-process phases fence through the
    rendezvous coordinator's barrier tags.
    """

    virtual_time = False

    def __init__(self, world_size: int, *, drop_fn=None,
                 ctrl_redundancy: int = 3, poll_sleep: float = 2e-4,
                 host: str = "127.0.0.1"):
        self.n_peers = int(world_size)
        self.drop_fn = drop_fn
        self.ctrl_redundancy = max(1, int(ctrl_redundancy))
        self.poll_sleep = float(poll_sleep)
        self.rank: int | None = None
        self._resolver: Callable[[int], tuple[str, int] | None] | None = None
        self.sent = 0
        self.dropped = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, 0))
        self._sock.setblocking(False)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  _RCVBUF)
        except OSError:
            pass                          # best-effort: default is fine
        self.addr: tuple[str, int] = self._sock.getsockname()

    @property
    def port(self) -> int:
        return self.addr[1]

    def attach(self, rank: int,
               resolver: Callable[[int], tuple[str, int] | None]) -> None:
        """Bind the rendezvous-assigned rank + peer address resolver."""
        self.rank = int(rank)
        self._resolver = resolver

    def send(self, src: int, dst: int, datagram: bytes) -> None:
        if self._resolver is None:
            raise RuntimeError("UdpProcessBackend.send before attach()")
        if src != self.rank:
            raise ValueError(f"process backend owns rank {self.rank}, "
                             f"cannot send as {src}")
        hdr, _ = PacketHeader.decode(datagram)
        self.sent += 1
        if hdr.kind != KIND_CTRL and self.drop_fn is not None \
                and self.drop_fn(src, dst, hdr):
            self.dropped += 1
            return
        addr = self._resolver(dst)
        if addr is None:                  # dead/unknown rank: nowhere to go
            self.dropped += 1
            return
        reps = self.ctrl_redundancy if hdr.kind == KIND_CTRL else 1
        for _ in range(reps):
            try:
                self._sock.sendto(datagram, tuple(addr))
            except (BlockingIOError, OSError):
                self.dropped += 1         # kernel buffer full = network loss
                return

    def poll(self, me: int) -> list[tuple[bytes, float]]:
        out = []
        while True:
            try:
                data, _ = self._sock.recvfrom(1 << 16)
            except (BlockingIOError, OSError):
                break
            out.append((data, time.monotonic()))
        return out

    def now(self, me: int) -> float:
        return time.monotonic()

    def wait(self, me: int, timeout: float) -> bool:
        time.sleep(min(self.poll_sleep, max(timeout, 0.0)))
        return True

    def barrier(self, timeout: float | None = None) -> None:
        raise RuntimeError("UdpProcessBackend has no in-process fence; "
                           "multi-process phases fence through the "
                           "rendezvous barrier tags")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
