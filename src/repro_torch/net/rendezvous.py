"""Socket rendezvous: rank assignment, elastic membership, barriers (DESIGN §9).

The port's copy of ``src/repro/net/rendezvous.py``.

The multi-process peer runtime's control endpoint.  One coordinator (a TCP
server, or its in-memory twin for socket-free CI) owns the authoritative
*membership*: which uids currently hold which of the ``world_size`` rank
slots.  Every membership change — a JOIN claiming the lowest free slot, an
explicit LEAVE, a death detected by TCP EOF or heartbeat silence — bumps a
monotonic **generation** number, so any two views of the world are ordered
and a stale UPDATE can never roll a client backwards.

The coordinator also runs the launch-critical **phase barriers**: a peer
step is ``PHASES_PER_STEP`` fenced phases and barrier *tag* ``step * PHASES
_PER_STEP + phase`` is a total order over the run.  Each member carries a
``since`` tag — the first barrier it is required at (0 for the initial
cohort, the next step boundary for a rejoiner) — and a tag releases when
every *live* member with ``since <= tag`` has arrived.  That single rule
gives elasticity for free: a crashed peer stops being required the moment
its death is processed (the survivors' next fence releases degraded), and
a restarted peer is only awaited from its own future step boundary, so a
rejoin can never deadlock fences already in flight.

Message codec mirrors ``wire.py`` discipline — a fixed 16-byte struct
header (+ a length-prefixed payload), property-tested for roundtrip,
chunked-delivery invariance, and generation monotonicity.

Layering: :class:`RendezvousState` is the pure, transport-free state
machine (what the property tests drive); :class:`RendezvousServer` /
:class:`RendezvousClient` are its TCP shell; :class:`LocalCoordinator` /
:class:`LocalClient` the in-memory shell for a socket-free multi-process
launcher.  Clients double as the **membership view** the
refactored :class:`~repro_torch.net.peer.HostPeer` consumes (``is_live`` /
``generation`` / ``addr_of``) in place of a fixed peer list.
"""
from __future__ import annotations

import dataclasses
import selectors
import socket
import struct
import threading
import time
from collections import deque

RENDEZVOUS_VERSION = 1

#: one peer step = 4 fenced phases (encode | send1 | reduce+send2 | decode)
PHASES_PER_STEP = 4

# header: version, kind, rank (signed; -1 = unassigned), world_size,
# generation, seq (barrier tag / since tag / event code), payload length
MSG_HEADER_FMT = "!BBhHIIH"
MSG_HEADER_BYTES = struct.calcsize(MSG_HEADER_FMT)          # 16

MSG_JOIN = 1        # client -> server: claim a rank (payload: uid/host/port)
MSG_WELCOME = 2     # server -> client: assigned rank + membership blob
MSG_UPDATE = 3      # server -> client: membership changed (seq = event code)
MSG_HEARTBEAT = 4   # client -> server: liveness
MSG_LEAVE = 5       # client -> server: graceful departure
MSG_BARRIER = 6     # client -> server: arrived at barrier tag `seq`
MSG_RELEASE = 7     # server -> client: barrier tag `seq` released
MSG_REJECT = 8      # server -> client: join refused (payload: reason)

_MSG_KINDS = (MSG_JOIN, MSG_WELCOME, MSG_UPDATE, MSG_HEARTBEAT, MSG_LEAVE,
              MSG_BARRIER, MSG_RELEASE, MSG_REJECT)

EV_JOIN = 1
EV_LEAVE = 2
EV_DEATH = 3
_EVENT_NAMES = {EV_JOIN: "join", EV_LEAVE: "leave", EV_DEATH: "death"}

_JOIN_FMT = "!QH"                                   # uid, advertised port
_MEMBER_FMT = "!HQHIB"                              # rank, uid, port, since,
_BLOB_FMT = "!IHH"                                  # generation, world, count


class RendezvousError(Exception):
    """A message or transition that cannot belong to this protocol."""


class RendezvousFull(RendezvousError):
    """JOIN with no free rank slot."""


class RendezvousTimeout(RendezvousError):
    """A bounded wait (join, barrier) expired."""


# ---------------------------------------------------------------- messages
@dataclasses.dataclass(frozen=True)
class RendezvousMessage:
    """One coordinator-protocol message (see module docstring)."""
    kind: int
    rank: int = -1
    world: int = 0
    generation: int = 0
    seq: int = 0
    payload: bytes = b""

    def encode(self) -> bytes:
        if len(self.payload) > 0xFFFF:
            raise RendezvousError(f"payload of {len(self.payload)} bytes "
                                  "exceeds the 16-bit length field")
        return struct.pack(MSG_HEADER_FMT, RENDEZVOUS_VERSION, self.kind,
                           self.rank, self.world, self.generation,
                           self.seq, len(self.payload)) + self.payload

    @classmethod
    def decode(cls, buf: bytes) -> tuple["RendezvousMessage", int] | None:
        """Decode one message from a byte stream prefix.

        Returns ``(message, bytes_consumed)``, or None when ``buf`` holds
        only a partial message (stream framing: wait for more bytes).
        Raises :class:`RendezvousError` for bytes that cannot be a message.
        """
        if len(buf) < MSG_HEADER_BYTES:
            return None
        version, kind, rank, world, generation, seq, plen = \
            struct.unpack_from(MSG_HEADER_FMT, buf)
        if version != RENDEZVOUS_VERSION:
            raise RendezvousError(
                f"rendezvous version {version} != {RENDEZVOUS_VERSION}")
        if kind not in _MSG_KINDS:
            raise RendezvousError(f"unknown message kind {kind}")
        end = MSG_HEADER_BYTES + plen
        if len(buf) < end:
            return None
        return cls(kind=kind, rank=rank, world=world, generation=generation,
                   seq=seq, payload=bytes(buf[MSG_HEADER_BYTES:end])), end


class FrameBuffer:
    """Accumulate an arbitrarily-chunked byte stream into whole messages.

    TCP delivers a byte stream, not datagrams; :meth:`feed` is invariant to
    how the stream was chunked (the property the hypothesis suite pins).
    """

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[RendezvousMessage]:
        self._buf.extend(data)
        out = []
        while True:
            got = RendezvousMessage.decode(bytes(self._buf))
            if got is None:
                return out
            msg, used = got
            del self._buf[:used]
            out.append(msg)


def encode_join(uid: int, host: str, port: int) -> bytes:
    hb = host.encode()
    return struct.pack(_JOIN_FMT, uid, port) + hb


def decode_join(payload: bytes) -> tuple[int, str, int]:
    if len(payload) < struct.calcsize(_JOIN_FMT):
        raise RendezvousError("truncated JOIN payload")
    uid, port = struct.unpack_from(_JOIN_FMT, payload)
    return uid, payload[struct.calcsize(_JOIN_FMT):].decode(), port


# -------------------------------------------------------------- membership
@dataclasses.dataclass(frozen=True)
class Member:
    """One live rank slot."""
    rank: int
    uid: int
    host: str = ""
    port: int = 0
    since: int = 0          # first barrier tag this member is required at


@dataclasses.dataclass(frozen=True)
class Membership:
    """A generation-stamped snapshot of the live world."""
    generation: int
    world_size: int
    members: tuple[Member, ...] = ()

    def live_ranks(self) -> tuple[int, ...]:
        return tuple(m.rank for m in self.members)

    def is_live(self, rank: int) -> bool:
        return any(m.rank == rank for m in self.members)

    def addr_of(self, rank: int) -> tuple[str, int] | None:
        for m in self.members:
            if m.rank == rank:
                return (m.host, m.port)
        return None

    def encode(self) -> bytes:
        out = [struct.pack(_BLOB_FMT, self.generation, self.world_size,
                           len(self.members))]
        for m in self.members:
            hb = m.host.encode()
            if len(hb) > 0xFF:
                raise RendezvousError(f"host {m.host!r} too long")
            out.append(struct.pack(_MEMBER_FMT, m.rank, m.uid, m.port,
                                   m.since, len(hb)) + hb)
        return b"".join(out)

    @classmethod
    def decode(cls, payload: bytes) -> "Membership":
        base = struct.calcsize(_BLOB_FMT)
        if len(payload) < base:
            raise RendezvousError("truncated membership blob")
        generation, world, count = struct.unpack_from(_BLOB_FMT, payload)
        off, members = base, []
        msz = struct.calcsize(_MEMBER_FMT)
        for _ in range(count):
            if len(payload) < off + msz:
                raise RendezvousError("truncated membership member")
            rank, uid, port, since, hlen = struct.unpack_from(
                _MEMBER_FMT, payload, off)
            off += msz
            if len(payload) < off + hlen:
                raise RendezvousError("truncated member host")
            host = payload[off:off + hlen].decode()
            off += hlen
            members.append(Member(rank=rank, uid=uid, host=host, port=port,
                                  since=since))
        return cls(generation=generation, world_size=world,
                   members=tuple(members))


class StaticMembership:
    """The fixed-world view: every rank of an ``n``-peer job is live.

    What a :class:`~repro_torch.net.peer.HostPeer` without a rendezvous gets —
    exactly the pre-refactor "fixed peer list" behavior.
    """

    def __init__(self, n: int):
        self.n = int(n)
        self.generation = 0

    def is_live(self, rank: int) -> bool:
        return 0 <= rank < self.n

    def addr_of(self, rank: int) -> tuple[str, int] | None:
        return None


# ----------------------------------------------------- pure state machine
@dataclasses.dataclass
class _Slot:
    uid: int
    host: str
    port: int
    since: int
    last_seen: float


class RendezvousState:
    """Transport-free membership + barrier core (see module docstring).

    Every mutation is synchronous and deterministic; the TCP and in-memory
    shells serialize calls (one server thread / one lock), and the property
    suite drives this class directly with arbitrary interleavings.
    """

    def __init__(self, world_size: int, *,
                 phases_per_step: int = PHASES_PER_STEP,
                 heartbeat_timeout: float = 6.0,
                 wait_for: int | None = None):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        self.world_size = int(world_size)
        self.phases = int(phases_per_step)
        self.heartbeat_timeout = float(heartbeat_timeout)
        #: members needed before the *first* barrier may release (the
        #: initial gather — torch-style init waits for the full world)
        self.wait_for = self.world_size if wait_for is None else int(wait_for)
        self.generation = 0
        self.started = False
        self.max_tag = -1
        self._slots: dict[int, _Slot] = {}
        self._arrivals: dict[int, set[int]] = {}

    # ------------------------------------------------------------- queries
    def live_ranks(self) -> tuple[int, ...]:
        return tuple(sorted(self._slots))

    def latest_step(self) -> int:
        return self.max_tag // self.phases if self.max_tag >= 0 else -1

    def membership(self) -> Membership:
        return Membership(
            generation=self.generation, world_size=self.world_size,
            members=tuple(Member(rank=r, uid=s.uid, host=s.host, port=s.port,
                                 since=s.since)
                          for r, s in sorted(self._slots.items())))

    # ----------------------------------------------------------- mutations
    def join(self, uid: int, host: str, port: int,
             now: float) -> tuple[int, int]:
        """Claim the lowest free rank slot; returns ``(rank, since_tag)``.

        The initial cohort (pre-start) is required from tag 0; a joiner of
        a running group only from the next step boundary — fences already
        in flight must never start waiting on it retroactively.
        """
        free = [r for r in range(self.world_size) if r not in self._slots]
        if not free:
            raise RendezvousFull(
                f"all {self.world_size} rank slots are held")
        rank = free[0]
        since = 0 if not self.started else \
            (self.max_tag // self.phases + 1) * self.phases
        self._slots[rank] = _Slot(uid=uid, host=host, port=port, since=since,
                                  last_seen=now)
        self.generation += 1
        self._maybe_start()
        return rank, since

    def leave(self, rank: int) -> bool:
        return self._remove(rank)

    def dead(self, rank: int) -> bool:
        return self._remove(rank)

    def _remove(self, rank: int) -> bool:
        if rank not in self._slots:
            return False
        del self._slots[rank]
        self.generation += 1
        return True

    def heartbeat(self, rank: int, now: float) -> None:
        slot = self._slots.get(rank)
        if slot is not None:
            slot.last_seen = now

    def expire(self, now: float) -> list[int]:
        """Ranks silent past the heartbeat timeout, removed as deaths."""
        gone = [r for r, s in self._slots.items()
                if now - s.last_seen > self.heartbeat_timeout]
        for r in gone:
            self._remove(r)
        return gone

    # ------------------------------------------------------------ barriers
    def barrier_arrive(self, rank: int, tag: int) -> None:
        if rank not in self._slots:
            return
        self.max_tag = max(self.max_tag, int(tag))
        self._arrivals.setdefault(int(tag), set()).add(rank)

    def _maybe_start(self) -> None:
        if not self.started and len(self._slots) >= self.wait_for:
            self.started = True

    def release_ready(self) -> dict[int, tuple[int, ...]]:
        """Barrier tags whose every required live member has arrived.

        Returns ``{tag: ranks_to_notify}`` (arrived ranks still live) and
        retires those tags.  Call after every arrival *and* every
        membership change — a death is what releases a fence the group was
        holding for the dead peer.
        """
        self._maybe_start()
        if not self.started:
            return {}
        out = {}
        for tag in sorted(self._arrivals):
            need = {r for r, s in self._slots.items() if s.since <= tag}
            arrived = self._arrivals[tag]
            if need and need <= arrived:
                out[tag] = tuple(sorted(arrived & set(self._slots)))
        for tag in out:
            del self._arrivals[tag]
        return out


# ----------------------------------------------------------- TCP transport
def tcp_available() -> bool:
    """Can this process bind a localhost TCP socket?"""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", 0))
        finally:
            s.close()
        return True
    except OSError:
        return False


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.fb = FrameBuffer()
        self.rank: int | None = None


class RendezvousServer:
    """TCP shell around :class:`RendezvousState` — one coordinator thread.

    Death detection is two-layer: a SIGKILLed peer's socket EOF arrives
    within one select tick (the fast path the smoke test exercises), and
    heartbeat expiry catches half-open connections the kernel never
    closes.
    """

    def __init__(self, world_size: int, *, host: str = "127.0.0.1",
                 port: int = 0, phases_per_step: int = PHASES_PER_STEP,
                 heartbeat_timeout: float = 6.0, wait_for: int | None = None,
                 tick: float = 0.2):
        self._lock = threading.Lock()
        self.state = RendezvousState(world_size,
                                     phases_per_step=phases_per_step,
                                     heartbeat_timeout=heartbeat_timeout,
                                     wait_for=wait_for)
        self.tick = float(tick)
        self._sel = selectors.DefaultSelector()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(world_size * 2 + 4)
        self._listener.setblocking(False)
        self.addr: tuple[str, int] = self._listener.getsockname()
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._conns: dict[socket.socket, _Conn] = {}
        self._closing = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rendezvous-server")
        self._thread.start()

    # ------------------------------------------------------ parent queries
    def latest_step(self) -> int:
        with self._lock:
            return self.state.latest_step()

    def live_ranks(self) -> tuple[int, ...]:
        with self._lock:
            return self.state.live_ranks()

    def generation(self) -> int:
        with self._lock:
            return self.state.generation

    def close(self) -> None:
        self._closing = True
        self._thread.join(timeout=5.0)
        for conn in list(self._conns):
            self._drop_sock(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        self._listener.close()
        self._sel.close()

    # --------------------------------------------------------- server loop
    def _run(self) -> None:
        while not self._closing:
            for key, _ in self._sel.select(self.tick):
                if key.fileobj is self._listener:
                    self._accept()
                else:
                    self._read(key.fileobj)
            with self._lock:
                gone = self.state.expire(time.monotonic())
            for rank in gone:
                self._after_death(rank)

    def _accept(self) -> None:
        try:
            sock, _ = self._listener.accept()
        except OSError:
            return
        sock.setblocking(True)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conns[sock] = _Conn(sock)
        self._sel.register(sock, selectors.EVENT_READ, None)

    def _read(self, sock: socket.socket) -> None:
        conn = self._conns.get(sock)
        if conn is None:
            return
        try:
            data = sock.recv(1 << 16)
        except OSError:
            data = b""
        if not data:                                # EOF = death
            self._drop_conn(conn)
            return
        try:
            msgs = conn.fb.feed(data)
        except RendezvousError:
            self._drop_conn(conn)
            return
        for msg in msgs:
            self._handle(conn, msg)

    def _drop_sock(self, sock: socket.socket) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass

    def _drop_conn(self, conn: _Conn) -> None:
        rank = conn.rank
        self._drop_sock(conn.sock)
        if rank is None:
            return
        with self._lock:
            removed = self.state.dead(rank)
        if removed:
            self._after_death(rank)

    def _after_death(self, rank: int) -> None:
        self._broadcast_update(EV_DEATH, rank)
        self._release_ready()

    # ----------------------------------------------------------- messaging
    def _send(self, conn: _Conn, msg: RendezvousMessage) -> None:
        try:
            conn.sock.sendall(msg.encode())
        except OSError:
            self._drop_conn(conn)

    def _rank_conns(self) -> dict[int, _Conn]:
        return {c.rank: c for c in self._conns.values() if c.rank is not None}

    def _broadcast_update(self, event: int, subject_rank: int) -> None:
        with self._lock:
            mem = self.state.membership()
        msg = RendezvousMessage(kind=MSG_UPDATE, rank=subject_rank,
                                world=mem.world_size,
                                generation=mem.generation, seq=event,
                                payload=mem.encode())
        for conn in list(self._rank_conns().values()):
            if conn.rank != subject_rank:
                self._send(conn, msg)

    def _release_ready(self) -> None:
        with self._lock:
            ready = self.state.release_ready()
            mem = self.state.membership()
        if not ready:
            return
        by_rank = self._rank_conns()
        for tag, ranks in ready.items():
            msg = RendezvousMessage(kind=MSG_RELEASE, world=mem.world_size,
                                    generation=mem.generation, seq=tag,
                                    payload=mem.encode())
            for r in ranks:
                conn = by_rank.get(r)
                if conn is not None:
                    self._send(conn, msg)

    def _handle(self, conn: _Conn, msg: RendezvousMessage) -> None:
        if msg.kind == MSG_JOIN:
            uid, host, port = decode_join(msg.payload)
            if not host:
                host = conn.sock.getpeername()[0]
            try:
                with self._lock:
                    rank, since = self.state.join(uid, host, port,
                                                  time.monotonic())
                    mem = self.state.membership()
            except RendezvousFull as e:
                self._send(conn, RendezvousMessage(
                    kind=MSG_REJECT, payload=str(e).encode()))
                return
            conn.rank = rank
            self._send(conn, RendezvousMessage(
                kind=MSG_WELCOME, rank=rank, world=mem.world_size,
                generation=mem.generation, seq=since, payload=mem.encode()))
            self._broadcast_update(EV_JOIN, rank)
            self._release_ready()
        elif msg.kind == MSG_HEARTBEAT:
            if conn.rank is not None:
                with self._lock:
                    self.state.heartbeat(conn.rank, time.monotonic())
        elif msg.kind == MSG_LEAVE:
            rank = conn.rank
            conn.rank = None                  # a LEAVE'd conn is not a death
            self._drop_sock(conn.sock)
            if rank is not None:
                with self._lock:
                    removed = self.state.leave(rank)
                if removed:
                    self._broadcast_update(EV_LEAVE, rank)
                    self._release_ready()
        elif msg.kind == MSG_BARRIER:
            if conn.rank is not None:
                with self._lock:
                    self.state.barrier_arrive(conn.rank, msg.seq)
                self._release_ready()
        # WELCOME/UPDATE/RELEASE/REJECT are server->client only: ignore


class _ClientCore:
    """Shared client-side view state: max-generation membership snapshot,
    drained event queue, released barrier tags."""

    def __init__(self):
        self.cv = threading.Condition()
        self.membership: Membership | None = None
        self.events: deque[tuple[str, int, int]] = deque()
        self.released: set[int] = set()
        self.error: Exception | None = None

    def apply(self, mem: Membership, event: tuple[str, int, int] | None
              ) -> None:
        with self.cv:
            # duplicate / out-of-order UPDATE invariance: only a strictly
            # newer generation can move the snapshot
            if self.membership is None or \
                    mem.generation > self.membership.generation:
                self.membership = mem
            if event is not None:
                self.events.append(event)
            self.cv.notify_all()

    def release(self, tag: int, mem: Membership) -> None:
        with self.cv:
            if self.membership is None or \
                    mem.generation > self.membership.generation:
                self.membership = mem
            self.released.add(tag)
            if len(self.released) > 4 * PHASES_PER_STEP:
                for old in sorted(self.released)[:-2 * PHASES_PER_STEP]:
                    self.released.discard(old)
            self.cv.notify_all()

    def fail(self, exc: Exception) -> None:
        with self.cv:
            if self.error is None:
                self.error = exc
            self.cv.notify_all()


class RendezvousClient:
    """One peer's TCP connection to the coordinator + its membership view.

    Doubles as the :class:`~repro_torch.net.peer.HostPeer` membership view
    (``is_live`` / ``generation``) and the :class:`~repro_torch.net.udp.
    UdpProcessBackend` address resolver (``addr_of``).
    """

    def __init__(self, addr: tuple[str, int], *, uid: int,
                 peer_host: str = "127.0.0.1", peer_port: int = 0,
                 heartbeat_interval: float = 1.0,
                 connect_timeout: float = 20.0):
        self.uid = int(uid)
        self.peer_host = peer_host
        self.peer_port = int(peer_port)
        self.heartbeat_interval = float(heartbeat_interval)
        self.rank: int | None = None
        self.start_step: int | None = None
        self._core = _ClientCore()
        self._send_lock = threading.Lock()
        self._closed = False
        deadline = time.monotonic() + connect_timeout
        while True:                 # the coordinator may not be up yet
            try:
                self._sock = socket.create_connection(addr, timeout=2.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise RendezvousTimeout(
                        f"could not reach coordinator at {addr}")
                time.sleep(0.05)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(0.2)
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"rendezvous-client-{uid}")
        self._reader.start()

    # ----------------------------------------------------------- transport
    def _send(self, msg: RendezvousMessage) -> None:
        with self._send_lock:
            try:
                self._sock.sendall(msg.encode())
            except OSError as e:
                self._core.fail(RendezvousError(f"coordinator send: {e}"))
                raise self._core.error from e

    def _read_loop(self) -> None:
        fb = FrameBuffer()
        last_hb = time.monotonic()
        while not self._closed:
            now = time.monotonic()
            if self.rank is not None and \
                    now - last_hb >= self.heartbeat_interval:
                last_hb = now
                try:
                    self._send(RendezvousMessage(kind=MSG_HEARTBEAT,
                                                 rank=self.rank))
                except RendezvousError:
                    return
            try:
                data = self._sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                data = b""
            if not data:
                if not self._closed:
                    self._core.fail(RendezvousError("coordinator hung up"))
                return
            try:
                msgs = fb.feed(data)
            except RendezvousError as e:
                self._core.fail(e)
                return
            for msg in msgs:
                self._dispatch(msg)

    def _dispatch(self, msg: RendezvousMessage) -> None:
        if msg.kind == MSG_WELCOME:
            mem = Membership.decode(msg.payload)
            with self._core.cv:
                self.rank = msg.rank
                self.start_step = msg.seq // PHASES_PER_STEP
            self._core.apply(mem, None)
        elif msg.kind == MSG_UPDATE:
            mem = Membership.decode(msg.payload)
            name = _EVENT_NAMES.get(msg.seq, "death")
            self._core.apply(mem, (name, msg.rank, msg.generation))
        elif msg.kind == MSG_RELEASE:
            self._core.release(msg.seq, Membership.decode(msg.payload))
        elif msg.kind == MSG_REJECT:
            self._core.fail(RendezvousFull(msg.payload.decode() or
                                           "join rejected"))

    # ------------------------------------------------------------ protocol
    def join(self, timeout: float = 30.0) -> tuple[int, Membership, int]:
        """Claim a rank; returns ``(rank, membership, start_step)``."""
        self._send(RendezvousMessage(
            kind=MSG_JOIN,
            payload=encode_join(self.uid, self.peer_host, self.peer_port)))
        deadline = time.monotonic() + timeout
        with self._core.cv:
            while self.rank is None:
                if self._core.error is not None:
                    raise self._core.error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RendezvousTimeout("join: no WELCOME from "
                                            "coordinator")
                self._core.cv.wait(remaining)
            return self.rank, self._core.membership, self.start_step

    def barrier(self, tag: int, timeout: float = 120.0) -> None:
        """Arrive at barrier ``tag`` and block until the coordinator
        releases it (all required live members arrived)."""
        self._send(RendezvousMessage(kind=MSG_BARRIER, rank=self.rank or 0,
                                     seq=tag))
        deadline = time.monotonic() + timeout
        with self._core.cv:
            while tag not in self._core.released:
                if self._core.error is not None:
                    raise self._core.error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RendezvousTimeout(f"barrier tag {tag} not "
                                            f"released in {timeout}s")
                self._core.cv.wait(remaining)
            self._core.released.discard(tag)

    def events(self) -> list[tuple[str, int, int]]:
        """Drain pending membership events: ``(kind, rank, generation)``."""
        with self._core.cv:
            out = list(self._core.events)
            self._core.events.clear()
        return out

    # ----------------------------------------------------- membership view
    @property
    def generation(self) -> int:
        with self._core.cv:
            return 0 if self._core.membership is None else \
                self._core.membership.generation

    def membership(self) -> Membership | None:
        with self._core.cv:
            return self._core.membership

    def is_live(self, rank: int) -> bool:
        with self._core.cv:
            return self._core.membership is None or \
                self._core.membership.is_live(rank)

    def addr_of(self, rank: int) -> tuple[str, int] | None:
        with self._core.cv:
            return None if self._core.membership is None else \
                self._core.membership.addr_of(rank)

    # ------------------------------------------------------------ shutdown
    def leave(self) -> None:
        try:
            self._send(RendezvousMessage(kind=MSG_LEAVE,
                                         rank=self.rank or 0))
        except RendezvousError:
            pass
        self.close()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------- in-memory shell
class LocalCoordinator:
    """In-memory twin of :class:`RendezvousServer` for a socket-free
    launch path: same :class:`RendezvousState`, same
    client API (:class:`LocalClient` mirrors :class:`RendezvousClient`),
    Condition-based instead of TCP.  A thread "process" that crashes calls
    :meth:`LocalClient.crash` — the EOF analogue."""

    def __init__(self, world_size: int, *,
                 phases_per_step: int = PHASES_PER_STEP,
                 wait_for: int | None = None):
        self._cv = threading.Condition()
        self.state = RendezvousState(world_size,
                                     phases_per_step=phases_per_step,
                                     wait_for=wait_for)
        self._released: dict[int, Membership] = {}
        self._clients: list["LocalClient"] = []

    def client(self, uid: int) -> "LocalClient":
        c = LocalClient(self, uid)
        with self._cv:
            self._clients.append(c)
        return c

    def latest_step(self) -> int:
        with self._cv:
            return self.state.latest_step()

    def live_ranks(self) -> tuple[int, ...]:
        with self._cv:
            return self.state.live_ranks()

    def close(self) -> None:
        pass

    # called with self._cv held
    def _after_change(self, event: tuple[str, int, int] | None,
                      subject: "LocalClient | None") -> None:
        for tag in self.state.release_ready():
            self._released[tag] = self.state.membership()
        if len(self._released) > 64:
            for old in sorted(self._released)[:-32]:
                del self._released[old]
        mem = self.state.membership()
        for c in self._clients:
            if c is subject or c.dead:
                continue
            c._membership = mem
            if event is not None:
                c._events.append(event)
        self._cv.notify_all()


class LocalClient:
    """In-memory mirror of :class:`RendezvousClient` (same duck type)."""

    def __init__(self, coord: LocalCoordinator, uid: int):
        self._coord = coord
        self.uid = int(uid)
        self.rank: int | None = None
        self.start_step: int | None = None
        self.dead = False
        self._membership: Membership | None = None
        self._events: deque[tuple[str, int, int]] = deque()

    def join(self, timeout: float = 30.0) -> tuple[int, Membership, int]:
        co, st = self._coord, self._coord.state
        with co._cv:
            rank, since = st.join(self.uid, "", 0, now=0.0)
            self.rank = rank
            self.start_step = since // st.phases
            self._membership = st.membership()
            co._after_change(("join", rank, st.generation), self)
            return rank, self._membership, self.start_step

    def barrier(self, tag: int, timeout: float = 120.0) -> None:
        co, st = self._coord, self._coord.state
        deadline = time.monotonic() + timeout
        with co._cv:
            st.barrier_arrive(self.rank, tag)
            co._after_change(None, None)
            while tag not in co._released:
                if self.dead:
                    raise RendezvousError("client crashed")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RendezvousTimeout(f"barrier tag {tag} not "
                                            f"released in {timeout}s")
                co._cv.wait(remaining)
            mem = co._released[tag]
            if self._membership is None or \
                    mem.generation > self._membership.generation:
                self._membership = mem

    def events(self) -> list[tuple[str, int, int]]:
        with self._coord._cv:
            out = list(self._events)
            self._events.clear()
        return out

    @property
    def generation(self) -> int:
        with self._coord._cv:
            return 0 if self._membership is None else \
                self._membership.generation

    def membership(self) -> Membership | None:
        with self._coord._cv:
            return self._membership

    def is_live(self, rank: int) -> bool:
        with self._coord._cv:
            return self._membership is None or self._membership.is_live(rank)

    def addr_of(self, rank: int) -> tuple[str, int] | None:
        return None

    def leave(self) -> None:
        self._end("leave")

    def crash(self) -> None:
        """Simulate a process death (the TCP-EOF analogue)."""
        self._end("death")

    def close(self) -> None:
        pass

    def _end(self, how: str) -> None:
        co, st = self._coord, self._coord.state
        with co._cv:
            if self.dead or self.rank is None:
                return
            self.dead = True
            removed = st.leave(self.rank) if how == "leave" \
                else st.dead(self.rank)
            if removed:
                co._after_change((how, self.rank, st.generation), self)
