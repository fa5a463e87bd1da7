"""The ``Backend`` protocol: how datagrams move between host peers.

The port's copy of ``src/repro/net/backend.py``.

A backend is a best-effort datagram fabric for ``n_peers`` ranks.  Sends
never block and may silently lose packets; receives are pull-based with a
clock, so the peer's receive loop can enforce the UBT per-round deadline
(``AdaptiveTimeout.round_deadline``) uniformly over both implementations:

* :class:`~repro_torch.net.inproc.InprocBackend` — deterministic in-memory
  loopback with *virtual* time: every receive phase starts at t=0 and a
  packet's arrival time is its scripted delay, so CI runs are exactly
  reproducible (scripted per-peer drop/delay schedules stand in for the
  network).
* :class:`~repro_torch.net.udp.UdpBackend` — real non-blocking UDP sockets on
  localhost with wall-clock (monotonic) time.

``barrier`` is the host-side phase fence the threaded rings use between
send and receive phases (a real launcher gets the same fence from its
bootstrap rendezvous); CTRL-kind packets (quantization grids) bypass any
scripted loss — they model the small reliable control channel, not the
bulk gradient stream.
"""
from __future__ import annotations

import threading


class Backend:
    """Base datagram fabric (see module docstring for the contract)."""

    #: ranks this fabric connects
    n_peers: int = 0
    #: True when poll() after a phase fence returns every arrival at once
    #: (virtual time); False when time must really pass between polls
    virtual_time: bool = True

    def send(self, src: int, dst: int, datagram: bytes) -> None:
        """Best-effort, non-blocking: the datagram may never arrive."""
        raise NotImplementedError

    def poll(self, me: int) -> list[tuple[bytes, float]]:
        """Drain pending datagrams as (datagram, arrival_time) pairs."""
        raise NotImplementedError

    def now(self, me: int) -> float:
        """The receive clock poll() timestamps are measured on."""
        raise NotImplementedError

    def wait(self, me: int, timeout: float) -> bool:
        """Let time advance; False when no further arrivals can come
        (virtual-time backends return False after the phase's single
        drain — the receive loop must evaluate what it has)."""
        raise NotImplementedError

    def barrier(self, timeout: float | None = None) -> None:
        """Phase fence across all peers (threaded rings only)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class PhaseBarrier:
    """A reusable all-peer fence with a deadlock bound: on timeout every
    waiter gets ``BrokenBarrierError`` and the peer masks the whole phase
    instead of hanging (missing -> masked, never blocked)."""

    def __init__(self, n_peers: int):
        self._barrier = threading.Barrier(n_peers)

    def wait(self, timeout: float | None = None) -> None:
        self._barrier.wait(timeout=timeout)
