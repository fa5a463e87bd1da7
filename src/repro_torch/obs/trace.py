"""Structured trace recorder: typed span/event records in a preallocated
host-side ring buffer (DESIGN §12).

The port's copy of ``src/repro/obs/trace.py``.

The recorder is *host* state (like the ControlPlane — XLA cannot observe
deadlines or policy decisions) and is **off by default**.  The contract at
every hot call site is a single ``None`` check::

    tr = trace.get_tracer()          # None when tracing is disabled
    ...
    if tr is not None:
        tr.complete("round", "wire", ts=t0, dur=t1 - t0, tid=rank,
                    args={"sender": s, "frac": f})

``get_tracer()`` reads one module-global reference, so the disabled path
costs one function call + one identity test per call *site* — and sites
that fire per packet hoist the lookup out of the loop entirely (fetch the
tracer once per exchange, guard each record with ``if tr is not None``,
which is a local-variable ``is`` test: a few nanoseconds).

Record schema (one tuple per record, allocated only when tracing is ON)::

    (ph, ts, dur, name, cat, tid, args)

    ph    "X" complete span | "i" instant event | "C" counter sample
    ts    start time in the producer's clock (seconds; see below)
    dur   span duration in the same clock ("X" only; 0.0 otherwise)
    name  event name ("round", "encode", "eject", ...)
    cat   category: "wire" | "policy" | "trainer" | "sim" — the category
          is also the *clock domain*: wire events carry the backend clock
          (virtual seconds on inproc, monotonic on UDP), trainer/policy
          events the tracer clock, sim events the simulator's virtual ms.
          Cross-category ordering is therefore only meaningful per domain;
          the exporters keep categories on separate Perfetto tracks.
    tid   logical lane inside this process (peer rank for wire events)
    args  small JSON-safe dict or None

The buffer is a fixed ``capacity`` list allocated once at ``configure``;
when it wraps, the oldest records are overwritten and ``Tracer.dropped``
counts what was lost — recording never allocates beyond the record tuple
and never blocks on I/O.  Export is explicit (``repro_torch.obs.export``).

Env activation (for launchers that cannot thread a flag):
``REPRO_TRACE=1`` enables at import, ``REPRO_TRACE_CAPACITY`` sizes the
ring.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["TraceConfig", "Tracer", "Span", "configure", "configure_thread",
           "get_tracer", "is_enabled", "reset"]

DEFAULT_CAPACITY = 1 << 16


class TraceConfig:
    """Process-global tracing configuration (see :func:`configure`)."""

    def __init__(self, enabled: bool = False,
                 capacity: int = DEFAULT_CAPACITY, rank: int = 0,
                 clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.clock = clock


class Span:
    """Context manager emitting one complete ("X") record at exit.

    ``set(key=value)`` attaches args discovered mid-span (e.g. the round's
    observed loss fraction).
    """
    __slots__ = ("_tracer", "name", "cat", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int,
                 args: dict | None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self._t0 = 0.0

    def set(self, **kw) -> "Span":
        if self.args is None:
            self.args = {}
        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self._tracer.now()
        self._tracer.complete(self.name, self.cat, ts=self._t0,
                              dur=t1 - self._t0, tid=self.tid,
                              args=self.args)


class _NopSpan:
    """Shared allocation-free stand-in returned by :func:`span` when
    tracing is disabled — ``with trace.span(...)`` costs one dict lookup
    and two no-op calls."""
    __slots__ = ()

    def set(self, **kw) -> "_NopSpan":
        return self

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOP_SPAN = _NopSpan()


class Tracer:
    """Ring-buffered trace recorder (see module docstring)."""

    def __init__(self, config: TraceConfig):
        self.capacity = config.capacity
        self.rank = config.rank
        self.clock = config.clock
        self._buf: list = [None] * self.capacity   # preallocated ring
        self._n = 0
        self._lock = threading.Lock()
        self.dropped = 0

    # ------------------------------------------------------------ recording
    def now(self) -> float:
        return self.clock()

    def _push(self, rec: tuple) -> None:
        with self._lock:
            i = self._n
            self._n = i + 1
            if i >= self.capacity:
                self.dropped += 1
            self._buf[i % self.capacity] = rec

    def complete(self, name: str, cat: str, *, ts: float, dur: float,
                 tid: int = 0, args: dict | None = None) -> None:
        """One finished span with an explicit start/duration — the raw API
        for producers with their own clock (wire peers, the simulator)."""
        self._push(("X", float(ts), float(max(dur, 0.0)), name, cat,
                    int(tid), args))

    def event(self, name: str, cat: str, *, ts: float | None = None,
              tid: int = 0, args: dict | None = None) -> None:
        """One instant event (policy decision, timeout, phase change)."""
        self._push(("i", self.clock() if ts is None else float(ts), 0.0,
                    name, cat, int(tid), args))

    def counter(self, name: str, value: float, *, ts: float | None = None,
                cat: str = "metrics") -> None:
        """One counter sample (renders as a Perfetto counter track)."""
        self._push(("C", self.clock() if ts is None else float(ts), 0.0,
                    name, cat, 0, {"value": float(value)}))

    def span(self, name: str, cat: str = "trainer", *, tid: int = 0,
             **args) -> Span:
        """Nestable context-manager span on the tracer's own clock."""
        return Span(self, name, cat, tid, args or None)

    # -------------------------------------------------------------- reading
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def records(self) -> list[tuple]:
        """Records in arrival order (oldest surviving first)."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [r for r in self._buf[:n]]
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0
            self.dropped = 0


# ------------------------------------------------------- process-global state
_tracer: Tracer | None = None
_tls = threading.local()
_tls_active = False        # any thread-local tracer installed this process


def configure(enabled: bool = True, *, capacity: int = DEFAULT_CAPACITY,
              rank: int = 0, clock=time.perf_counter) -> Tracer | None:
    """Install (or tear down) the process-global tracer.  Returns it, or
    None when ``enabled=False`` — after which every ``get_tracer()`` site
    is back on the few-ns disabled path."""
    global _tracer
    if not enabled:
        _tracer = None
        return None
    _tracer = Tracer(TraceConfig(enabled=True, capacity=capacity, rank=rank,
                                 clock=clock))
    return _tracer


def configure_thread(enabled: bool = True, *,
                     capacity: int = DEFAULT_CAPACITY, rank: int = 0,
                     clock=time.perf_counter) -> Tracer | None:
    """Install a tracer for the *calling thread* only — ``get_tracer()``
    on this thread prefers it over the process-global one.

    This is how the multiproc launcher's inproc mode (N rank-threads in
    one process) keeps per-rank traces separate: each worker thread gets
    its own ring, written to its own ``trace_rankNN.json``.  Threads
    without a thread-local tracer still see the global one, so a fully
    disabled process pays only one extra (False) branch per call site.
    """
    global _tls_active
    if not enabled:
        _tls.tracer = None
        return None
    _tls_active = True
    t = Tracer(TraceConfig(enabled=True, capacity=capacity, rank=rank,
                           clock=clock))
    _tls.tracer = t
    return t


def get_tracer() -> Tracer | None:
    """THE hot-path gate: this thread's tracer (if one was installed via
    :func:`configure_thread`), else the process tracer, else None."""
    if _tls_active:
        t = getattr(_tls, "tracer", None)
        if t is not None:
            return t
    return _tracer


def is_enabled() -> bool:
    return get_tracer() is not None


def span(name: str, cat: str = "trainer", *, tid: int = 0, **args):
    """Convenience span against the global tracer; allocation-free no-op
    when tracing is disabled (for call sites that are not hot enough to
    hoist the :func:`get_tracer` check)."""
    tr = _tracer
    if tr is None:
        return _NOP_SPAN
    return tr.span(name, cat, tid=tid, **args)


def event(name: str, cat: str = "trainer", *, ts: float | None = None,
          tid: int = 0, args: dict | None = None) -> None:
    """Convenience instant event against the global tracer (no-op when
    disabled)."""
    tr = _tracer
    if tr is not None:
        tr.event(name, cat, ts=ts, tid=tid, args=args)


def reset() -> None:
    """Tear down the global + this thread's tracer (tests)."""
    global _tracer, _tls_active
    _tracer = None
    _tls_active = False
    _tls.tracer = None


# env activation: REPRO_TRACE=1 python -m ... (launchers without a flag)
if os.environ.get("REPRO_TRACE", "").strip() not in ("", "0", "false",
                                                     "False"):
    configure(True, capacity=int(os.environ.get("REPRO_TRACE_CAPACITY",
                                                DEFAULT_CAPACITY)))
