"""HostRing: N host peers over one wire backend, plus the bridge that
feeds wire-observed masks into the sync engine (DESIGN §7).

Counterpart of ``src/repro/net/host_ring.py``. Two modes of operation:

* **Standalone host datapath** — :meth:`HostRing.allreduce` runs one full
  TAR allreduce where every byte really crosses the backend: encode →
  packetized stage-1 exchange under adaptive deadlines → compensated
  reduce → packetized stage-2 broadcast → decode, one thread per peer with
  phase fences.  With the inproc backend and scripted drops this is
  bitwise-identical to ``sync_packed`` under ``Lossy`` given the same
  arrival masks (the subsystem's pinned parity result).

* **Bridge for the sync engine** — :meth:`bridge_exchange` is the
  ``WireTransport`` target.  The engine holds all N peers in one stack,
  so a bucket is ONE call with the ``(N, N, S)`` stage-1 shard stack: the
  call copies it to the host, queues it for the ring's worker thread, which
  really exchanges the bytes, and returns the observed ``(N, N, S)``
  arrival mask of the *previous* exchange on the stack's device (see the
  comment block at the bridge section); the engine's collectives keep
  moving the authoritative data.  Per-peer/per-round telemetry accumulates
  on the ring and :meth:`drain_telemetry` folds it into a fully-populated
  :class:`~repro_torch.runtime.StepTelemetry` for the ControlPlane.

All telemetry times are in the backend's clock units (scripted virtual
seconds for inproc, monotonic seconds for UDP); the controllers only ever
compare them against each other.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core.pipeline import (CollectiveSpec, ThreefryDraws,
                                       OptiReduceConfig, WireTransport,
                                       resolve_spec)
from repro_torch.core.ubt import AdaptiveTimeout, LossBudget
from repro_torch.kernels.runtime import resolve_device
from repro_torch.runtime import StepTelemetry

from .backend import Backend
from .inproc import InprocBackend
from .peer import HostPeer, PeerReport
from .udp import UdpBackend


def make_backend(kind: str | Backend, n_peers: int, *, drop_fn=None,
                 delay_fn=None, scramble_seed=None) -> Backend:
    """Build a backend by name (``inproc`` | ``udp``) or pass one through."""
    if isinstance(kind, Backend):
        return kind
    if kind == "inproc":
        return InprocBackend(n_peers, drop_fn=drop_fn, delay_fn=delay_fn)
    if kind == "udp":
        return UdpBackend(n_peers, drop_fn=drop_fn,
                          scramble_seed=scramble_seed)
    raise ValueError(f"unknown backend {kind!r} (inproc | udp)")


def aggregate_reports(reports: list[PeerReport], step: int) -> StepTelemetry:
    """Cross-receiver fold of per-peer wire observations: a round completes
    when its slowest receiver does; a peer's stage time is the worst any
    receiver waited on it.  Used by :class:`HostRing` (all N receivers in
    one process) and by a multi-process worker (a single
    receiver's report — each process only observes its own rounds)."""
    n_rounds = max((len(r.rounds) for r in reports), default=0)
    round_times, round_to, round_frac = [], [], []
    for i in range(n_rounds):
        rs = [r.rounds[i] for r in reports if i < len(r.rounds)]
        round_times.append(max(x.time for x in rs))
        round_to.append(any(x.timed_out for x in rs))
        round_frac.append(float(np.mean([x.frac_received for x in rs])))
    # a report with no arrival observations at all carries
    # sender_last_t=None (e.g. a freshly-constructed PeerReport merged
    # from zero exchanges); fold only the observing reports, and when
    # none observed anything emit peer_stage_times=None — the
    # StragglerDetector holds state on missing input, exactly as on an
    # all-NaN column (a peer no receiver saw)
    observed = [r.sender_last_t for r in reports
                if r.sender_last_t is not None]
    if observed:
        last = np.stack(observed)                               # (R, n)
        # a rank no receiver observed (skipped as dead) keeps NaN without
        # the nanmax all-NaN-slice warning
        seen = ~np.all(np.isnan(last), axis=0)
        peer_times = np.full(last.shape[1], np.nan)
        peer_times[seen] = np.nanmax(last[:, seen], axis=0)     # (n,)
        peer_times = tuple(float(t) for t in peer_times)
    else:
        peer_times = None
    dropped = sum(r.dropped for r in reports)
    total = sum(r.total for r in reports)
    # union of link-fault suspects across receivers — the ControlPlane's
    # link-health tracker turns repeated observations into dead_links
    events = tuple(sorted({l for r in reports for l in r.lost_links}))
    return StepTelemetry.from_wire(
        step=step,
        dead_link_events=events,
        round_times=tuple(round_times),
        round_timed_out=tuple(round_to),
        round_frac_received=tuple(round_frac),
        peer_stage_times=peer_times,
        dropped=float(dropped), total=float(total),
        # the §3.2.1 warmup profiles *stage* (round) times — feed the
        # slowest COMPLETED round: an expired round only reports the
        # deadline itself (the receiver stopped waiting), and sampling
        # that would make t_B converge to whatever budget it started
        # with instead of the network's real pace.  A step where every
        # round was lossy contributes no sample (the ControlPlane falls
        # back to the per-peer arrival times).
        step_time=max((t for t, to in zip(round_times, round_to)
                       if not to), default=None))


class HostRing:
    """N host peers on one fabric (see module docstring). ``device`` is
    where the peers' stage functions run: the CUDA device unless the caller
    asks for another."""

    def __init__(self, n_peers: int, cfg: OptiReduceConfig, *,
                 backend: str | Backend = "inproc",
                 timeout: AdaptiveTimeout | None = None,
                 default_deadline: float | None = None,
                 budget: LossBudget | None = None,
                 drop_fn=None, delay_fn=None, scramble_seed=None,
                 membership=None, shard_weights=None, dead_links=(),
                 device: torch.device | str | None = None):
        self.n = int(n_peers)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = make_backend(backend, self.n, drop_fn=drop_fn,
                                    delay_fn=delay_fn,
                                    scramble_seed=scramble_seed)
        self.timeout = timeout
        self.budget = budget
        self.peers = [HostPeer(p, self.backend, cfg, timeout=timeout,
                               default_deadline=default_deadline,
                               budget=budget, membership=membership,
                               shard_weights=shard_weights,
                               dead_links=dead_links, device=self.device)
                      for p in range(self.n)]
        self._cv = threading.Condition()
        self._lock = self._cv                 # one lock guards all ring state
        self._bridge_calls = 0
        self._results: dict[int, np.ndarray] = {}
        self._pending: list[list[PeerReport]] = [[] for _ in range(self.n)]
        self._jobs: list = []                 # queued exchanges, FIFO
        self._worker: threading.Thread | None = None
        self._working = False                 # worker mid-exchange
        self._closing = False
        self.bridge_timeout = 10.0            # bounded wait; never a deadlock
        self.bridge_misses = 0
        self.bridge_error: Exception | None = None

    def close(self) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self.backend.close()

    # ------------------------------------------------- standalone datapath
    def allreduce(self, buckets, draws, *, step: int = 0, bucket: int = 0,
                  stale=None) -> tuple[torch.Tensor, StepTelemetry]:
        """One full over-the-wire TAR allreduce of per-peer buckets.

        ``buckets``: (n, L) tensor or array — peer p contributes row p.
        ``draws`` gives the random operands every peer shares (a
        :class:`~repro_torch.core.pipeline.Draws` provider, or a key, which
        means ``ThreefryDraws(key)`` on the ring's device), drawn at site
        ``bucket``, as ``sync_packed`` draws its bucket ``bucket``.
        ``stale`` is the replicated previous-step decoded bucket ``(L,)``
        for StaleFill recovery codecs (``cfg.recovery != "none"``).
        Returns the (n, L) per-peer synced results on the ring's device and
        the step's telemetry.
        """
        if buckets.ndim != 2 or buckets.shape[0] != self.n:
            raise ValueError(f"buckets must be ({self.n}, L), "
                             f"got {tuple(buckets.shape)}")
        if isinstance(draws, tuple):
            draws = ThreefryDraws(draws, self.cfg, self.device)
        results: list = [None] * self.n
        reports: list = [None] * self.n
        errors: list = []

        def run(p: int) -> None:
            try:
                peer = self.peers[p]
                peer.phase1_encode(buckets[p], draws, step, bucket,
                                   stale=stale)
                self.backend.barrier(timeout=60.0)
                peer.phase2_send_stage1(step, bucket)
                self.backend.barrier(timeout=60.0)
                # a relay hop's wrapped datagrams must be forwarded before
                # the final receivers stop polling (virtual-time backends
                # never block in wait) — every peer drains once, fenced, so
                # two-hop delivery lands inside the coming receive phase
                peer.relay_pump(step)
                self.backend.barrier(timeout=60.0)
                rep = peer.phase3_reduce_send_stage2(step, bucket)
                self.backend.barrier(timeout=60.0)
                peer.relay_pump(step)
                self.backend.barrier(timeout=60.0)
                out, rep2 = peer.phase4_decode(step, bucket)
                rep.merge(rep2)
                results[p], reports[p] = out, rep
            except Exception as e:           # surface, never hang the join
                errors.append((p, e))

        threads = [threading.Thread(target=run, args=(p,), daemon=True)
                   for p in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        if errors:
            raise RuntimeError(f"host peers failed: {errors}") from \
                errors[0][1]
        out = torch.stack(results)
        return out, self._aggregate([r for r in reports if r is not None],
                                    step)

    # ------------------------------------------------------- bridge mode
    # The sync engine calls bridge_exchange once per bucket, in bucket
    # order, with all N peers' stage-1 shards; call k is exchange k.  The
    # call copies the stack to the host (the engine may reuse its storage
    # as soon as the call returns), queues it, and returns the observed
    # mask of the *previous* exchange (call k consumes exchange k-1's mask;
    # call 0 primes with all-ones), while a dedicated worker thread runs
    # each exchange in call order: every peer's sends, then every
    # receiver's deadline-bounded receive.  The one-exchange lag is the
    # reference's (its io_callback must neither block on a rendezvous nor
    # read its operand on an XLA worker thread) and the same
    # next-round-from-last-round structure as the §3.2 controllers.  When
    # the loss schedule ignores the exchange counter
    # (``mask_scripted_drops`` — the parity mechanism), exchange k-1's mask
    # equals exchange k's *bitwise*, which the bridge parity test pins after
    # one priming call; schedules keyed on the counter (``bernoulli_drops``
    # in wire training) make the lagged mask an equal-distribution sample of
    # the loss process, not that exact bucket's realization.  A mask not
    # ready within ``bridge_timeout`` (or whose geometry changed between
    # buckets) degrades to all-ones and counts in ``bridge_misses`` — never
    # a hang.

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._closing:
                    self._cv.wait(0.5)
                if self._closing and not self._jobs:
                    return
                xid, shards = self._jobs.pop(0)
                self._working = True
            masks = reports = None
            try:
                step = xid & 0xFFFFFFFF
                for me in range(self.n):
                    self.peers[me].bridge_send(shards[me], step, 0)
                for me in range(self.n):
                    # forward relay-wrapped datagrams (dead-link reroute)
                    # before any receiver evaluates its deadline
                    self.peers[me].relay_pump(step)
                got = [self.peers[me].bridge_receive(shards[me], step, 0)
                       for me in range(self.n)]
                masks = np.stack([m for m, _ in got])
                reports = [r for _, r in got]
            except Exception as e:      # a dead worker must not wedge flush
                self.bridge_error = e
            with self._cv:
                if masks is not None:
                    self._results[xid] = masks
                    for r in range(self.n):
                        self._pending[r].append(reports[r])
                    for old in [k for k in self._results if k < xid - 3]:
                        del self._results[old]    # bound stale results
                self._working = False
                self._cv.notify_all()

    def bridge_exchange(self, shards: torch.Tensor) -> torch.Tensor:
        """``WireTransport`` target: queue this bucket's ``(n, n, s)``
        stage-1 shard stack (row p: what peer p sends, one shard per
        receiver) and return the previous exchange's observed ``(n, n, s)``
        fp32 arrival mask (row r: receiver r's) on the stack's device."""
        shape = tuple(shards.shape)
        if len(shape) != 3 or shape[:2] != (self.n, self.n):
            raise ValueError(f"the bridge takes ({self.n}, {self.n}, s) "
                             f"shards, got {shape}")
        # a copy the engine cannot touch again: from the card, a blocking
        # device-to-host copy; on the CPU, a clone
        host = shards.detach().to("cpu", copy=True).numpy()
        with self._cv:
            xid = self._bridge_calls
            self._bridge_calls += 1
            self._jobs.append((xid, host))
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name="wire-bridge")
                self._worker.start()
            self._cv.notify_all()
            if xid == 0:                              # priming call
                return torch.ones(shape, dtype=torch.float32,
                                  device=shards.device)
            deadline = time.monotonic() + self.bridge_timeout
            while xid - 1 not in self._results:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            res = self._results.get(xid - 1)
            if res is None or res.shape != shape:
                self.bridge_misses += 1
                res = None
        if res is None:
            return torch.ones(shape, dtype=torch.float32,
                              device=shards.device)
        return torch.from_numpy(res).to(shards.device)

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait (bounded) until every queued exchange has run — the
        launcher calls this at step end so drained telemetry covers the
        step's own exchanges."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._jobs or self._working:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def drain_telemetry(self, step: int = 0) -> StepTelemetry | None:
        """Fold every bridge exchange since the last drain into one
        :class:`StepTelemetry` (None when nothing was exchanged)."""
        with self._lock:
            pending, self._pending = self._pending, \
                [[] for _ in range(self.n)]
        merged = []
        for reports in pending:
            if not reports:
                continue
            acc = PeerReport(sender_last_t=np.full(self.n, np.nan))
            for r in reports:
                acc.merge(r)
            merged.append(acc)
        if not merged:
            return None
        return self._aggregate(merged, step)

    # -------------------------------------------------------- aggregation
    def _aggregate(self, reports: list[PeerReport],
                   step: int) -> StepTelemetry:
        return aggregate_reports(reports, step)


def wire_spec(cfg: OptiReduceConfig, ring: HostRing) -> CollectiveSpec:
    """Resolve ``cfg.strategy`` and swap its transport for a
    :class:`WireTransport` bridged to ``ring`` — what ``launch/train.py
    --transport={inproc,udp}`` feeds the trainer."""
    spec = resolve_spec(cfg)
    return dataclasses.replace(spec, transport=WireTransport(
        ring.bridge_exchange))
