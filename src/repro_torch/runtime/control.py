"""The closed loop: telemetry in, a hashable SyncPolicy out.

The port's copy of ``src/repro/runtime/control.py``.

The :class:`ControlPlane` owns every adaptive controller of the sync layer —
the §3.2 :class:`~repro_torch.core.ubt.UbtState` bundle (adaptive timeout,
dynamic incast, Timely rate control) plus the :class:`StragglerDetector` — and
exposes exactly one output, a :class:`SyncPolicy`:

* ``use_hadamard`` — the §3.2.1 codec recommendation, with a hysteresis
  band [threshold/2, threshold) so loss hovering at the 2% activation
  threshold cannot flap the codec (each flip retraces the step);
* ``incast``       — the advertised round-schedule fan-in I, clamped to the
  active-set size;
* ``active_peers`` — the degraded-participation set (None = everyone), fed
  straight into ``OptiReduceConfig.active_peers``;
* ``shard_weights`` — straggler-proportional shard units per *active* peer
  (None = uniform), from ``StragglerDetector.weights()`` when rebalancing
  is enabled: a slow-but-alive peer owns a smaller contiguous slice of the
  bucket instead of being ejected;
* ``dead_links``   — directed (src, dst) edges the link-health tracker has
  declared failed; the round schedules reroute around them (relay / ring
  reordering) instead of ejecting either endpoint;
* ``timeout_x``    — the x%-wait knob the simulator's deadline rule uses
  (host-only: it never changes the compiled program, so it is excluded
  from policy equality/hash and the compile key).

Equality (and hash) of two policies therefore answers "would these compile
to the same step?", which is what :class:`PolicyStepCache` keys on — an
eject -> readmit cycle returns to a previously-compiled step instead of
recompiling.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Hashable

from repro_torch.core.ubt import UbtState
from repro_torch.obs import trace as obs_trace

from .straggler import StragglerDetector
from .telemetry import StepTelemetry


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """The control plane's recommendation for the next step (hashable;
    ``timeout_x`` is carried but excluded from equality/hash — it is
    continuous host-side state that never changes the compiled program)."""
    use_hadamard: bool = False
    incast: int = 1
    active_peers: tuple[int, ...] | None = None     # None = full set
    # shard units per active peer, aligned with the (sorted) active set;
    # None = uniform — a uniform tuple is normalized away before it gets
    # here so the full-participation trace stays bitwise-identical
    shard_weights: tuple[int, ...] | None = None
    # directed (src, dst) edges declared failed by the link-health tracker
    dead_links: tuple[tuple[int, int], ...] = ()
    timeout_x: float = dataclasses.field(default=0.10, compare=False)
    # membership generation this policy was computed under (rendezvous-fed;
    # 0 = no rendezvous).  Stamped so a launcher can order policies against
    # membership snapshots; excluded from equality/hash — the generation
    # number itself never changes the compiled program
    generation: int = dataclasses.field(default=0, compare=False)

    @property
    def compile_key(self) -> Hashable:
        """What a compiled train step depends on."""
        return (self.use_hadamard, self.incast, self.active_peers,
                self.shard_weights, self.dead_links)

    def apply(self, cfg):
        """Fold this policy into a sync config (any dataclass carrying
        ``use_hadamard`` / ``incast`` / ``active_peers`` /
        ``shard_weights`` / ``dead_links`` fields)."""
        return dataclasses.replace(cfg, use_hadamard=self.use_hadamard,
                                   incast=self.incast,
                                   active_peers=self.active_peers,
                                   shard_weights=self.shard_weights,
                                   dead_links=self.dead_links)


class ControlPlane:
    """Telemetry-driven owner of the UBT controllers + straggler detector."""

    def __init__(self, state: UbtState, detector: StragglerDetector, *,
                 use_hadamard: bool = False, rebalance: bool = False,
                 link_patience: int = 2, link_recover: int = 50):
        self.state = state
        self.detector = detector
        self.use_hadamard = use_hadamard
        # rebalance: emit straggler-proportional shard weights instead of
        # relying on ejection alone — a slow peer keeps a (smaller) slice
        self.rebalance = bool(rebalance)
        # link-health tracker: ``link_patience`` consecutive fully-lossy
        # observations declare a directed edge dead; once dead the schedule
        # relays around it, so the edge goes unobserved — after
        # ``link_recover`` quiet steps it is revived (probed) and re-killed
        # within ``link_patience`` steps if still down.  Both transitions
        # are recompiles; the long recover period bounds the probe cost
        self.link_patience = max(1, int(link_patience))
        self.link_recover = max(1, int(link_recover))
        self._link_strikes: dict[tuple[int, int], int] = {}
        self._link_quiet: dict[tuple[int, int], int] = {}
        self._dead_links: set[tuple[int, int]] = set()
        self.steps = 0                      # observed (post-warmup) steps
        self.generation = 0                 # latest membership generation

    @classmethod
    def create(cls, n_nodes: int, *, use_hadamard: bool = False,
               detector: StragglerDetector | None = None,
               detect_stragglers: bool = True,
               rebalance: bool = False,
               link_patience: int = 2, link_recover: int = 50,
               detector_kw: dict | None = None, **kw) -> "ControlPlane":
        """Build the full controller bundle for an ``n_nodes`` job.  ``kw``
        forwards to :meth:`UbtState.create` (``timeout=``/``incast=``/
        ``rate=`` sub-dicts); ``detector_kw`` to :class:`StragglerDetector`.
        """
        if detector is None:
            detector = StragglerDetector(n_nodes,
                                         enabled=detect_stragglers,
                                         **(detector_kw or {}))
        return cls(state=UbtState.create(n_nodes=n_nodes, **kw),
                   detector=detector, use_hadamard=use_hadamard,
                   rebalance=rebalance, link_patience=link_patience,
                   link_recover=link_recover)

    # ------------------------------------------------------------ the loop
    def observe(self, t: StepTelemetry) -> bool:
        """Feed one step's telemetry; True if the policy moved (the caller
        should re-resolve its sync config / compiled step).

        With tracing on, every state transition this observation causes —
        peer eject/probation/readmit, link death/revival, codec flips,
        incast moves, LossBudget phase steps — lands as a ``cat="policy"``
        instant event with its cause (DESIGN §12)."""
        before = self.policy()
        tr = obs_trace.get_tracer()
        if tr is not None:
            statuses0 = tuple(p.status for p in self.detector.peers)
            dead0 = set(self._dead_links)
            budget0 = (None if self.state.budget is None
                       else int(min(max(self.state.budget.phase, 0.0), 1.0)
                                * 10))
        at = self.state.timeout
        sample = t.step_time
        if sample is None and t.peer_stage_times is not None:
            observed = [x for x in t.peer_stage_times
                        if x is not None and x == x]
            sample = max(observed) if observed else None
        if sample is not None and not at.ready:
            at.observe_warmup(float(sample))
        if at.ready and at.t_c is not None and t.round_times:
            at.update(stage_times=list(t.round_times),
                      timed_out=list(t.round_timed_out or
                                     (False,) * len(t.round_times)),
                      frac_received=list(t.round_frac_received or
                                         (1.0,) * len(t.round_times)),
                      loss_frac=t.loss_frac)
        self.state.incast.update(loss_frac=t.loss_frac, timed_out=t.timed_out)
        if self.state.budget is not None:
            # phase-aware loss budget (DESIGN §8): the observed loss EMA is
            # what the accept-or-extend deadline rule compares to the
            # tightening budget; the *phase* advances out-of-band via
            # update_phase (LR progress / loss curve, launcher-fed)
            self.state.budget.observe(t.loss_frac)
        if at.hadamard_active(t.loss_frac):
            self.use_hadamard = True
        elif t.loss_frac < at.ht_threshold / 2.0:
            # hysteresis band [thr/2, thr): loss hovering at the threshold
            # must not flap the codec (each flip retraces the step)
            self.use_hadamard = False
        if t.peer_stage_times is not None:
            self.detector.observe(t.peer_stage_times)
        self._observe_links(t.dead_link_events or ())
        self.steps += 1
        after = self.policy()
        if tr is not None:
            self._trace_transitions(tr, t, before, after, statuses0, dead0,
                                    budget0)
        return after != before

    # status -> event name for the per-peer transition timeline
    _STATUS_EVENT = {"ejected": "eject", "probation": "probation",
                     "active": "readmit"}

    def _trace_transitions(self, tr, t: StepTelemetry, before: SyncPolicy,
                           after: SyncPolicy, statuses0, dead0,
                           budget0) -> None:
        """Emit one instant event per state transition this step caused."""
        step = int(t.step)
        for p, (s0, peer) in enumerate(zip(statuses0, self.detector.peers)):
            if peer.status != s0:
                tr.event(self._STATUS_EVENT[peer.status], "policy", tid=p,
                         args={"step": step, "peer": p, "from": s0,
                               "score": round(float(peer.score), 4),
                               "cause": "score"})
        dead1 = set(self._dead_links)
        for link in sorted(dead1 - dead0):
            tr.event("dead_link", "policy",
                     args={"step": step, "src": link[0], "dst": link[1],
                           "cause": "fully_lossy"})
        for link in sorted(dead0 - dead1):
            tr.event("link_revived", "policy",
                     args={"step": step, "src": link[0], "dst": link[1],
                           "cause": "quiet_probe"})
        if after.use_hadamard != before.use_hadamard:
            tr.event("hadamard", "policy",
                     args={"step": step, "on": after.use_hadamard,
                           "loss_frac": round(float(t.loss_frac), 5),
                           "cause": "loss_threshold"})
        if after.incast != before.incast:
            tr.event("incast", "policy",
                     args={"step": step, "from": before.incast,
                           "to": after.incast, "cause": "loss_controller"})
        if self.state.budget is not None:
            b1 = int(min(max(self.state.budget.phase, 0.0), 1.0) * 10)
            if b1 != budget0:
                tr.event("budget_phase", "policy",
                         args={"step": step,
                               "phase": round(self.state.budget.phase, 3),
                               "cause": "loss_budget"})
        if after != before:
            tr.event("policy_change", "policy",
                     args={"step": step,
                           "active": len(after.active_peers
                                         or range(self.detector.n_peers)),
                           "incast": after.incast,
                           "hadamard": after.use_hadamard,
                           "dead_links": len(after.dead_links),
                           "rebalanced": after.shard_weights is not None})

    def _observe_links(self, events) -> None:
        """Fold one step's fully-lossy link observations into the tracker."""
        seen = {(int(s), int(d)) for (s, d) in events}
        for link in seen:
            self._link_strikes[link] = self._link_strikes.get(link, 0) + 1
            self._link_quiet.pop(link, None)
            if self._link_strikes[link] >= self.link_patience:
                self._dead_links.add(link)
        for link in list(self._link_strikes):
            if link in seen:
                continue
            if link in self._dead_links:
                # dead + unobserved: the schedule is relaying around it, so
                # silence is expected — count quiet steps toward a probe
                self._link_quiet[link] = self._link_quiet.get(link, 0) + 1
                if self._link_quiet[link] >= self.link_recover:
                    self._dead_links.discard(link)
                    self._link_strikes.pop(link, None)
                    self._link_quiet.pop(link, None)
            else:
                # a clean observation clears accumulated strikes
                self._link_strikes.pop(link, None)

    def dead_links(self) -> tuple[tuple[int, int], ...]:
        """Currently-dead directed edges, sorted (telemetry/reporting)."""
        return tuple(sorted(self._dead_links))

    def apply_membership(self, kind: str, rank: int,
                         generation: int | None = None) -> bool:
        """Fold one rendezvous membership event into the detector's
        lifecycle (DESIGN §9): ``"leave"``/``"death"`` force-eject the rank
        (a dead peer is degradation already decided, not a score to argue
        with); ``"join"`` readmits it through PROBATION.  Takes primitives
        — not a rendezvous event type — so ``runtime`` stays import-free of
        ``net`` (net already imports runtime).  Returns True if the active
        set changed."""
        if generation is not None:
            self.generation = max(self.generation, int(generation))
        if not 0 <= rank < self.detector.n_peers:
            return False
        if kind == "join":
            changed = self.detector.readmit(rank)
        elif kind in ("leave", "death"):
            changed = self.detector.force_eject(rank)
        else:
            raise ValueError(f"unknown membership event kind {kind!r} "
                             "(join | leave | death)")
        if changed:
            tr = obs_trace.get_tracer()
            if tr is not None:
                tr.event("membership", "policy", tid=rank,
                         args={"peer": rank, "kind": kind,
                               "status": self.detector.status(rank),
                               "generation": self.generation,
                               "cause": "rendezvous"})
        return changed

    def policy(self) -> SyncPolicy:
        active = self.detector.active_peers()
        n = self.detector.n_peers
        a = max(1, len(active))
        weights = None
        if self.rebalance:
            units = self.detector.weights()
            w = tuple(units[p] for p in active)
            if w and any(u != w[0] for u in w):
                weights = w          # uniform normalizes to None (parity)
        member = set(active)
        dead = tuple(sorted(link for link in self._dead_links
                            if link[0] in member and link[1] in member))
        return SyncPolicy(
            use_hadamard=self.use_hadamard,
            # senders use the min advertised I, and a degraded schedule has
            # only a-1 distinct peers to fan in from
            incast=max(1, min(self.state.incast.value, max(1, a - 1))),
            active_peers=None if len(active) == n else active,
            shard_weights=weights,
            dead_links=dead,
            timeout_x=self.state.timeout.x,
            generation=self.generation)

    def apply(self, cfg):
        """Fold the current policy into a sync config."""
        return self.policy().apply(cfg)


class PolicyStepCache:
    """Bounded LRU of compiled artifacts keyed by ``SyncPolicy.compile_key``
    — an eject -> probation -> readmit cycle revisits previous policies, and
    each train-step compile is seconds, so the launcher keeps the last few
    compiled steps around instead of rebuilding."""

    def __init__(self, maxsize: int = 4):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, policy: SyncPolicy) -> bool:
        return policy.compile_key in self._entries

    def get(self, policy: SyncPolicy):
        """Cached artifact for this policy, or None (marks it most-recent)."""
        key = policy.compile_key
        if key not in self._entries:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        return self._entries[key]

    def put(self, policy: SyncPolicy, value) -> None:
        key = policy.compile_key
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
