"""Per-step observations flowing into the control plane.

The port's copy of ``src/repro/runtime/telemetry.py``.

A :class:`StepTelemetry` is a plain host-side record of what one training
(or simulated) step observed.  Producers fill in what they can measure:

* the trainer / launcher knows the whole-step wall clock and the observed
  entry-loss fraction (``ctx.stats`` from the Lossy transport);
* the cloud-network simulator additionally knows per-peer transfer times
  (the straggler signal) and the per-round stage times / timeout flags /
  received fractions the §3.2.1 ``AdaptiveTimeout.update`` rule consumes.

Every field is optional beyond ``loss_frac``; the :class:`ControlPlane`
uses whatever is present (a controller whose inputs are missing simply
holds its state).  Times are in whichever unit the producer profiles in —
the controllers only ever compare them against each other.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class StepTelemetry:
    """One step's observations, as seen by this (logical) receiver."""
    step: int = 0
    # entry-loss fraction this step (dropped / total mask entries, pmean'd
    # across receivers — what ``SyncContext.loss_fraction`` reports)
    loss_frac: float = 0.0
    # did any receive stage hit its deadline this step
    timed_out: bool = False
    # per-peer completion times for the step's receive stages (index = peer
    # id on the data axis) — the StragglerDetector's input; NaN/None entries
    # mean "peer unobserved this step"
    peer_stage_times: tuple[float, ...] | None = None
    # whole-step wall clock: the warmup profiling sample when per-round
    # stage times are not separately measurable (the real-trainer case)
    step_time: float | None = None
    # per-round detail (the simulator measures these): stage completion
    # time, t_B-expiry flag, and fraction of data received per round —
    # exactly the inputs of AdaptiveTimeout.update (§3.2.1)
    round_times: tuple[float, ...] | None = None
    round_timed_out: tuple[bool, ...] | None = None
    round_frac_received: tuple[float, ...] | None = None
    # raw drop-stat counters, when the producer has them
    dropped: float = 0.0
    total: float = 0.0
    # directed (src, dst) links observed *fully* lossy this step: receiver
    # dst saw zero packets from src while other senders delivered — a link
    # fault suspect, not a straggler signal.  The ControlPlane turns
    # consecutive suspicions into SyncPolicy.dead_links (ring rewiring)
    dead_link_events: tuple[tuple[int, int], ...] = ()

    @classmethod
    def from_stats(cls, step: int, stats: dict, *,
                   step_time: float | None = None,
                   peer_stage_times: Sequence[float] | None = None,
                   timed_out: bool = False) -> "StepTelemetry":
        """Build from a ``SyncContext.stats`` dict (trainer-side producer)."""
        dropped = float(stats.get("dropped", 0.0))
        total = float(stats.get("total", 0.0))
        loss = dropped / total if total > 0 else 0.0
        return cls(step=step, loss_frac=loss, dropped=dropped, total=total,
                   step_time=step_time, timed_out=timed_out,
                   peer_stage_times=(None if peer_stage_times is None
                                     else tuple(float(t)
                                                for t in peer_stage_times)))

    @classmethod
    def from_wire(cls, step: int, *, round_times: Sequence[float],
                  round_timed_out: Sequence[bool],
                  round_frac_received: Sequence[float],
                  peer_stage_times: Sequence[float] | None,
                  dropped: float, total: float,
                  step_time: float | None = None,
                  dead_link_events: Sequence[tuple[int, int]] = ()
                  ) -> "StepTelemetry":
        """Build from a host wire transport's observations (the wire, ROADMAP
        A18):
        every field the simulator used to be the only producer of —
        per-round stage times / t_B-expiry flags / received fractions and
        per-peer last-arrival times — now measured on a real exchange.
        NaN entries in ``peer_stage_times`` mean "peer unobserved"; None
        means no receiver observed arrivals at all this step (e.g. every
        round empty) — the StragglerDetector holds its state either way."""
        loss = dropped / total if total > 0 else 0.0
        return cls(step=step, loss_frac=loss, dropped=float(dropped),
                   total=float(total), step_time=step_time,
                   timed_out=any(bool(b) for b in round_timed_out),
                   peer_stage_times=(None if peer_stage_times is None else
                                     tuple(float(t)
                                           for t in peer_stage_times)),
                   round_times=tuple(float(t) for t in round_times),
                   round_timed_out=tuple(bool(b) for b in round_timed_out),
                   round_frac_received=tuple(float(f)
                                             for f in round_frac_received),
                   dead_link_events=tuple((int(s), int(d))
                                          for (s, d) in dead_link_events))
