"""Persistent-straggler detection with probationary readmission.

The port's copy of ``src/repro/runtime/straggler.py``.

The §3.2 controllers bound how long a round *waits*; they cannot help when
one peer is slow on every round — the adaptive timeout just converges to
the straggler's pace (its warmup P95 includes the straggler) and every step
pays the tail.  Following the degraded-participation line of work ("don't
wait for a persistently slow peer, exclude its contribution and keep the
collective tight"), the detector keeps a per-peer EWMA *slowness score* —
stage time relative to the median of the currently-participating peers —
and drives a three-state machine:

    ACTIVE --(score > eject_score for `patience` steps)--> EJECTED
    EJECTED --(`cooldown` steps elapsed)--> PROBATION (tentatively back in)
    PROBATION --(score <= readmit_score for `probation` steps)--> ACTIVE
    PROBATION --(score > eject_score once)--> EJECTED (cooldown restarts)

PROBATION peers count as participating (they are being *watched*, not
excluded), so the active set is ACTIVE + PROBATION.  Ejection never shrinks
the set below ``min_active`` and the hysteresis band
(``readmit_score`` < ``eject_score``) keeps a borderline peer from flapping
the membership — every membership change recompiles a train step (the
policy cache bounds, but does not eliminate, that cost).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

ACTIVE = "active"
EJECTED = "ejected"
PROBATION = "probation"


@dataclasses.dataclass
class PeerState:
    """Detector state for one peer."""
    status: str = ACTIVE
    score: float = 1.0      # EWMA of stage time / median-of-participants
    strikes: int = 0        # consecutive over-threshold steps while ACTIVE
    clean: int = 0          # consecutive under-threshold steps in PROBATION
    countdown: int = 0      # steps remaining in the EJECTED cooldown
    ejections: int = 0      # lifetime ejection count (telemetry/reporting)
    held: bool = False      # membership-ejected (crashed/left): the cooldown
    #                         never auto-promotes it to PROBATION — only an
    #                         explicit readmit() (a rendezvous rejoin) does


class StragglerDetector:
    """EWMA-scored persistent-straggler ejection (see module docstring)."""

    def __init__(self, n_peers: int, *, alpha: float = 0.25,
                 eject_score: float = 1.75, readmit_score: float = 1.25,
                 patience: int = 4, cooldown: int = 12, probation: int = 6,
                 min_active: int = 2, enabled: bool = True,
                 weight_resolution: int = 4, weight_floor: float = 0.25,
                 weight_band: float = 0.35):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha {alpha} outside (0, 1]")
        if readmit_score >= eject_score:
            raise ValueError("readmit_score must sit below eject_score "
                             "(the hysteresis band)")
        if weight_resolution < 1:
            raise ValueError(f"weight_resolution {weight_resolution} < 1")
        if not 0.0 < weight_floor <= 1.0:
            raise ValueError(f"weight_floor {weight_floor} outside (0, 1]")
        self.n_peers = int(n_peers)
        self.alpha = float(alpha)
        self.eject_score = float(eject_score)
        self.readmit_score = float(readmit_score)
        self.patience = int(patience)
        self.cooldown = int(cooldown)
        self.probation = int(probation)
        self.min_active = max(1, int(min_active))
        self.enabled = bool(enabled)
        self.weight_resolution = int(weight_resolution)
        self.weight_floor = float(weight_floor)
        self.weight_band = float(weight_band)
        self.peers = [PeerState() for _ in range(self.n_peers)]
        self._weight_units = [self.weight_resolution] * self.n_peers

    # ------------------------------------------------------------- queries
    def active_peers(self) -> tuple[int, ...]:
        """Participating peers (ACTIVE + PROBATION), sorted."""
        return tuple(i for i, p in enumerate(self.peers)
                     if p.status != EJECTED)

    def ejected_peers(self) -> tuple[int, ...]:
        return tuple(i for i, p in enumerate(self.peers)
                     if p.status == EJECTED)

    def status(self, peer: int) -> str:
        return self.peers[peer].status

    def scores(self) -> tuple[float, ...]:
        return tuple(p.score for p in self.peers)

    def weights(self) -> tuple[int, ...]:
        """Straggler-proportional shard units per peer (0 for EJECTED).

        Normalized inverse-score: a peer's raw target is
        ``resolution * median_active_score / score`` — uniform
        (== ``weight_resolution``) for a median-pace peer, proportionally
        fewer units for a slow one — clamped to
        ``[weight_floor * resolution, resolution]`` so a slow-but-alive
        peer always keeps a nonzero contiguous slice, then rounded to
        integer units.  PROBATION peers are additionally capped at half
        weight: they are being *watched*, not yet trusted with a full
        shard (reduced, never zero).  Hysteresis banding: the stored unit
        moves only when the raw target strays ``weight_band`` beyond the
        rounding midpoint, so score dithering around a unit boundary does
        not thrash SyncPolicy compile keys (every distinct weight tuple is
        a recompile).
        """
        res = self.weight_resolution
        floor_units = max(1, int(round(self.weight_floor * res)))
        active = self.active_peers()
        scores = [self.peers[p].score for p in active]
        med = max(float(np.median(scores)), 1e-12) if scores else 1.0
        out = []
        for i, p in enumerate(self.peers):
            if p.status == EJECTED:
                # park at the floor so a readmitted peer re-enters small
                # and earns its weight back through the hysteresis band
                self._weight_units[i] = floor_units
                out.append(0)
                continue
            cap = res if p.status == ACTIVE else max(floor_units, res // 2)
            target = res * med / max(p.score, 1e-12)
            target = min(float(cap), max(float(floor_units), target))
            cur = self._weight_units[i]
            if abs(target - cur) > 0.5 + self.weight_band:
                cur = int(round(target))
            cur = min(cap, max(floor_units, cur))
            self._weight_units[i] = cur
            out.append(cur)
        return tuple(out)

    # ------------------------------------------------------------- updates
    def _score(self, times: Sequence[float | None]) -> None:
        vals = np.array([math.nan if t is None else float(t) for t in times],
                        dtype=np.float64)
        # the baseline is the median over *participating* observed peers, so
        # an ejected straggler cannot drag the reference pace it is judged by
        part = [i for i in self.active_peers() if np.isfinite(vals[i])]
        ref = vals[part] if part else vals[np.isfinite(vals)]
        if ref.size == 0:
            return
        med = max(float(np.median(ref)), 1e-12)
        for i, t in enumerate(vals):
            if np.isfinite(t):
                rel = t / med
                p = self.peers[i]
                p.score = (1.0 - self.alpha) * p.score + self.alpha * rel

    def observe(self, peer_times: Sequence[float | None]) -> bool:
        """Feed one step's per-peer stage times; True if the *membership*
        (the active-peer set) changed."""
        if len(peer_times) != self.n_peers:
            raise ValueError(f"expected {self.n_peers} peer times, "
                             f"got {len(peer_times)}")
        before = self.active_peers()
        self._score(peer_times)
        for peer in self.peers:
            if peer.status == EJECTED:
                if peer.held:
                    continue            # a corpse never cools back in
                peer.countdown -= 1
                if peer.countdown <= 0:
                    peer.status = PROBATION
                    peer.clean = 0
                    peer.strikes = 0
            elif peer.status == PROBATION:
                if peer.score > self.eject_score:
                    # still slow: one strike re-ejects (floor permitting —
                    # another peer may have been ejected while this one
                    # cooled down), cooldown restarts
                    if self._can_eject():
                        self._eject(peer)
                elif peer.score <= self.readmit_score:
                    peer.clean += 1
                    if peer.clean >= self.probation:
                        peer.status = ACTIVE
                        peer.clean = 0
                else:
                    # hysteresis middle band: not clean — the readmission
                    # counter requires *consecutive* under-threshold steps
                    peer.clean = 0
            else:  # ACTIVE
                if self.enabled and peer.score > self.eject_score:
                    peer.strikes += 1
                    if peer.strikes >= self.patience and self._can_eject():
                        self._eject(peer)
                else:
                    peer.strikes = 0
        return self.active_peers() != before

    # -------------------------------------------- membership-driven events
    def force_eject(self, peer_index: int) -> bool:
        """Rendezvous-driven ejection (crash / leave): immediate, bypasses
        both ``patience`` and the ``min_active`` floor — a dead peer cannot
        participate regardless of what the schedule would prefer — and is
        *held* out of the cooldown -> PROBATION path until an explicit
        :meth:`readmit` (its rejoin).  Returns True if the status moved."""
        p = self.peers[peer_index]
        changed = p.status != EJECTED
        if changed:
            p.ejections += 1
        p.status = EJECTED
        p.held = True
        p.strikes = 0
        p.clean = 0
        p.countdown = 0
        return changed

    def readmit(self, peer_index: int) -> bool:
        """Rendezvous-driven probationary readmission (a peer re-joined).

        EJECTED -> PROBATION with a *fresh* score: a restarted process does
        not inherit its corpse's EWMA (the crash step charged the corpse
        the full deadline, and one PROBATION strike would re-eject it on
        arrival).  No-op unless currently EJECTED.  Returns True if moved.
        """
        p = self.peers[peer_index]
        if p.status != EJECTED:
            return False
        p.status = PROBATION
        p.held = False
        p.score = 1.0
        p.strikes = 0
        p.clean = 0
        p.countdown = 0
        return True

    def _can_eject(self) -> bool:
        return len(self.active_peers()) - 1 >= self.min_active

    def _eject(self, peer: PeerState) -> None:
        peer.status = EJECTED
        # exponential backoff for repeat offenders: each re-ejection doubles
        # the cooldown (capped), so a persistently slow peer costs one slow
        # probation step per ~doubling window instead of flapping every
        # `cooldown` steps — while a healed peer still gets readmitted
        peer.countdown = self.cooldown * min(2 ** peer.ejections, 16)
        peer.strikes = 0
        peer.clean = 0
        peer.ejections += 1
