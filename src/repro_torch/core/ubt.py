"""Unreliable Bounded Transport (UBT) control plane (paper §3.2).

The port's copy of ``src/repro/core/ubt.py``, line for line: importing
the reference's module runs ``repro/core/__init__.py``, which needs JAX.

Collectives over the peer axis cannot drop packets or time out, so these
controllers do not sit in the datapath; they are the *decision logic* the
paper specifies, reproduced exactly, and they drive (a) the cloud-network
simulator (sim/netsim.py) and (b) the drop-mask generator used in training
(core/drops.py). All state machines are plain Python over floats so they are
unit-testable against the paper's update rules.

Components:
  * AdaptiveTimeout — t_B = P95 of 20 profiled stage times (§3.2.1);
    early-timeout t_C moving average (alpha=0.95) with the x%-wait rule:
    start 10%, double while loss > 0.1%, decrement while loss < 0.01%,
    cap 50%; t_C sources: on-time -> observed, timeout -> t_B,
    last-percentile-seen -> extrapolated; median across nodes then EMA.
  * DynamicIncast — raise I on loss-free rounds, halve on loss (§3.2.2);
    senders use the min advertised I.
  * TimelyRateControl — §3.2.3: additive increase below T_low, multiplicative
    decrease above T_high (paper constants: 25us/250us/50Mbps/beta=0.5).
  * LossBudget — phase-aware acceptable-drop-fraction controller (DESIGN
    §8): the budget tightens geometrically as the LR schedule / loss curve
    approaches convergence, and when the observed loss EMA overruns it the
    round deadlines stretch (accept-or-extend) to recover late packets.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class AdaptiveTimeout:
    """Per-stage timeout controller. Times are in arbitrary units (seconds)."""
    warmup_iters: int = 20
    percentile: float = 95.0
    alpha: float = 0.95           # EMA weight on the *new* t_C sample
    x_init: float = 0.10
    x_min: float = 0.01
    x_max: float = 0.50
    loss_hi: float = 1e-3         # 0.1 %
    loss_lo: float = 1e-4         # 0.01 %
    ht_threshold: float = 0.02    # > 2% loss activates Hadamard (§3.2.1 fn.6)

    t_b: float | None = None
    t_c: float | None = None
    x: float = dataclasses.field(default=0.10)
    _warmup: list = dataclasses.field(default_factory=list)

    def observe_warmup(self, stage_time: float) -> None:
        self._warmup.append(float(stage_time))
        if len(self._warmup) >= self.warmup_iters:
            self.t_b = float(np.percentile(self._warmup, self.percentile))
            if self.t_c is None:
                self.t_c = float(np.median(self._warmup))

    @property
    def ready(self) -> bool:
        return self.t_b is not None

    def round_deadline(self, last_pctile_seen: bool) -> float:
        """Time budget for the current receive stage."""
        assert self.t_b is not None
        if last_pctile_seen and self.t_c is not None:
            return min(self.t_b, (1.0 + self.x) * self.t_c)
        return self.t_b

    def round_deadline_or(self, default: float,
                          last_pctile_seen: bool = False) -> float:
        """:meth:`round_deadline` once profiled; ``default`` during warmup
        (a wire receive loop needs a budget from step 0, before t_B
        exists)."""
        if self.t_b is None:
            return default
        return self.round_deadline(last_pctile_seen)

    def update(self, *, stage_times: Sequence[float], timed_out: Sequence[bool],
               frac_received: Sequence[float], loss_frac: float) -> None:
        """End-of-round update of t_C and x% (paper §3.2.1).

        stage_times[i]: node i's observed completion (or expiry) time;
        timed_out[i]: hit t_B; frac_received[i]: fraction of data received
        (for last-percentile extrapolation); loss_frac: entry loss this round.
        """
        assert self.t_b is not None and self.t_c is not None
        samples = []
        for t, to, fr in zip(stage_times, timed_out, frac_received):
            if to:
                samples.append(self.t_b)                       # (2) timed out
            elif fr >= 1.0:
                samples.append(t)                              # (1) on time
            else:
                samples.append(t * (1.0 / max(fr, 1e-6)))      # (3) extrapolate
        t_c_round = float(np.median(samples))                  # median across PS nodes
        self.t_c = self.alpha * t_c_round + (1.0 - self.alpha) * self.t_c

        if loss_frac > self.loss_hi:
            self.x = min(self.x_max, self.x * 2.0)
        elif loss_frac < self.loss_lo:
            self.x = max(self.x_min, self.x - 0.01)

    def hadamard_active(self, loss_frac: float) -> bool:
        return loss_frac > self.ht_threshold


@dataclasses.dataclass
class DynamicIncast:
    """Receiver-advertised incast factor I (§3.2.2)."""
    n_nodes: int = 8
    i_init: int = 1
    loss_tolerance: float = 1e-4

    value: int = 1

    def __post_init__(self) -> None:
        self.value = max(1, int(self.i_init))

    def update(self, *, loss_frac: float, timed_out: bool) -> int:
        if loss_frac > self.loss_tolerance or timed_out:
            self.value = max(1, self.value // 2)
        else:
            self.value = min(self.n_nodes - 1, self.value + 1)
        return self.value

    @staticmethod
    def effective(advertised: Sequence[int]) -> int:
        """Senders use the smallest advertised I for the round."""
        return max(1, min(int(v) for v in advertised))


@dataclasses.dataclass
class TimelyRateControl:
    """Minimal TIMELY-like rate control (§3.2.3). Units: seconds, bits/s."""
    t_low: float = 25e-6
    t_high: float = 250e-6
    add_step: float = 50e6        # alpha = 50 Mbps
    beta: float = 0.5
    rate: float = 10e9            # starting rate
    max_rate: float = 100e9
    min_rate: float = 100e6

    def update(self, rtt: float) -> float:
        if rtt < self.t_low:
            self.rate = min(self.max_rate, self.rate + self.add_step)
        elif rtt > self.t_high:
            self.rate = max(self.min_rate,
                            self.rate * (1.0 - self.beta * (1.0 - self.t_high / rtt)))
        # in the [t_low, t_high] band the paper's minimal scheme holds rate
        return self.rate


@dataclasses.dataclass
class LossBudget:
    """Phase-aware acceptable-drop-fraction controller (DESIGN §8).

    Early in training large gradient losses are tolerable (SGD noise
    dominates); near convergence the same loss stalls progress. The budget
    interpolates geometrically from ``budget_init`` at phase 0 to
    ``budget_final`` at phase 1, where *phase* is fed from the LR schedule
    (``update_phase(progress=...)``) and/or a loss-curve plateau detector
    (``update_phase(train_loss=...)``) and never decreases.

    The transport consumes it as an accept-or-extend rule: while the
    observed loss EMA overruns the current budget, :meth:`deadline_factor`
    stretches the AdaptiveTimeout round deadline (up to ``max_stretch``×)
    so late packets are waited for instead of charged as drops — tail
    latency is spent exactly where convergence needs the data.
    """
    budget_init: float = 0.02     # acceptable drop fraction at phase 0
    budget_final: float = 1e-4    # at phase 1 (converged)
    ema_alpha: float = 0.3        # weight on the newest loss sample
    gain: float = 0.5             # stretch = (loss/budget)**gain, capped
    max_stretch: float = 4.0
    plateau_patience: int = 20    # non-improving evals to reach phase 1

    phase: float = 0.0
    loss_ema: float = 0.0
    _best_loss: float | None = None
    _stalls: int = 0

    def budget(self) -> float:
        """Acceptable drop fraction at the current phase (monotone in it)."""
        f = min(max(self.phase, 0.0), 1.0)
        return float(self.budget_init ** (1.0 - f) * self.budget_final ** f)

    def update_phase(self, *, progress: float | None = None,
                     train_loss: float | None = None) -> float:
        """Advance the training phase; returns the new value in [0, 1].

        ``progress``: LR-schedule fraction elapsed (e.g. step/total_steps or
        1 - lr/lr0). ``train_loss``: the loss curve — phase rises as the
        relative improvement stalls (``plateau_patience`` flat evals ⇒ 1).
        The phase is the max of all signals seen and never moves backward.
        """
        f = self.phase
        if progress is not None:
            f = max(f, min(max(float(progress), 0.0), 1.0))
        if train_loss is not None:
            t = float(train_loss)
            if self._best_loss is None or t < self._best_loss * 0.99:
                self._best_loss = t if self._best_loss is None \
                    else min(self._best_loss, t)
                self._stalls = 0
            else:
                self._stalls += 1
            f = max(f, min(1.0, self._stalls / float(self.plateau_patience)))
        self.phase = f
        return f

    def observe(self, loss_frac: float) -> None:
        """Feed one round/step's observed drop fraction into the EMA."""
        self.loss_ema = (self.ema_alpha * float(loss_frac)
                         + (1.0 - self.ema_alpha) * self.loss_ema)

    def over_budget(self) -> bool:
        return self.loss_ema > self.budget()

    def deadline_factor(self) -> float:
        """Multiplicative round-deadline stretch in [1, max_stretch]."""
        over = self.loss_ema / max(self.budget(), 1e-9)
        if over <= 1.0:
            return 1.0
        return float(min(self.max_stretch, over ** self.gain))

    def stretch(self, deadline: float, hard: float | None = None) -> float:
        """Accept-or-extend: the deadline after the budget's say.

        ``hard`` optionally caps the stretched deadline (a wire receive
        loop's absolute bound); ``max_stretch`` always does.
        """
        d = deadline * self.deadline_factor()
        return d if hard is None else min(hard, d)


@dataclasses.dataclass
class UbtState:
    """Bundle of the UBT controllers for one training job. ``budget`` is
    the optional phase-aware loss budget (recovery='ef+budget')."""
    timeout: AdaptiveTimeout
    incast: DynamicIncast
    rate: TimelyRateControl
    budget: LossBudget | None = None

    @classmethod
    def create(cls, n_nodes: int, **kw) -> "UbtState":
        budget = kw.get("budget", None)
        return cls(timeout=AdaptiveTimeout(**kw.get("timeout", {})),
                   incast=DynamicIncast(n_nodes=n_nodes, **kw.get("incast", {})),
                   rate=TimelyRateControl(**kw.get("rate", {})),
                   budget=None if budget is None else LossBudget(**budget))
