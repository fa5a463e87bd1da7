"""Safeguards against excessive gradient loss (paper §3.4).

Counterpart of ``src/repro/core/safeguards.py``: ``guard_scale`` /
``guard_update`` zero an update when the observed loss fraction exceeds the
skip threshold (a multiply, no host round trip), and the host-side
``LossMonitor`` counts skips, escalates to HALT and keeps a ring of
parameter snapshots for rollback.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_map


def guard_scale(loss_frac: torch.Tensor, *, skip_threshold: float = 0.10
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scale, skipped)``: scale 0.0 when loss_frac exceeds the threshold,
    else 1.0 — the trainer folds it into its one guard+clip multiply."""
    skipped = loss_frac > skip_threshold
    return torch.where(skipped, 0.0, 1.0).to(torch.float32), skipped


def guard_update(update: Any, loss_frac: torch.Tensor, *,
                 skip_threshold: float = 0.10) -> tuple[Any, torch.Tensor]:
    """Zero the tree ``update`` when loss_frac > skip_threshold."""
    scale, skipped = guard_scale(loss_frac, skip_threshold=skip_threshold)
    return tree_map(lambda u: u * scale.to(u.dtype), update), skipped


@dataclasses.dataclass
class LossMonitor:
    """Host-side monitor: skip accounting, halt escalation, snapshot ring."""
    skip_threshold: float = 0.10
    halt_after_consecutive_skips: int = 10
    snapshot_every: int = 100
    snapshot_keep: int = 3

    consecutive_skips: int = 0
    total_skips: int = 0
    halted: bool = False
    history: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=1000))
    _snapshots: collections.deque = dataclasses.field(
        default_factory=collections.deque)

    def observe(self, step: int, loss_frac: float, skipped: bool) -> None:
        self.history.append((step, float(loss_frac)))
        if skipped:
            self.consecutive_skips += 1
            self.total_skips += 1
            if self.consecutive_skips >= self.halt_after_consecutive_skips:
                self.halted = True          # prompt user intervention (§3.4)
        else:
            self.consecutive_skips = 0

    def maybe_snapshot(self, step: int, params: Any) -> None:
        if step % self.snapshot_every == 0:
            self._snapshots.append(
                (step, tree_map(lambda p: p.detach().clone(), params)))
            while len(self._snapshots) > self.snapshot_keep:
                self._snapshots.popleft()

    def rollback(self) -> tuple[int, Any] | None:
        """Most recent snapshot (step, params), or None."""
        if not self._snapshots:
            return None
        step, params = self._snapshots[-1]
        self.consecutive_skips = 0
        self.halted = False
        return step, params
