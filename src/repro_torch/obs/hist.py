"""Streaming tail histograms and a small metrics registry (DESIGN §12).

The port's copy of ``src/repro/obs/hist.py``.

:class:`TailHistogram` is a log-bucketed (HDR-style) streaming histogram:
values land in geometrically-spaced buckets — ``bins_per_octave`` buckets
per factor of 2 — so any quantile is *exact to within one log-bucket*
(relative error <= 2**(1/bins_per_octave) - 1; ~2.2% at the default 32)
at O(octaves * bins_per_octave) fixed memory, regardless of how many
samples stream through.  That is the p999 contract the tail tables need:
recording a million round times costs the same memory as recording ten,
and per-rank histograms :meth:`merge` associatively into the cross-rank
aggregate (bucket counts add — order never matters).

:class:`MetricsRegistry` fronts counters / gauges / histograms behind
get-or-create names, so instrumented code never branches on "was this
metric registered"; :func:`metrics` is the process-global instance.
"""
from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["TailHistogram", "Counter", "Gauge", "MetricsRegistry", "metrics"]


class TailHistogram:
    """Log-bucketed streaming histogram (see module docstring).

    Values are clamped to ``[min_value, max_value]`` — an under-range
    sample counts in the first bucket, an over-range one in the last (the
    clamp counts are kept so a mis-sized range is visible).  Non-finite
    samples are rejected loudly: a NaN round time is a producer bug, not
    a tail.
    """

    def __init__(self, min_value: float = 1e-7, max_value: float = 1e4,
                 bins_per_octave: int = 32):
        if not (0 < min_value < max_value):
            raise ValueError(f"need 0 < min_value < max_value, got "
                             f"({min_value}, {max_value})")
        if bins_per_octave < 1:
            raise ValueError(f"bins_per_octave {bins_per_octave} < 1")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.bins_per_octave = int(bins_per_octave)
        octaves = math.log2(self.max_value / self.min_value)
        self.n_bins = int(math.ceil(octaves * self.bins_per_octave)) + 1
        self.counts = np.zeros(self.n_bins, np.int64)
        # one log2 per record; the /bins scale folds into one multiply
        self._scale = float(self.bins_per_octave)
        self.count = 0
        self.sum = 0.0
        self.observed_min = math.inf
        self.observed_max = -math.inf
        self.clamped = 0

    # ------------------------------------------------------------- geometry
    def _index(self, v: float) -> int:
        i = int(math.log2(v / self.min_value) * self._scale)
        return min(max(i, 0), self.n_bins - 1)

    def _edge(self, i: int) -> float:
        """Lower edge of bucket ``i``."""
        return self.min_value * 2.0 ** (i / self._scale)

    def _mid(self, i: int) -> float:
        """Geometric midpoint of bucket ``i`` (the quantile estimate)."""
        return self.min_value * 2.0 ** ((i + 0.5) / self._scale)

    # ------------------------------------------------------------ recording
    def record(self, value: float, n: int = 1) -> None:
        v = float(value)
        if not math.isfinite(v):
            raise ValueError(f"non-finite sample {value!r}")
        if v < self.min_value or v > self.max_value:
            self.clamped += n
            v = min(max(v, self.min_value), self.max_value)
        self.counts[self._index(v)] += n
        self.count += n
        self.sum += value * n
        self.observed_min = min(self.observed_min, float(value))
        self.observed_max = max(self.observed_max, float(value))

    def record_many(self, values) -> None:
        for v in np.asarray(values, np.float64).ravel():
            self.record(float(v))

    # -------------------------------------------------------------- queries
    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] — exact to one log-bucket.

        Returns the geometric midpoint of the bucket holding the q-th
        sample; NaN on an empty histogram.  The true sample quantile lies
        within a factor ``2**(1/bins_per_octave)`` of the estimate (modulo
        clamping at the range edges).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        target = max(1, int(math.ceil(q * self.count)))
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target))
        # clamp the estimate to the observed envelope so tiny histograms
        # never report a midpoint outside what was actually fed
        return float(min(max(self._mid(i), self.observed_min),
                         self.observed_max))

    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def summary(self) -> dict:
        """The tail-table row: count + p50/p99/p999 + envelope."""
        return {"count": int(self.count),
                "mean": self.mean(),
                "p50": self.quantile(0.50),
                "p99": self.quantile(0.99),
                "p999": self.quantile(0.999),
                "min": self.observed_min if self.count else math.nan,
                "max": self.observed_max if self.count else math.nan}

    # -------------------------------------------------------------- merging
    def compatible(self, other: "TailHistogram") -> bool:
        return (self.min_value == other.min_value
                and self.max_value == other.max_value
                and self.bins_per_octave == other.bins_per_octave)

    def merge(self, other: "TailHistogram") -> "TailHistogram":
        """Fold ``other`` in (bucket counts add — associative and
        commutative across ranks).  Returns self."""
        if not self.compatible(other):
            raise ValueError("merging histograms with different geometry: "
                             f"({self.min_value}, {self.max_value}, "
                             f"{self.bins_per_octave}) vs "
                             f"({other.min_value}, {other.max_value}, "
                             f"{other.bins_per_octave})")
        self.counts += other.counts
        self.count += other.count
        self.sum += other.sum
        self.observed_min = min(self.observed_min, other.observed_min)
        self.observed_max = max(self.observed_max, other.observed_max)
        self.clamped += other.clamped
        return self

    def copy(self) -> "TailHistogram":
        out = TailHistogram(self.min_value, self.max_value,
                            self.bins_per_octave)
        out.merge(self)
        return out


class Counter:
    """Monotone accumulator."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins sample."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = math.nan

    def set(self, v: float) -> None:
        self.value = float(v)


class MetricsRegistry:
    """Named counters / gauges / tail histograms, get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, TailHistogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kw) -> TailHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = TailHistogram(**kw)
            return h

    def snapshot(self) -> dict:
        """JSON-safe dump: counters/gauges by value, histograms by
        :meth:`TailHistogram.summary`."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-global registry."""
    return _metrics
