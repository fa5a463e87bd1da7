"""Merge per-rank Perfetto traces into paper-style tail tables.

The port's copy of ``src/repro/obs/report.py``.

``python -m repro_torch.obs.report <trace_dir | trace.json ...>`` loads one or
more ``trace_rankNN.json`` files (as written by :func:`repro_torch.obs.export.
write_trace`), validates them against the trace_event schema, and renders:

* **Round-completion tail tables** — per rank and merged across ranks —
  from the ``"round"`` complete spans' durations, folded through
  :class:`~repro_torch.obs.hist.TailHistogram` (p50/p99/p999 to one
  log-bucket).
* **A control-plane event timeline** — every ``cat="policy"`` instant
  event (timeouts are ``cat="wire"`` instants) in timestamp order with
  rank, name, and cause — the "which decision caused that p999 spike"
  view the bench medians can't give.

``--json`` emits the same content machine-readably (the multiproc
launcher embeds these paths in its report; CI asserts on this output).
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys

from .export import TraceSchemaError, validate_trace
from .hist import TailHistogram

__all__ = ["load_trace", "discover", "merge_report", "render", "main"]

# round/stage durations arrive in µs (export scales by 1e6); a µs-domain
# histogram range wide enough for virtual-clock sims and real UDP runs
_HIST_KW = dict(min_value=1e-1, max_value=1e10, bins_per_octave=32)

# instant-event names that constitute the control timeline, by category
_TIMELINE_CATS = ("policy", "wire", "sim")
_SPAN_TABLES = ("round", "step", "encode", "decode", "exchange")


def load_trace(path: str) -> dict:
    """Load + schema-validate one per-rank trace file."""
    with open(path) as fh:
        payload = json.load(fh)
    try:
        validate_trace(payload)
    except TraceSchemaError as e:
        raise TraceSchemaError(f"{path}: {e}") from e
    return payload


def discover(paths: list[str]) -> list[str]:
    """Expand directories into their ``trace_rank*.json`` members."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            found = sorted(glob.glob(os.path.join(p, "trace_rank*.json")))
            if not found:
                raise FileNotFoundError(f"no trace_rank*.json under {p}")
            out.extend(found)
        else:
            out.append(p)
    return out


def _rank_of(payload: dict, fallback: int) -> int:
    rank = (payload.get("otherData") or {}).get("rank")
    return int(rank) if isinstance(rank, int) else fallback


def merge_report(payloads: list[dict]) -> dict:
    """Fold validated per-rank payloads into one report dict.

    ``tables[name]`` holds per-rank and merged :meth:`TailHistogram.
    summary` rows for each span family in ``_SPAN_TABLES``; ``timeline``
    is the cross-rank event list sorted by timestamp within each clock
    domain (category), since wire/trainer/sim clocks are not comparable.
    """
    tables: dict[str, dict] = {}
    merged: dict[str, TailHistogram] = {}
    timeline: list[dict] = []
    dropped = 0
    for k, payload in enumerate(payloads):
        rank = _rank_of(payload, k)
        dropped += int((payload.get("otherData") or {}).get("dropped", 0))
        for ev in payload["traceEvents"]:
            ph, name = ev["ph"], ev["name"]
            if ph == "X" and name in _SPAN_TABLES:
                per_rank = tables.setdefault(name, {})
                h = per_rank.get(rank)
                if h is None:
                    h = per_rank[rank] = TailHistogram(**_HIST_KW)
                m = merged.get(name)
                if m is None:
                    m = merged[name] = TailHistogram(**_HIST_KW)
                dur = float(ev.get("dur", 0.0))
                if dur > 0:
                    h.record(dur)
                    m.record(dur)
            elif ph == "i" and ev.get("cat") in _TIMELINE_CATS:
                timeline.append({"ts": float(ev["ts"]), "rank": rank,
                                 "name": name, "cat": ev.get("cat"),
                                 "tid": int(ev.get("tid", 0)),
                                 "args": ev.get("args") or {}})
    timeline.sort(key=lambda e: (e["cat"], e["ts"], e["rank"]))
    report = {"ranks": sorted({_rank_of(p, i)
                               for i, p in enumerate(payloads)}),
              "dropped_records": dropped,
              "tables": {}, "timeline": timeline}
    for name, per_rank in sorted(tables.items()):
        if merged[name].count == 0:
            continue      # e.g. zero-duration spans on a virtual clock
        report["tables"][name] = {
            "per_rank": {str(r): h.summary()
                         for r, h in sorted(per_rank.items())},
            "merged": merged[name].summary(),
        }
    return report


def _fmt_us(v: float) -> str:
    if not math.isfinite(v):
        return "    n/a"
    if v >= 1e6:
        return f"{v / 1e6:7.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:6.2f}ms"
    return f"{v:6.1f}us"


def render(report: dict, *, events: int = 40) -> str:
    """Human-readable tail tables + control timeline."""
    lines: list[str] = []
    for name, tab in report["tables"].items():
        lines.append(f"== {name} completion time "
                     f"(per rank + merged, µs-domain) ==")
        lines.append(f"{'rank':>6} {'count':>8} {'p50':>8} {'p99':>8} "
                     f"{'p999':>8} {'max':>8}")
        rows = list(tab["per_rank"].items()) + [("all", tab["merged"])]
        for rank, s in rows:
            lines.append(f"{rank:>6} {s['count']:>8d} {_fmt_us(s['p50'])} "
                         f"{_fmt_us(s['p99'])} {_fmt_us(s['p999'])} "
                         f"{_fmt_us(s['max'])}")
        lines.append("")
    tl = report["timeline"]
    lines.append(f"== control timeline ({len(tl)} events"
                 + (f", showing last {events}" if len(tl) > events else "")
                 + ") ==")
    for ev in tl[-events:]:
        args = " ".join(f"{k}={v}" for k, v in ev["args"].items())
        lines.append(f"  [{ev['cat']:>6}] t={ev['ts']:14.1f}us "
                     f"rank{ev['rank']} {ev['name']:<14} {args}")
    if report["dropped_records"]:
        lines.append(f"\n!! {report['dropped_records']} records dropped to "
                     "ring-buffer wraparound — raise REPRO_TRACE_CAPACITY")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Merge per-rank Perfetto traces into tail tables and "
                    "a control-plane event timeline.")
    p.add_argument("paths", nargs="+",
                   help="trace JSON files and/or directories holding "
                        "trace_rank*.json")
    p.add_argument("--json", action="store_true",
                   help="emit the merged report as JSON instead of tables")
    p.add_argument("--events", type=int, default=40,
                   help="max timeline events to render (text mode)")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    paths = discover(args.paths)
    report = merge_report([load_trace(p) for p in paths])
    report["sources"] = paths
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report, events=args.events))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
