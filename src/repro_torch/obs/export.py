"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON (DESIGN §12).

The port's copy of ``src/repro/obs/export.py``.

One :class:`~repro_torch.obs.trace.Tracer` exports to one JSON file per
rank — the `trace_event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-
PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_ consumed by ``chrome://tracing`` and
https://ui.perfetto.dev — and :func:`validate_trace` is the schema gate the
CI test and the report loader share, so a malformed trace fails loudly at
export or load, never as a silently-empty timeline.

Mapping from recorder tuples to trace events::

    ("X", ts, dur, name, cat, tid, args)  ->  ph="X" complete slice
    ("i", ts, 0,   name, cat, tid, args)  ->  ph="i" instant (scope "p")
    ("C", ts, 0,   name, cat, 0,  {value})->  ph="C" counter track

``pid`` is the rank (one process track per rank in the merged timeline),
``tid`` the logical lane inside it (peer id for wire events).  Timestamps
are exported in microseconds — ``ts * 1e6`` of whatever clock the producer
recorded in (virtual seconds on the inproc backend, monotonic seconds on
UDP/the trainer), which Perfetto renders fine since only deltas matter.
"""
from __future__ import annotations

import json
import math
import os

from .trace import Tracer

__all__ = ["TraceSchemaError", "to_trace_events", "trace_payload",
           "write_trace", "validate_trace", "trace_path"]

_PH = ("X", "i", "C", "M")


class TraceSchemaError(ValueError):
    """An exported/loaded trace does not satisfy the trace_event schema."""


def to_trace_events(records, pid: int = 0) -> list[dict]:
    """Recorder tuples -> trace_event dicts (seconds -> microseconds)."""
    out = []
    for ph, ts, dur, name, cat, tid, args in records:
        ev = {"name": name, "cat": cat or "default", "ph": ph,
              "ts": ts * 1e6, "pid": int(pid), "tid": int(tid)}
        if ph == "X":
            ev["dur"] = dur * 1e6
        elif ph == "i":
            ev["s"] = "p"                   # process-scoped instant
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def trace_payload(tracer: Tracer, *, pid: int | None = None,
                  meta: dict | None = None) -> dict:
    """The full JSON object for one rank's trace file."""
    pid = tracer.rank if pid is None else int(pid)
    events = to_trace_events(tracer.records(), pid=pid)
    # name the process track after the rank so the merged timeline reads
    # "rank 0", "rank 1", ... instead of bare pids
    events.insert(0, {"name": "process_name", "ph": "M", "pid": pid,
                      "tid": 0, "ts": 0,
                      "args": {"name": f"rank {pid}"}})
    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"rank": pid, "dropped": tracer.dropped,
                             **(meta or {})}}
    validate_trace(payload)
    return payload


def trace_path(trace_dir: str, rank: int) -> str:
    return os.path.join(trace_dir, f"trace_rank{rank:02d}.json")


def write_trace(path_or_dir: str, tracer: Tracer, *, pid: int | None = None,
                meta: dict | None = None) -> str:
    """Write one rank's Perfetto JSON; returns the path written.  A
    directory argument resolves to the conventional per-rank filename
    (``trace_rankNN.json``) the report CLI globs for."""
    path = path_or_dir
    if not path.endswith(".json"):
        os.makedirs(path, exist_ok=True)
        path = trace_path(path, tracer.rank if pid is None else pid)
    payload = trace_payload(tracer, pid=pid, meta=meta)
    with open(path, "w") as fh:
        json.dump(payload, fh)
        fh.write("\n")
    return path


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise TraceSchemaError(msg)


def validate_trace(payload: dict) -> dict:
    """Schema-gate one trace JSON object; returns it for chaining.

    Checks the invariants both Perfetto and ``repro_torch.obs.report`` rely on:
    a ``traceEvents`` list of dicts, each with a string ``name``, a known
    ``ph``, finite numeric ``ts`` and int ``pid``/``tid``; ``X`` events a
    finite non-negative ``dur``; ``C`` events a numeric ``args.value``.
    """
    _check(isinstance(payload, dict), "trace payload is not a JSON object")
    events = payload.get("traceEvents")
    _check(isinstance(events, list), "payload lacks a traceEvents list")
    for k, ev in enumerate(events):
        where = f"traceEvents[{k}]"
        _check(isinstance(ev, dict), f"{where} is not an object")
        _check(isinstance(ev.get("name"), str) and ev["name"],
               f"{where} lacks a name")
        ph = ev.get("ph")
        _check(ph in _PH, f"{where} ph {ph!r} not in {_PH}")
        ts = ev.get("ts")
        _check(isinstance(ts, (int, float)) and math.isfinite(ts),
               f"{where} ts {ts!r} is not a finite number")
        for fld in ("pid", "tid"):
            _check(isinstance(ev.get(fld), int),
                   f"{where} {fld} {ev.get(fld)!r} is not an int")
        if ph == "X":
            dur = ev.get("dur")
            _check(isinstance(dur, (int, float)) and math.isfinite(dur)
                   and dur >= 0,
                   f"{where} dur {dur!r} is not a finite non-negative "
                   "number")
        if ph == "C":
            val = (ev.get("args") or {}).get("value")
            _check(isinstance(val, (int, float)) and math.isfinite(val),
                   f"{where} counter args.value {val!r} is not finite")
        args = ev.get("args")
        if args is not None:
            _check(isinstance(args, dict), f"{where} args is not an object")
    return payload
