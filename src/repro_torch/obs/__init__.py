"""Tail-latency observability: tracing, tail histograms, exporters.

The port's copy of ``src/repro/obs/``: the same record schema, exporters
and report, and a process-global tracer of its own that every call site of
the port reads.

See DESIGN.md §12.  The hot-path contract is :func:`get_tracer` — one
module-global read returning ``None`` when tracing is off — so every
instrumented loop in the wire/runtime/sim layers stays a few ns per call
site until ``configure()`` (or ``--trace`` / ``REPRO_TRACE=1``) turns
recording on.
"""
from .trace import (TraceConfig, Tracer, Span, configure, configure_thread,
                    get_tracer, is_enabled, span, event, reset)
from .hist import TailHistogram, Counter, Gauge, MetricsRegistry, metrics
from .export import (TraceSchemaError, to_trace_events, trace_payload,
                     write_trace, validate_trace, trace_path)

__all__ = [
    "TraceConfig", "Tracer", "Span", "configure", "configure_thread",
    "get_tracer", "is_enabled", "span", "event", "reset",
    "TailHistogram", "Counter", "Gauge", "MetricsRegistry", "metrics",
    "TraceSchemaError", "to_trace_events", "trace_payload", "write_trace",
    "validate_trace", "trace_path",
]
