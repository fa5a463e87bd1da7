"""The port's tracer, histograms, exporter and report (``repro_torch/obs/``)
against the JAX package's ``repro.obs`` on the same calls.

Each side records into its own process-global tracer with an injected
clock that ticks the same way, so the exported ``trace_event`` lists must
be equal (bitwise: the same floats through the same arithmetic), ring
wraparound and the control plane's and the simulator's events included.
``TailHistogram`` quantiles and summaries are compared bitwise, and both
reports are run on one trace file.
"""
import contextlib
import io
import json

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.sim import netsim as jsim  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.sim import netsim  # noqa: E402


def _clock():
    t = [1000.0]

    def tick():
        t[0] += 0.00125
        return t[0]
    return tick


@pytest.fixture
def tracers():
    pair = (jobs.configure(True, capacity=4096, clock=_clock()),
            obs.configure(True, capacity=4096, clock=_clock()))
    yield pair
    jobs.reset()
    obs.reset()


def _drive(o, runtime_mod, sim_mod, tr):
    """The same calls on one package: direct records, the convenience
    spans, a control plane's transitions and a simulated job's rounds."""
    with tr.span("step", "trainer", step=0) as sp:
        sp.set(loss_frac=0.01)
    with o.span("encode", "trainer", tid=2):
        pass
    o.event("marker", args={"k": 1})
    tr.complete("round", "wire", ts=1.5, dur=0.25, tid=3,
                args={"sender": 1})
    tr.complete("round", "wire", ts=2.0, dur=-1.0)        # clamped to 0
    tr.counter("loss_frac", 0.0125)
    cp = runtime_mod.ControlPlane.create(
        n_nodes=4, detector_kw=dict(alpha=1.0, patience=1, cooldown=1,
                                    probation=1))
    for k, (loss, times, dead) in enumerate([
            (0.03, (1.0, 1.0, 1.0, 1.0), ()),
            (0.0, (1.0, 1.0, 1.0, 9.0), ((0, 1),)),
            (0.0, (1.0, 1.0, 1.0, 1.0), ((0, 1),)),
            (0.015, (1.0, 1.0, 1.0, 1.0), ()),
            (0.0, (1.0, 1.0, 1.0, 1.0), ())]):
        cp.observe(runtime_mod.StepTelemetry(step=k, loss_frac=loss,
                                             peer_stage_times=times,
                                             dead_link_events=dead))
    cp.apply_membership("leave", 2, generation=3)
    cp.apply_membership("join", 2)
    sim_mod.simulate_job("optireduce", n_nodes=8, bucket_bytes=1e7,
                         n_steps=3,
                         env=sim_mod.NetworkModel.environment("local_3.0",
                                                              seed=1))


def test_exported_events_match_reference(tracers):
    ref, port = tracers
    _drive(jobs, jrt, jsim, ref)
    _drive(obs, rt, netsim, port)
    assert len(port) == len(ref) > 50
    want = jobs.to_trace_events(ref.records(), pid=0)
    got = obs.to_trace_events(port.records(), pid=0)
    assert got == want
    names = {e["name"] for e in got}
    assert {"step", "encode", "round", "eject", "readmit", "hadamard",
            "dead_link", "membership", "policy_change"} <= names
    pw = jobs.trace_payload(ref, meta={"strategy": "optireduce"})
    pp = obs.trace_payload(port, meta={"strategy": "optireduce"})
    assert pp == pw
    assert obs.validate_trace(pw) is pw and jobs.validate_trace(pp) is pp


def test_ring_wraparound_drops_as_reference():
    ref = jobs.configure(True, capacity=8, clock=_clock())
    port = obs.configure(True, capacity=8, clock=_clock())
    try:
        for tr in (ref, port):
            for i in range(21):
                tr.event(f"e{i}", "policy", args={"i": i})
        assert (port.dropped, len(port)) == (ref.dropped, len(ref)) == (13, 8)
        assert port.records() == ref.records()
        port.clear()
        assert len(port) == 0 and port.dropped == 0
    finally:
        jobs.reset()
        obs.reset()
    assert obs.get_tracer() is None and not obs.is_enabled()
    with obs.span("nothing"):                      # the shared no-op span
        pass


def test_thread_tracer_preferred_as_in_reference():
    try:
        glob = obs.configure(True, capacity=16)
        local = obs.configure_thread(True, capacity=16, rank=3)
        assert obs.get_tracer() is local and local is not glob
        obs.configure_thread(False)
        assert obs.get_tracer() is glob
    finally:
        obs.reset()
    with pytest.raises(ValueError):
        obs.TraceConfig(capacity=0)


@pytest.mark.parametrize("payload", [
    [],
    {"traceEvents": None},
    {"traceEvents": [{"name": "a", "ph": "Q", "ts": 0, "pid": 0, "tid": 0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0,
                      "dur": -1}]},
    {"traceEvents": [{"name": "a", "ph": "C", "ts": 0, "pid": 0, "tid": 0,
                      "args": {"value": float("nan")}}]},
    {"traceEvents": [{"name": "a", "ph": "i", "ts": 0, "pid": 0.5,
                      "tid": 0}]},
])
def test_malformed_traces_rejected_as_in_reference(payload):
    with pytest.raises(jobs.TraceSchemaError) as want:
        jobs.validate_trace(payload)
    with pytest.raises(obs.TraceSchemaError) as got:
        obs.validate_trace(payload)
    assert str(got.value) == str(want.value)


def test_tail_histogram_matches_reference():
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.lognormal(0.0, 1.0, 5000),
                              [1e-9, 5e5]])              # both clamped
    ref, port = jobs.TailHistogram(), obs.TailHistogram()
    ref.record_many(samples)
    port.record_many(samples)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert port.quantile(q) == ref.quantile(q)
    assert port.summary() == ref.summary() and port.clamped == 2
    other_r, other_p = jobs.TailHistogram(), obs.TailHistogram()
    other_r.record(3.0, n=7)
    other_p.record(3.0, n=7)
    assert port.copy().merge(other_p).summary() == \
        ref.copy().merge(other_r).summary()
    with pytest.raises(ValueError):
        port.record(float("inf"))
    with pytest.raises(ValueError):
        port.merge(obs.TailHistogram(bins_per_octave=8))
    reg_r, reg_p = jobs.MetricsRegistry(), obs.MetricsRegistry()
    for reg in (reg_r, reg_p):
        reg.counter("c").inc(2)
        reg.gauge("g").set(0.5)
        reg.histogram("h", min_value=1e-3).record(0.25)
    assert reg_p.snapshot() == reg_r.snapshot()


def test_report_on_one_trace_matches_reference(tracers, tmp_path):
    _, port = tracers
    _drive(obs, rt, netsim, port)
    path = obs.write_trace(str(tmp_path / "trace"), port,
                           meta={"strategy": "optireduce"})
    assert path.endswith("trace_rank00.json")
    outs = []
    for main in (jreport.main, report.main):
        for argv in (["--json", str(tmp_path / "trace")],
                     [path, "--events", "5"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                got = main(argv)
            outs.append((got, buf.getvalue()))
    assert outs[2:] == outs[:2]
    rep = json.loads(outs[0][1])
    assert set(rep["tables"]) >= {"step", "round"}
    assert rep["timeline"] and rep["dropped_records"] == 0
