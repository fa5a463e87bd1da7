"""The port's launcher with the §3.2 control plane in the loop
(``repro_torch/launch/train.py --adaptive``) against the JAX package's.

The reference's launcher runs once for the file, in a subprocess on 4
forced host devices, on ``gpt2-smoke`` for 6 steps at drop rate 0, with
``optireduce`` and with ``optireduce_rounds --incast 1``. At drop 0 the
loss fraction is 0 on both sides, so the policy sequence does not depend on
the draws: the ``adaptive:`` lines, where they fall among the steps, and
the ``--report`` JSON must be equal, exactly. At a drop rate above 0 the
port's launcher is held to the policies its own ``ControlPlane`` emits on
the loss fractions the run observed.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import pytest  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime import ControlPlane, StepTelemetry  # noqa: E402

RUNS = {"optireduce": [],
        "optireduce_rounds": ["--strategy", "optireduce_rounds",
                              "--incast", "1"]}
COMMON = ["--smoke", "--steps", "6", "--seq-len", "32", "--adaptive",
          "--drop-rate", "0", "--log-every", "1"]

CHILD = r"""
import contextlib, io, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.launch import train
out = sys.argv[1]
runs, common = json.loads(sys.argv[2]), json.loads(sys.argv[3])
res = {}
for name, extra in runs.items():
    rep = os.path.join(out, name + ".json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main([*common, "--report", rep, *extra]) == 0
    with open(rep) as f:
        res[name] = {"stdout": buf.getvalue(), "report": json.load(f)}
with open(os.path.join(out, "ref.json"), "w") as f:
    json.dump(res, f)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_adaptive")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out),
                           json.dumps(RUNS), json.dumps(COMMON)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with open(out / "ref.json") as f:
        return json.load(f)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = train.run(argv)
    return records, buf.getvalue()


def _decisions(stdout):
    """The step and ``adaptive:`` lines in order, each step line cut to its
    index (losses print rounded, and the packages' differ in the last
    digits)."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("step "):
            out.append(" ".join(line.split()[:2]))
        elif line.startswith("adaptive:"):
            out.append(line)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_adaptive_lines_and_report_match_reference(ref, name, tmp_path):
    rep = tmp_path / "report.json"
    records, stdout = _run([*COMMON, "--device", "cpu", "--report", str(rep),
                            *RUNS[name]])
    assert len(records) == 6 and all(r["loss_frac"] == 0 for r in records)
    want = _decisions(ref[name]["stdout"])
    assert _decisions(stdout) == want
    assert any(line.startswith("adaptive:") for line in want)
    with open(rep) as f:
        assert json.load(f) == ref[name]["report"]


def test_lossy_run_follows_its_own_control_plane():
    """At drop 0.05 on gpt2-smoke the loss fraction crosses the codec's
    band both ways: the codec turns off (a rebuild) and back on (the
    first step function, from the cache). The launcher must switch exactly
    where a ControlPlane fed the run's own loss fractions says."""
    records, stdout = _run(["--smoke", "--device", "cpu", "--steps", "8",
                            "--seq-len", "16", "--adaptive", "--drop-rate",
                            "0.05", "--seed", "0", "--log-every", "1"])
    control = ControlPlane.create(n_nodes=4)
    control.use_hadamard = True
    want, current = [], True
    for step, rec in enumerate(records):
        want.append(f"step {step}")
        control.observe(StepTelemetry(step=step, loss_frac=rec["loss_frac"],
                                      step_time=rec["step_s"]))
        if control.use_hadamard != current:      # urgent: switch at once
            current = control.use_hadamard
            how = "cached step reused" if current else "step rebuilt"
            want.append(f"adaptive: use_hadamard={current} incast=1 "
                        f"active=None weights=None dead=() ({how})")
    assert _decisions(stdout) == want
    assert stdout.count("(step rebuilt)") == 1
    assert stdout.count("(cached step reused)") == 1


def test_trace_holds_one_step_span_a_step(tmp_path):
    records, stdout = _run(["--smoke", "--device", "cpu", "--steps", "3",
                            "--seq-len", "16", "--adaptive", "--drop-rate",
                            "0.002", "--trace", str(tmp_path / "trace"),
                            "--trace-capacity", "256"])
    assert obs.get_tracer() is None          # torn down after the write
    path = tmp_path / "trace" / "trace_rank00.json"
    assert f"-> {path}" in stdout
    with open(path) as f:
        payload = obs.validate_trace(json.load(f))
    events = payload["traceEvents"]
    steps = [e for e in events if e["name"] == "step" and e["ph"] == "X"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    assert sum(e["name"] == "loss_frac" for e in events) == 3
    assert payload["otherData"]["strategy"] == "optireduce"
    rep = report.merge_report([payload])
    assert rep["tables"]["step"]["merged"]["count"] == 3
