"""The port's launcher over the host wire (``--transport inproc|udp``,
``--wire-deadline``, ``--rendezvous``) against the JAX package's.

The reference's launcher runs once for the file, in a subprocess on 4
forced host devices: ``gpt2-smoke`` for 22 steps with ``--transport inproc
--drop-rate 0.02`` (past the 20 steps the ``AdaptiveTimeout`` profiles, so
the deadline leaves its default), then each wire guard, whose message is
recorded (the text after the program name). The inproc wire runs on
virtual time and its drops are a hash of the packet headers, so the
``wire[inproc]`` lines — peers, stage times, loss fraction, deadline —
must be equal, exactly: they depend on the bucket geometry and the
schedule, not on the parameters (whose draws differ between the two
packages). The guards must refuse with the
reference's messages.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.launch import train
from repro_torch.net import udp_available

COMMON = ["--smoke", "--seq-len", "16", "--global-batch", "4",
          "--log-every", "1"]
WIRE = ["--steps", "22", "--transport", "inproc", "--drop-rate", "0.02"]
GUARDS = {
    "fsdp": ["--transport", "inproc", "--dp-mode", "fsdp"],
    "vmap": ["--transport", "inproc", "--sync-mode", "vmap"],
    "ef": ["--transport", "inproc", "--recovery", "ef"],
    "ef+budget": ["--transport", "udp", "--recovery", "ef+budget"],
    "tp": ["--transport", "inproc", "--tp", "2", "--dp", "2"],
    "rendezvous": ["--transport", "inproc", "--rendezvous", "auto"],
}

CHILD = r"""
import contextlib, io, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.launch import train
common, wire, guards = (json.loads(a) for a in sys.argv[2:5])
res = {"guards": {}}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert train.main([*common, "--dp", "4", *wire]) == 0
res["stdout"] = buf.getvalue()
for name, flags in guards.items():
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            train.main([*common, "--steps", "1", *flags])
        except SystemExit as e:
            assert e.code == 2, e.code
    last = err.getvalue().strip().splitlines()[-1]
    res["guards"][name] = last.split(" error: ", 1)[1]
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_net_launch") / "ref.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), json.dumps(COMMON),
         json.dumps(WIRE), json.dumps(GUARDS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with open(out) as f:
        return json.load(f)


def _wire_lines(stdout, transport="inproc"):
    return [ln for ln in stdout.splitlines()
            if ln.startswith(f"wire[{transport}]")]


def test_wire_lines_equal_the_reference(ref):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = train.run([*COMMON, "--device", "cpu", *WIRE])
    got, want = _wire_lines(buf.getvalue()), _wire_lines(ref["stdout"])
    assert len(got) == len(want) == 22
    assert got == want
    assert "peers=4" in got[0]
    # the deadline left its default once the timeout was profiled
    assert got[0].endswith("deadline=1") and not got[-1].endswith(
        "deadline=1")
    losses = [float(ln.split("loss_frac=")[1].split()[0]) for ln in got]
    assert 0 < min(losses) and max(losses) < 0.05
    for rec, ln in zip(records, got):
        assert rec["wire_misses"] == 0 and rec["wire_error"] == 0
        assert rec["wire_loss_frac"] == pytest.approx(
            float(ln.split("loss_frac=")[1].split()[0]), abs=5e-6)
        assert math.isfinite(rec["loss"])
    # the engine's loss fraction is the previous exchange's: one bucket a
    # step, so step k's is step k-1's wire line
    assert records[0]["loss_frac"] == 0.0
    for prev, rec in zip(records, records[1:]):
        assert rec["loss_frac"] == pytest.approx(prev["wire_loss_frac"],
                                                 abs=1e-6)


@pytest.mark.parametrize("name", list(GUARDS))
def test_guards_refuse_with_the_reference_message(name, ref, capsys):
    with pytest.raises(SystemExit) as exc:
        train.run([*COMMON, "--device", "cpu", "--steps", "1",
                   *GUARDS[name]])
    assert exc.value.code == 2
    last = capsys.readouterr().err.strip().splitlines()[-1]
    assert last.split(" error: ", 1)[1] == ref["guards"][name]


def test_udp_with_rendezvous_trains(capsys):
    """Real localhost sockets, the peers joined through an in-process
    rendezvous, a short wire deadline; the stale-fill codec over the
    wire."""
    if not udp_available():
        pytest.skip("this environment forbids binding a localhost UDP "
                    "socket")
    records = train.run([*COMMON, "--device", "cpu", "--steps", "2",
                         "--transport", "udp", "--rendezvous", "auto",
                         "--wire-deadline", "0.05", "--drop-rate", "0.05",
                         "--recovery", "stale"])
    out = capsys.readouterr().out
    assert "rendezvous: 4 peers joined at 127.0.0.1:" in out
    assert len(_wire_lines(out, "udp")) == 2
    for rec in records:
        assert rec["wire_misses"] == 0 and rec["wire_error"] == 0
        assert 0 < rec["wire_loss_frac"] <= 0.05 + 0.02
        assert math.isfinite(rec["loss"]) and rec["skipped"] == 0
