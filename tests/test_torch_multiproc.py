"""The port's multi-process peer runtime (``repro_torch/launch/multiproc.py``)
on the CPU, against the port's single-process ``HostRing`` and against the
reference launcher.

Within the port, bitwise (the launch's claim, DESIGN §9): 4 launched
workers over the in-memory coordinator, and 4 UDP processes over the TCP
rendezvous, give per rank and step the same output checksums as
``HostRing.allreduce`` under the same scripted wire loss
(``bernoulli_drops`` hashes the packet headers) and the same draws
(``KeyedDraws(fold_in(key(seed), step))``: every operand keyed on the step
key, as the reference's peer keys them). A thread-mode
crash and a real SIGKILL walk the victim through ejection and PROBATION
readmission from its checkpoint, as the reference's
``tests/test_multiproc.py`` asserts.

Against the reference: the JAX launcher runs once, in one child process
(``repro.launch.multiproc --backend inproc --ckpt-dir``, ``optireduce`` and
``optireduce_q``), and the port's inproc launch is served the reference's
draws (``RefDraws``: the reference's peer draws every operand from its
step key ``fold_in(PRNGKey(seed), step)``, whatever the site). Per step and
rank the loss, stage-2 loss, timeout, detector statuses, skipped senders,
live set and membership generation are equal exactly (virtual time,
header-hashed drops; the last two not on the last step, where a rank that
finished first may already have left when another records). Each rank's
final checkpointed model — the sum of its 3 decoded steps — agrees
elementwise within ``MODEL_ATOL[strategy] + MODEL_RTOL * |ref|``. The port
rotates with the butterfly and the reference with Kronecker matmuls (~1e-7
a rotation, ROADMAP C): 1e-5 absolute, as ``tests/test_torch_net_ring.py``.
The quantized decode also rounds ``code * step + lo`` twice where XLA fuses
one FMA (<= 2.4e-7 an entry, ROADMAP C), and the inverse rotation's first
row sums a block's 256 such differences over sqrt(256): at most
3 steps x 16 x 2.4e-7 = 1.152e-5. ``MODEL_RTOL`` is 2 ulp of the value
(a lost stage-2 span decodes to its grid's low end, as in the reference:
values up to ~60). Measured: at most 6.0e-7 (``optireduce``) and 7.9e-6
(``optireduce_q``, at a block's first entry). A quantized code on a floor
boundary could move by one, a grid step spread over a block — far above
the tolerance; these inputs hit none. Checksums are not compared across
packages.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro_torch.core.keys import fold_in, key  # noqa: E402
from repro_torch.core.pipeline import KeyedDraws, OptiReduceConfig  # noqa: E402
from repro_torch.launch import multiproc as mp  # noqa: E402
from repro_torch.net import (HostRing, bernoulli_drops,  # noqa: E402
                             udp_available)
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402

pytestmark = [pytest.mark.net, pytest.mark.multiproc]

needs_udp = pytest.mark.skipif(not udp_available(),
                               reason="sandbox forbids UDP sockets")

N, DROP_RATE, DROP_SEED = 4, 0.05, 3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = ["--device", "cpu"]
# the reference comparison: (elems, steps) and the elementwise bound on
# |model_port - model_ref| (see the docstring)
REF_ELEMS, REF_STEPS = 2048, 3
MODEL_ATOL = {"optireduce": 1e-5, "optireduce_q": REF_STEPS * 16 * 2.4e-7}
MODEL_RTOL = 2.4e-7

CHILD = r"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
import json, os, sys
from repro.launch import multiproc as mp

root, elems, steps, rate, seed = sys.argv[1:6]
out = {}
for strategy in ("optireduce", "optireduce_q"):
    ckpt = os.path.join(root, "ref_" + strategy)
    out[strategy] = mp.main(["--backend", "inproc", "--nprocs", "4",
                             "--steps", steps, "--elems", elems,
                             "--strategy", strategy, "--drop-rate", rate,
                             "--drop-seed", seed, "--ckpt-dir", ckpt])
with open(os.path.join(root, "ref.json"), "w") as f:
    json.dump(out, f)
print("child OK")
"""


def _checksum(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def _hostring_checksums(elems, steps, seed=0):
    """Per-rank per-step checksums from the port's single-process HostRing
    under the identical scripted wire (the parity oracle)."""
    cfg = OptiReduceConfig(strategy="optireduce", drop_rate=0.0,
                           hadamard_block=256, packet_elems=256)
    ring = HostRing(N, cfg, backend="inproc", device="cpu",
                    drop_fn=bernoulli_drops(DROP_RATE, seed=DROP_SEED))
    out = {}
    try:
        for step in range(steps):
            data = np.random.default_rng(seed + step).standard_normal(
                (N, elems)).astype(np.float32)
            res, _ = ring.allreduce(
                torch.from_numpy(data),
                KeyedDraws(fold_in(key(seed), step), cfg,
                           torch.device("cpu")), step=step, bucket=0)
            out[step] = [_checksum(res[r]) for r in range(N)]
    finally:
        ring.close()
    return out


def _by_rank(report):
    return {w["rank"]: w for w in report["workers"] if "steps" in w}


class RefDraws:
    """The reference launcher's draws at one step: its peer keys every
    operand on the step key ``fold_in(PRNGKey(seed), step)`` itself (the
    port's key path ``(seed, step)`` folded into ``PRNGKey``, the site not
    folded in): the sign ``rademacher_sign(key)`` and a quantizer's noise
    ``uniform(fold_in(key, salt))``. The launcher's config draws no loss
    (``drop_rate`` 0: the wire observes it), so a mask is all ones."""

    def __init__(self, seed, step):
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), step)

    def sign(self, bucket, block):
        return torch.from_numpy(np.array(jsign(self.key, block)))

    def noise(self, bucket, salt, shape):
        k = jax.random.fold_in(self.key, salt)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))

    def mask(self, bucket, receiver, n, s, self_index=None):
        return torch.ones((n, s))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multiproc")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(root), str(REF_ELEMS),
         str(REF_STEPS), str(DROP_RATE), str(DROP_SEED)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(root / "ref.json") as f:
        return root, json.load(f)


def _final_models(ckpt_root):
    like = {"step": torch.zeros((), dtype=torch.int64),
            "model": torch.zeros(REF_ELEMS)}
    out = {}
    for r in range(N):
        step, tree, _ = ckpt_lib.restore(
            os.path.join(ckpt_root, f"rank{r:02d}"), like)
        assert step == REF_STEPS - 1 and int(tree["step"]) == step
        out[r] = tree["model"]
    return out


# ---------------------------------------------------------------- inproc
def test_inproc_launch_matches_hostring_bitwise():
    """4 launched workers over the LocalCoordinator == the port's
    single-process HostRing, checksum-for-checksum."""
    elems, steps = 2048, 3
    report = mp.main(["--backend", "inproc", "--nprocs", str(N),
                      "--steps", str(steps), "--elems", str(elems),
                      "--drop-rate", str(DROP_RATE),
                      "--drop-seed", str(DROP_SEED)] + CPU)
    want = _hostring_checksums(elems, steps)
    by_rank = _by_rank(report)
    assert sorted(by_rank) == list(range(N))
    for step in range(steps):
        got = [by_rank[r]["steps"][step]["checksum"] for r in range(N)]
        assert got == want[step], f"step {step} diverged from HostRing"
        # stage-1 loss really flowed (scripted wire, not a lossless path)
        assert any(by_rank[r]["steps"][step]["loss_frac"] > 0
                   for r in range(N))


@pytest.mark.parametrize("strategy", ["optireduce", "optireduce_q"])
def test_inproc_launch_matches_reference_launcher(strategy, ref, tmp_path):
    """The port's inproc launch with the reference's draws injected ==
    the reference launcher's records; final per-rank models within
    MODEL_ATOL + MODEL_RTOL |ref|."""
    root, want = ref
    want = _by_rank(want[strategy])
    ckpt = str(tmp_path / "port")
    report = mp.main(["--backend", "inproc", "--nprocs", str(N),
                      "--steps", str(REF_STEPS), "--elems", str(REF_ELEMS),
                      "--strategy", strategy, "--drop-rate", str(DROP_RATE),
                      "--drop-seed", str(DROP_SEED), "--ckpt-dir", ckpt]
                     + CPU, draws_fn=lambda step: RefDraws(0, step))
    got = _by_rank(report)
    assert sorted(got) == sorted(want) == list(range(N))
    keys = ("step", "loss_frac", "stage2_dropped", "timed_out", "live",
            "statuses", "skipped", "generation")
    # the live set and generation are read when a rank records its step;
    # on the last step, in either package, a rank that finished first may
    # already have left, so those two are compared on the earlier steps
    last = ("live", "generation")
    lost = 0.0
    for r in range(N):
        assert got[r]["start_step"] == want[r]["start_step"] == 0
        assert len(got[r]["steps"]) == len(want[r]["steps"]) == REF_STEPS
        for g, w in zip(got[r]["steps"], want[r]["steps"]):
            ks = [k for k in keys
                  if g["step"] < REF_STEPS - 1 or k not in last]
            assert {k: g[k] for k in ks} == {k: w[k] for k in ks}
            lost += g["loss_frac"]
    assert lost > 0                    # the wire really lost packets
    port_m = _final_models(ckpt)
    ref_m = _final_models(str(root / f"ref_{strategy}"))
    for r in range(N):
        excess = ((port_m[r] - ref_m[r]).abs() - MODEL_ATOL[strategy]
                  - MODEL_RTOL * ref_m[r].abs())
        assert float(excess.max()) <= 0, (strategy, r, float(excess.max()))


def test_inproc_crash_ejection_and_probation_readmission():
    """Thread-mode SIGKILL at step 1: the step completes degraded, the
    victim is ejected, its restart restores the checkpoint and walks
    EJECTED -> PROBATION -> ACTIVE in the survivors' detectors."""
    kill_rank, kill_step, steps = 1, 1, 6
    report = mp.main(["--backend", "inproc", "--nprocs", str(N),
                      "--steps", str(steps), "--elems", "1024",
                      "--drop-rate", "0.1",
                      "--kill-rank", str(kill_rank),
                      "--kill-step", str(kill_step), "--restart"] + CPU)
    killed = [w for w in report["workers"] if w.get("exit") == "killed"]
    assert len(killed) == 1 and killed[0]["rank"] == kill_rank
    by_rank = _by_rank(report)
    assert sorted(by_rank) == list(range(N))

    rejoiner = by_rank[kill_rank]
    assert rejoiner["resumed_from"] == kill_step - 1   # checkpointed step
    assert rejoiner["start_step"] > kill_step
    assert rejoiner["steps"][-1]["step"] == steps - 1

    for r in range(N):
        if r == kill_rank:
            continue
        recs = by_rank[r]["steps"]
        trail = [s["statuses"][kill_rank] for s in recs]
        # the kill step itself completes (degraded), ejection lands next
        assert trail[kill_step] == "active"
        assert recs[kill_step + 1]["skipped"] == [kill_rank]
        assert "ejected" in trail[kill_step + 1:]
        # the rejoin readmits through probation, never straight to active
        post = trail[trail.index("ejected"):]
        assert "probation" in post
        assert post.index("probation") < len(post) - 1 or \
            post[-1] == "probation"


def test_a_failed_worker_ends_the_launch(monkeypatch):
    """A worker's exception ends the inproc launch with a non-zero exit,
    never a report."""
    def broken(*args, **kw):
        raise RuntimeError("stage function failed")
    monkeypatch.setattr(mp, "_compile_stage_fns", broken)
    with pytest.raises(SystemExit, match="stage function failed"):
        mp.main(["--backend", "inproc", "--steps", "1", "--elems", "256",
                 "--timeout", "60"] + CPU)


# ------------------------------------------------------------------- udp
def _run_udp(argv, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "report.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.multiproc",
             "--report", path] + argv + CPU,
            env=env, timeout=timeout, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-2000:]
        with open(path) as f:
            return json.load(f)


@pytest.mark.slow
@needs_udp
def test_udp_4proc_launch_matches_hostring_bitwise():
    """4 OS processes over the TCP rendezvous, each one HostPeer on its own
    UDP socket, are bitwise the single-process HostRing under the same
    scripted loss. The generous --deadline keeps real wall-clock out of
    the arrival masks."""
    elems, steps = 4096, 2
    report = _run_udp(["--backend", "udp", "--nprocs", str(N),
                       "--steps", str(steps), "--elems", str(elems),
                       "--drop-rate", str(DROP_RATE),
                       "--drop-seed", str(DROP_SEED),
                       "--deadline", "2.0", "--timeout", "240"],
                      timeout=300)
    want = _hostring_checksums(elems, steps)
    by_rank = _by_rank(report)
    assert sorted(by_rank) == list(range(N))
    for step in range(steps):
        got = [by_rank[r]["steps"][step]["checksum"] for r in range(N)]
        assert got == want[step], f"step {step} diverged from HostRing"
    assert all(w["start_s"] > 0 for w in by_rank.values())


@pytest.mark.slow
@needs_udp
def test_udp_sigkill_ejection_and_readmission():
    """Real SIGKILL mid-run: survivors eject the corpse and keep stepping;
    the relaunched process rejoins via the rendezvous, restores its
    checkpoint, and at least one survivor records its probationary
    readmission (detector re-ejection on real timing noise is legal)."""
    kill_rank, kill_step, steps = 1, 1, 12
    report = _run_udp(["--backend", "udp", "--nprocs", str(N),
                       "--steps", str(steps), "--elems", "1024",
                       "--drop-rate", "0.05", "--deadline", "1.0",
                       "--step-sleep", "2", "--kill-rank", str(kill_rank),
                       "--kill-step", str(kill_step), "--restart",
                       "--timeout", "400"],
                      timeout=480)
    assert report["scenario"]["kill_rank"] == kill_rank
    killed = [w for w in report["workers"] if w.get("exit") == "killed"]
    assert len(killed) == 1
    by_rank = _by_rank(report)
    assert sorted(by_rank) == list(range(N))

    rejoiner = by_rank[kill_rank]
    assert rejoiner["resumed_from"] == kill_step - 1
    assert rejoiner["start_step"] > kill_step
    assert rejoiner["steps"][-1]["step"] == steps - 1

    survivors = [by_rank[r] for r in range(N) if r != kill_rank]
    for w in survivors:
        trail = [s["statuses"][kill_rank] for s in w["steps"]]
        assert "ejected" in trail[kill_step:]
        assert w["steps"][-1]["step"] == steps - 1
    # the kill step completed degraded everywhere (no survivor aborted it)
    assert all(any(s["step"] == kill_step for s in w["steps"])
               for w in survivors)
    assert any("probation" in [s["statuses"][kill_rank] for s in w["steps"]]
               for w in survivors)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_an_expired_rank_is_not_told(pkg):
    """A live rank whose heartbeats stop reaching the coordinator for longer
    than its heartbeat timeout is removed from the group, the others' fence
    releases without it, and it is never told: its connection stays open,
    so it waits out its own barrier timeout — in the reference's
    rendezvous and in the port's copy alike (ROADMAP C)."""
    import importlib
    rdv = importlib.import_module(f"{pkg}.net.rendezvous")
    server = rdv.RendezvousServer(2, heartbeat_timeout=0.5, tick=0.05)
    live = rdv.RendezvousClient(server.addr, uid=0, heartbeat_interval=0.1)
    mute = rdv.RendezvousClient(server.addr, uid=1, heartbeat_interval=60.0)
    try:
        live.join()
        mute.join()
        deadline = time.monotonic() + 10.0
        while len(server.live_ranks()) == 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.live_ranks() == (live.rank,)
        live.barrier(0, timeout=5.0)               # released without it
        assert ("death", mute.rank) in [e[:2] for e in live.events()]
        with pytest.raises(rdv.RendezvousTimeout):
            mute.barrier(0, timeout=1.0)
        assert mute.is_live(mute.rank)             # its view never changed
    finally:
        live.close()
        mute.close()
        server.close()


def test_sigkill_helper_uses_sigkill():
    """The scripted kill must be a real SIGKILL (no atexit, no TCP FIN) —
    the rendezvous EOF/heartbeat path is what detects it."""
    src = mp._sigkill_self.__code__.co_names
    assert "SIGKILL" in src and "kill" in src
    assert signal.SIGKILL == 9


@pytest.mark.parametrize("released", [True, False], ids=["released",
                                                          "never"])
def test_a_respawned_worker_joins_only_once_released(tmp_path, released):
    """A respawned worker does its start (imports, device) first and then
    waits for the parent's join file: its join follows the release however
    long the start took, and without a release it gives up at --timeout."""
    release = tmp_path / "release"
    args = mp.build_parser().parse_args(
        ["--worker", "--device", "cpu", "--join-file", str(release),
         "--timeout", "20" if released else "0.3"])
    if not released:
        with pytest.raises(SystemExit, match="not released in 0.3s"):
            mp._await_release(args)
        return
    out = {}
    waiter = threading.Thread(
        target=lambda: out.setdefault("t", mp._await_release(args)))
    waiter.start()
    time.sleep(0.3)
    assert waiter.is_alive()                  # no join before the release
    before = time.monotonic()
    release.touch()
    waiter.join(10)
    assert not waiter.is_alive() and out["t"] >= before
