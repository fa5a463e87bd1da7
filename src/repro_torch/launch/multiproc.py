"""Multi-process peer launcher: ``python -m repro_torch.launch.multiproc``
(DESIGN §9).

Counterpart of ``src/repro/launch/multiproc.py``: the same flags, worker
loop and report, plus ``--device`` (the card unless the caller asks for
the CPU; without CUDA it raises, as ``launch/train.py`` does).

Spawns ``--nprocs`` independent OS processes, each running a single
:class:`~repro_torch.net.peer.HostPeer` over its own single-socket UDP
backend, with ranks resolved through the TCP rendezvous coordinator
(``repro_torch.net.rendezvous``) instead of a fixed peer list — the launch
path where a peer can really crash, be ejected, restart and be readmitted.
``--backend=inproc`` runs the *same* worker loop as threads over the
in-memory coordinator and loopback fabric, so a machine without sockets
still exercises the whole launch path (join -> lockstep phase barriers ->
membership events -> telemetry -> checkpoint). On the card the rank-threads
launch their kernels on one CUDA context; the UDP workers each hold their
own.

One worker step is four rendezvous-fenced phases (barrier tag = ``step *
PHASES_PER_STEP + phase``)::

    events -> phase1 encode | phase2 send1 | phase3 reduce+send2 | phase4
    decode -> telemetry -> ControlPlane -> checkpoint

Each step's random operands come from ``GeneratorDraws(fold_in(key(seed),
step))`` at bucket 0 (the port's keys; the reference's threefry draws can
be served instead through ``_run_peer``'s ``draws_fn``). Every worker
derives the same per-step data matrix from the seed with numpy and
contributes its own row.

Crash lifecycle: ``--kill-rank R --kill-step S`` makes the worker holding
rank R SIGKILL itself after the step-S phase-1 fence (mid-step: the
survivors' receive deadlines expire and the step completes *degraded*);
the coordinator's EOF detection frees the slot, survivors drain the death
event at their next step fence and force-eject R through the ControlPlane.
With ``--restart``, the parent respawns the dead uid once the group has
moved past the crash step; the fresh process restores from ``--ckpt-dir``
(``train/checkpoint.py``), rejoins — claiming the freed slot, required
only from its ``since`` step boundary — and readmits through PROBATION.

Each worker writes a JSON report (per-step output checksums, observed
loss, live set, detector statuses, membership generation; beside the
reference's keys, ``start_s`` — seconds from the worker's start to its
first fence — and each step's host ``step_s``); the parent merges them
into ``--report``. On CUDA the parent builds every kernel before the
first worker starts, so no worker, and no respawned rank, compiles inside
the run.

    PYTHONPATH=src python -m repro_torch.launch.multiproc --backend inproc \\
        --device cpu --steps 3 --elems 2048 --drop-rate 0.05
    PYTHONPATH=src python -m repro_torch.launch.multiproc --backend udp \\
        --device cpu --steps 2 --elems 4096 --drop-rate 0.1 --deadline 2.0
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time


def _tag(step: int, phase: int) -> int:
    from repro_torch.net import PHASES_PER_STEP
    return step * PHASES_PER_STEP + phase


class _Killed(Exception):
    """Thread-mode stand-in for SIGKILL (inproc backend)."""


class _StepMembership:
    """Step-boundary snapshot of the rendezvous live set.

    The peer must see *one* membership for all four phases of a step: a
    rank that leaves while a slower rank is still inside its phase 3/4
    (the unfenced tail of the last step) must stay receivable until that
    step completes — its packets are already on the wire — or results
    would depend on which rank finished first.  :meth:`refresh` runs at
    the step fence, right after the membership events drain, so deaths
    still degrade the very next step.

    The snapshot applies the same rule the barriers do: a member with
    ``since > tag(step, 0)`` is not yet required — a rejoiner whose JOIN
    races a survivor's step fence (its ``since`` is rounded up to the
    next step boundary) must not be waited on this step, or whether the
    survivors skip it would depend on restart timing.
    """

    def __init__(self, client):
        self._client = client
        self._live: frozenset | None = None

    def refresh(self, step: int) -> None:
        mem = self._client.membership()
        self._live = None if mem is None else frozenset(
            m.rank for m in mem.members if m.since <= _tag(step, 0))

    def is_live(self, rank: int) -> bool:
        return self._live is None or rank in self._live


# ----------------------------------------------------------------- worker
def _compile_stage_fns(peer, elems: int, draws) -> None:
    """Run every stage function of the peer once on zeros *before* the
    first barrier.

    A worker (above all a rejoiner) whose first step loads the kernel
    libraries, creates the CUDA generators and grows the allocator would
    stall its stage-1 sends while every survivor's receive deadline
    expires — scoring it as a straggler the moment it came back.  Warming
    here instead happens while the others wait at the entry fence, which
    costs them a bounded barrier wait, not masked gradient entries.  Runs
    entirely off the backend: zero inputs through the same stage functions
    the phases call (the reference traces and compiles its jitted ones
    here).
    """
    import torch

    from repro_torch.core.pipeline import HTQuant

    n, dev = peer.n, peer.device
    x = torch.zeros(elems, dtype=torch.float32, device=dev)
    if isinstance(peer.codec, HTQuant):
        x1, amax = peer._enc_local(x, draws, 0)
        data, lo, stp = peer._enc_finish(x1, amax, draws, 0)
    else:
        data, _ = peer._enc(x, draws, 0, None)
        lo = stp = None
    s = data.shape[0] // n
    received = torch.zeros((n, s), dtype=data.dtype, device=dev)
    mask = torch.ones((n, s), dtype=torch.float32, device=dev)
    wire2 = peer._red(received, mask, lo, stp, None, draws, 0)
    gathered = torch.zeros(n * wire2.shape[0], dtype=wire2.dtype, device=dev)
    peer._dec(gathered, lo, stp, draws, 0).cpu()


def _run_peer(client, backend, args, *, uid: int, kill_fn=None,
              draws_fn=None, t0: float | None = None) -> dict:
    """One worker's whole life: join -> fenced step loop -> leave.

    ``client`` is a rendezvous client (TCP or Local — same duck type),
    ``backend`` the datagram fabric, ``kill_fn(client)`` the crash
    injection for the scripted kill scenario, ``draws_fn(step)`` the
    step's :class:`~repro_torch.core.pipeline.Draws` provider (default:
    ``GeneratorDraws(fold_in(key(seed), step))`` on the peer's device),
    ``t0`` the ``time.monotonic()`` the worker started at (default: now).
    """
    t0 = time.monotonic() if t0 is None else t0
    import numpy as np
    import torch

    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import GeneratorDraws, OptiReduceConfig
    from repro_torch.net import HostPeer, aggregate_reports
    from repro_torch.runtime import ControlPlane
    from repro_torch.train import checkpoint as ckpt_lib

    rank, _, start_step = client.join()
    if hasattr(backend, "attach"):
        backend.attach(rank, client.addr_of)
    # per-rank tracer (DESIGN §12): thread-local so the inproc mode's N
    # rank-threads in one process keep separate rings; in udp mode each
    # worker is its own process and this is simply its tracer
    tracer = None
    if getattr(args, "trace_dir", None):
        from repro_torch.obs import trace as obs_trace
        tracer = obs_trace.configure_thread(True, rank=rank)
    cfg = OptiReduceConfig(strategy=args.strategy, drop_rate=0.0,
                           hadamard_block=args.hadamard_block,
                           packet_elems=args.packet_elems)
    step_mem = _StepMembership(client)
    peer = HostPeer(rank, backend, cfg, default_deadline=args.deadline,
                    membership=step_mem, device=args.device)
    control = ControlPlane.create(
        n_nodes=args.nprocs,
        detector_kw=dict(probation=args.probation,
                         min_active=args.min_active))

    if draws_fn is None:
        def draws_fn(step):
            return GeneratorDraws(fold_in(key(args.seed), step), cfg,
                                  peer.device)
    model = torch.zeros(args.elems, dtype=torch.float32, device=peer.device)
    resumed_from = None
    ckpt_dir = None
    if args.ckpt_dir:
        ckpt_dir = os.path.join(args.ckpt_dir, f"rank{rank:02d}")
        try:
            got_step, tree, _ = ckpt_lib.restore(
                ckpt_dir, {"step": torch.zeros((), dtype=torch.int64),
                           "model": model}, device=peer.device)
            resumed_from = int(got_step)
            model = tree["model"].to(torch.float32)
        except FileNotFoundError:
            pass

    _compile_stage_fns(peer, args.elems, draws_fn(start_step))
    start_s = time.monotonic() - t0

    records = []
    for step in range(start_step, args.steps):
        if args.step_sleep > 0:
            time.sleep(args.step_sleep)
        client.barrier(_tag(step, 0), timeout=args.barrier_timeout)
        ts = time.monotonic()
        for kind, r, gen in client.events():
            control.apply_membership(kind, r, gen)
        step_mem.refresh(step)
        # every worker derives the same per-step data matrix from the seed
        # and contributes its own row — what makes cross-run bitwise
        # comparison (multiproc UDP vs single-process inproc) meaningful
        data = np.random.default_rng(args.seed + step).standard_normal(
            (args.nprocs, args.elems)).astype(np.float32)
        draws = draws_fn(step)
        st0 = tracer.now() if tracer is not None else 0.0
        peer.phase1_encode(data[rank], draws, step, 0)
        client.barrier(_tag(step, 1), timeout=args.barrier_timeout)
        if kill_fn is not None and rank == args.kill_rank \
                and step == args.kill_step and start_step <= args.kill_step:
            kill_fn(client)
        peer.phase2_send_stage1(step, 0)
        client.barrier(_tag(step, 2), timeout=args.barrier_timeout)
        rep = peer.phase3_reduce_send_stage2(step, 0)
        client.barrier(_tag(step, 3), timeout=args.barrier_timeout)
        out, rep2 = peer.phase4_decode(step, 0)
        rep.merge(rep2)
        tel = aggregate_reports([rep], step)
        control.observe(tel)
        if tracer is not None:
            tracer.complete("step", "trainer", ts=st0,
                            dur=tracer.now() - st0,
                            args={"step": step,
                                  "loss_frac": round(float(tel.loss_frac),
                                                     6),
                                  "timed_out": bool(tel.timed_out)})
        model += out
        host = out.detach().cpu().contiguous().numpy()
        records.append({
            "step": step,
            "checksum": hashlib.sha256(host.tobytes()).hexdigest()[:16],
            "loss_frac": round(float(tel.loss_frac), 6),
            "stage2_dropped": float(rep.stage2_dropped),
            "timed_out": bool(tel.timed_out),
            "live": [int(r) for r in sorted(
                client.membership().live_ranks())]
            if client.membership() is not None else list(range(args.nprocs)),
            "statuses": [control.detector.status(i)
                         for i in range(args.nprocs)],
            "generation": int(client.generation),
            "skipped": sorted(set(int(s) for s in rep.skipped_senders)),
            "step_s": time.monotonic() - ts,
        })
        if ckpt_dir:
            ckpt_lib.save(ckpt_dir, step,
                          {"step": torch.tensor(step, dtype=torch.int64),
                           "model": model},
                          meta={"uid": uid, "rank": rank}, keep=2)
    client.leave()
    trace_path = None
    if tracer is not None:
        from repro_torch.obs import export as obs_export
        trace_path = obs_export.write_trace(
            args.trace_dir, tracer, meta={"uid": uid, "backend":
                                          type(backend).__name__})
    return {"uid": uid, "rank": rank, "start_step": start_step,
            "resumed_from": resumed_from, "exit": "ok", "steps": records,
            "trace": trace_path, "start_s": start_s}


def _sigkill_self(client) -> None:
    os.kill(os.getpid(), signal.SIGKILL)


def _thread_crash(client) -> None:
    client.crash()
    raise _Killed()


def _worker_main(args) -> int:
    """``--worker`` subprocess entry (udp backend only)."""
    t0 = time.monotonic()
    from repro_torch.net import (RendezvousClient, UdpProcessBackend,
                                 bernoulli_drops)

    drop_fn = bernoulli_drops(args.drop_rate, seed=args.drop_seed) \
        if args.drop_rate > 0 else None
    backend = UdpProcessBackend(args.nprocs, drop_fn=drop_fn)
    host, _, port = args.rendezvous.rpartition(":")
    client = RendezvousClient((host or "127.0.0.1", int(port)),
                              uid=args.uid, peer_port=backend.port)
    try:
        result = _run_peer(client, backend, args, uid=args.uid,
                           kill_fn=_sigkill_self, t0=t0)
    finally:
        backend.close()
        client.close()
    if args.report_file:
        with open(args.report_file, "w") as f:
            json.dump(result, f)
    return 0


# ----------------------------------------------------------------- parent
def _spawn(args, uid: int, rendezvous: str, report_file: str
           ) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.multiproc", "--worker",
           "--uid", str(uid), "--rendezvous", rendezvous,
           "--report-file", report_file, "--device", args.device,
           "--nprocs", str(args.nprocs), "--steps", str(args.steps),
           "--elems", str(args.elems), "--strategy", args.strategy,
           "--packet-elems", str(args.packet_elems),
           "--hadamard-block", str(args.hadamard_block),
           "--drop-rate", str(args.drop_rate),
           "--drop-seed", str(args.drop_seed),
           "--seed", str(args.seed), "--deadline", str(args.deadline),
           "--step-sleep", str(args.step_sleep),
           "--barrier-timeout", str(args.barrier_timeout),
           "--kill-rank", str(args.kill_rank),
           "--kill-step", str(args.kill_step),
           "--probation", str(args.probation),
           "--min-active", str(args.min_active)]
    if args.ckpt_dir:
        cmd += ["--ckpt-dir", args.ckpt_dir]
    if args.trace_dir:
        cmd += ["--trace-dir", args.trace_dir]
    env = dict(os.environ)
    # make `python -m repro_torch.launch.multiproc` resolvable in the child
    # even when the parent found the package via a sys.path edit
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = env.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_root not in paths:
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [p for p in paths if p])
    return subprocess.Popen(cmd, env=env)


def _launch_udp(args) -> dict:
    from repro_torch.net import RendezvousServer

    server = None
    if args.rendezvous == "auto":
        server = RendezvousServer(args.nprocs,
                                  heartbeat_timeout=args.heartbeat_timeout)
        rdv = f"{server.addr[0]}:{server.addr[1]}"
    else:
        rdv = args.rendezvous
    reports_dir = tempfile.mkdtemp(prefix="multiproc_reports_")
    procs: dict[int, tuple[subprocess.Popen, str]] = {}
    report_files: list[str] = []

    def spawn(uid: int, attempt: int) -> None:
        path = os.path.join(reports_dir, f"uid{uid}_a{attempt}.json")
        report_files.append(path)
        procs[uid] = (_spawn(args, uid, rdv, path), path)

    deadline = time.monotonic() + args.timeout
    respawned = False
    want_restart = args.restart and args.kill_rank >= 0
    failures: list[str] = []
    try:
        for uid in range(args.nprocs):
            spawn(uid, 0)
        while procs:
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"multiproc: wall-clock timeout ({args.timeout}s) — "
                    f"{len(procs)} workers still running")
            for uid in list(procs):
                p, path = procs[uid]
                rc = p.poll()
                if rc is None:
                    continue
                del procs[uid]
                if rc == -signal.SIGKILL and want_restart and not respawned:
                    # the scripted victim: respawn once the coordinator has
                    # processed the death (slot freed) and the survivors
                    # have finished the post-crash step — a step-(k+1)
                    # fence arrival means every survivor drained the death
                    # event at its step-(k+1) boundary (the step's phase
                    # barriers cannot all release otherwise), so the
                    # ejection is observed at every rank before the rejoin
                    # can race a fence
                    respawned = True
                    while (server is not None
                           and (len(server.live_ranks()) >= args.nprocs
                                or server.latest_step() <= args.kill_step + 1)
                           and time.monotonic() < deadline):
                        time.sleep(0.05)
                    spawn(uid, 1)
                elif rc != 0:
                    failures.append(f"uid {uid} exited {rc}")
            time.sleep(0.05)
    finally:
        # a timeout or an error here must not leave workers behind
        for p, _ in procs.values():
            p.kill()
            p.wait()
        if server is not None:
            server.close()
    if failures:
        raise SystemExit("multiproc: " + "; ".join(failures))

    workers = []
    for path in report_files:
        if os.path.exists(path):
            with open(path) as f:
                workers.append(json.load(f))
        else:
            workers.append({"exit": "killed", "report": path})
    return {"backend": "udp", "nprocs": args.nprocs, "steps": args.steps,
            "strategy": args.strategy,
            "scenario": {"kill_rank": args.kill_rank,
                         "kill_step": args.kill_step,
                         "restart": bool(args.restart)},
            "workers": workers}


def _launch_inproc(args, draws_fn=None) -> dict:
    """Same worker loop as threads over the in-memory coordinator — the
    socket-free path through the full launch machinery."""
    from repro_torch.net import (InprocBackend, LocalCoordinator,
                                 bernoulli_drops)

    coord = LocalCoordinator(args.nprocs)
    drop_fn = bernoulli_drops(args.drop_rate, seed=args.drop_seed) \
        if args.drop_rate > 0 else None
    backend = InprocBackend(args.nprocs, drop_fn=drop_fn)
    results: dict[str, dict] = {}
    errors: list = []
    lock = threading.Lock()

    def run(uid: int, attempt: int) -> None:
        label = f"uid{uid}_a{attempt}"
        client = coord.client(uid)
        try:
            res = _run_peer(client, backend, args, uid=uid,
                            kill_fn=_thread_crash, draws_fn=draws_fn)
            with lock:
                results[label] = res
        except _Killed:
            with lock:
                results[label] = {"uid": uid, "exit": "killed",
                                  "rank": client.rank}
        except Exception as e:            # surface, never hang the join
            with lock:
                errors.append((uid, e))

    threads = {uid: threading.Thread(target=run, args=(uid, 0), daemon=True)
               for uid in range(args.nprocs)}
    for t in threads.values():
        t.start()
    deadline = time.monotonic() + args.timeout
    want_restart = args.restart and args.kill_rank >= 0
    respawned = False
    while any(t.is_alive() for t in threads.values()) or \
            (want_restart and not respawned):
        if time.monotonic() > deadline:
            raise SystemExit(f"multiproc: wall-clock timeout "
                             f"({args.timeout}s)")
        if want_restart and not respawned:
            with lock:
                # threads race their joins, so the victim's uid is whoever
                # ended up holding --kill-rank; detect the death by outcome
                victim = next((w["uid"] for w in results.values()
                               if w.get("exit") == "killed"), None)
            # respawn only after the survivors have FINISHED the
            # post-crash step (a step-(k+2) fence arrival means every
            # survivor's step-(k+1) drain observed the ejection) so the
            # rejoin cannot race the death into one event drain and hide
            # the EJECTED state from the status trail
            if victim is not None and \
                    len(coord.live_ranks()) < args.nprocs and \
                    coord.latest_step() > args.kill_step + 1:
                respawned = True
                t2 = threading.Thread(target=run, args=(victim, 1),
                                      daemon=True)
                threads[f"{victim}r"] = t2
                t2.start()
        time.sleep(0.02)
        with lock:
            if errors:
                raise SystemExit(f"multiproc workers failed: {errors}")
    with lock:
        if errors:
            raise SystemExit(f"multiproc workers failed: {errors}")
    return {"backend": "inproc", "nprocs": args.nprocs, "steps": args.steps,
            "strategy": args.strategy,
            "scenario": {"kill_rank": args.kill_rank,
                         "kill_step": args.kill_step,
                         "restart": bool(args.restart)},
            "workers": [results[k] for k in sorted(results)]}


# ------------------------------------------------------------------- CLI
def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.multiproc",
        description="N-process HostPeer runtime over UDP + TCP rendezvous")
    ap.add_argument("--nprocs", type=int, default=4)
    ap.add_argument("--backend", default="udp", choices=("udp", "inproc"),
                    help="udp: N OS processes, single-socket backends, TCP "
                         "rendezvous; inproc: N threads over the in-memory "
                         "coordinator (socket-free fallback)")
    ap.add_argument("--device", default=None,
                    help="torch device of every peer's stage functions "
                         "(default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--elems", type=int, default=4096,
                    help="fp32 gradient elements per peer per step")
    ap.add_argument("--strategy", default="optireduce")
    ap.add_argument("--packet-elems", type=int, default=256)
    ap.add_argument("--hadamard-block", type=int, default=256)
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--drop-seed", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=0.25,
                    help="per-round receive deadline (seconds)")
    ap.add_argument("--step-sleep", type=float, default=0.0,
                    help="pause before each step's entry fence — paces the "
                         "run so a restarted worker (process spawn + "
                         "warm-up) can rejoin mid-run in demos and tests")
    ap.add_argument("--barrier-timeout", type=float, default=120.0)
    ap.add_argument("--heartbeat-timeout", type=float, default=6.0)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="parent wall-clock bound for the whole run")
    ap.add_argument("--rendezvous", default="auto",
                    help="'auto' starts an in-parent coordinator; or "
                         "host:port of an external one")
    ap.add_argument("--report", default=None,
                    help="write the merged JSON report here")
    ap.add_argument("--ckpt-dir", default=None,
                    help="per-rank checkpoint root (crash resume)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="record per-rank structured traces (DESIGN §12) "
                         "and write trace_rankNN.json Perfetto files into "
                         "DIR; paths land in the merged report, and "
                         "python -m repro_torch.obs.report DIR renders the "
                         "cross-rank tail tables + control timeline")
    ap.add_argument("--kill-rank", type=int, default=-1,
                    help="scripted crash: this rank SIGKILLs itself")
    ap.add_argument("--kill-step", type=int, default=-1,
                    help="...after this step's phase-1 fence")
    ap.add_argument("--restart", action="store_true",
                    help="respawn the killed worker once the group moved on")
    ap.add_argument("--probation", type=int, default=2,
                    help="clean steps a readmitted peer needs to go ACTIVE")
    ap.add_argument("--min-active", type=int, default=1)
    # internal (worker subprocess) flags
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--uid", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--report-file", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None, *, draws_fn=None) -> dict | int:
    """Run the launcher. ``draws_fn(step)``, with ``--backend inproc``,
    serves each step's draws to every rank-thread (see :func:`_run_peer`)."""
    args = build_parser().parse_args(argv)
    if args.worker:
        return _worker_main(args)
    from repro_torch.kernels.runtime import resolve_device

    device = resolve_device(args.device)
    args.device = str(device)
    if draws_fn is not None and args.backend != "inproc":
        raise ValueError("draws_fn serves rank-threads: --backend inproc")
    if device.type == "cuda":
        # once, before any worker starts: N workers would otherwise each
        # run every nvcc at once, and a respawned rank would compile
        # inside the run; a failed build raises here
        from repro_torch.kernels import build
        build.build_all()
    if args.kill_rank >= 0 and args.restart and not args.ckpt_dir:
        args.ckpt_dir = tempfile.mkdtemp(prefix="multiproc_ckpt_")
    report = _launch_udp(args) if args.backend == "udp" \
        else _launch_inproc(args, draws_fn)
    if args.trace_dir:
        report["trace_dir"] = args.trace_dir
        report["traces"] = sorted(w["trace"] for w in report["workers"]
                                  if w.get("trace"))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    ok = [w for w in report["workers"] if w.get("exit") == "ok"]
    print(f"multiproc[{args.backend}] nprocs={args.nprocs} "
          f"steps={args.steps} ok_workers={len(ok)} "
          f"killed={sum(1 for w in report['workers'] if w.get('exit') == 'killed')}")
    return report


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
