"""Training launcher of the port: OptiReduce-synced data-parallel training
with the P peers on one card.

Counterpart of ``src/repro/launch/train.py``. It takes the reference's
flags; the values this slice does not run (the wire transports) raise,
naming their ROADMAP item. ``--tp T`` trains with T tensor-parallel ranks
beside the ``--dp`` data peers (``train/trainer.py``), ``--production-mesh``
on the reference's 16 x 16 ``(data, model)`` grid. ``--dp-mode fsdp`` trains
ZeRO-3 style: the sharded weights' gradients are reduced by OptiReduce's
reduce-scatter (``train/trainer.py``). ``--recovery
stale|ef|ef+budget`` arms the loss-recovery codec (core/recovery.py) and
threads its state through the steps; ``ef+budget`` adds the control plane's
phase-aware ``LossBudget``, its phase fed from the step count and the loss.
``--ckpt-dir`` saves ``(params, opt_state)`` (with ``rec_state`` under
``--recovery``) every ``--ckpt-every`` steps and after the last, in the
background (``train/checkpoint.py``); ``--resume`` continues from the
newest. As in the reference, the state after step s is saved under the
label s and a resume starts at step s, so a resume from a periodic
checkpoint runs its step again (ROADMAP C); the final save, labelled
``--steps``, does not. ``--adaptive`` closes the §3.2 loop as the reference
does: each
step's loss fraction and host time feed the runtime ``ControlPlane``, and
when its ``SyncPolicy`` moves, the next step runs the policy's step function
(from a ``PolicyStepCache``, or built anew with ``build_train_step``; the
optimizer state carries over). ``--report`` writes the per-step detector
state as JSON, ``--trace`` a Perfetto trace of the steps and the control
plane's transitions (read it with ``python -m repro_torch.obs.report``).
``--dp`` is the number of peers simulated on the card, ``--device`` where
they run (the CUDA device unless asked otherwise).
On the card every Hadamard encode/decode, every drop-compensated mean and,
with ``--strategy optireduce_q``, every quantization stage (grid pass,
stage-1 codes, dequant + mean, stage-2 codes) is a launch of the port's
CUDA kernels. ``--strategy`` takes every registered name: the paper's round
schedule (``optireduce_rounds``, ``tar_rounds``, ``tar_rounds_q``, with
``--incast`` its I) and the Gloo-ring / NCCL-tree / BCube baselines
(``gloo_ring``, ``ring_ht``, ``nccl_tree``, ``bcube``) among them.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-paper \\
      --steps 3 --dp 4 --drop-rate 0.01
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-paper \\
      --steps 3 --dp 4 --drop-rate 0.01 --strategy optireduce_q
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-paper \\
      --steps 3 --dp 4 --drop-rate 0.01 --strategy optireduce_rounds \\
      --incast 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2 --dp-mode fsdp --drop-rate 0.05
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2 --dp 2 --tp 2 --drop-rate 0.05
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 1 --production-mesh --global-batch 16
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 6 --adaptive --drop-rate 0.002 --trace build/trace
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2 --recovery ef --drop-pattern burst --drop-rate 0.05 \\
      --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 4 --recovery ef --drop-pattern burst --drop-rate 0.05 \\
      --ckpt-dir build/ckpt --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import recovery as recovery_lib
from repro_torch.core.allreduce import OptiReduceConfig, strategy_names
from repro_torch.core.bucket_plan import BucketPlan
from repro_torch.core.pipeline import RingTopology, TarTopology, resolve_spec
from repro_torch.core.keys import generator, key as make_key
from repro_torch.core.safeguards import LossMonitor
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.runtime import MODES as KERNEL_MODES
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime import (ControlPlane, PolicyStepCache, StepTelemetry,
                                 SyncPolicy)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.trainer import TrainConfig, build_train_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--dp", type=int, default=4,
                    help="number of data-parallel peers simulated on the card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--strategy", default="optireduce",
                    help=f"one of {', '.join(strategy_names())}")
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--drop-pattern", default="tail")
    ap.add_argument("--recovery", default="none",
                    choices=recovery_lib.MODES,
                    help="gradient-loss recovery beyond zero-fill (DESIGN "
                         "§8): 'stale' fills lost wire entries from the "
                         "previous step's synced bucket; 'ef' adds "
                         "per-peer error-feedback residuals; 'ef+budget' "
                         "adds the phase-aware loss budget")
    ap.add_argument("--transport", default="lossy")
    ap.add_argument("--wire-deadline", type=float, default=None)
    ap.add_argument("--rendezvous", default=None)
    ap.add_argument("--incast", type=int, default=1)
    ap.add_argument("--adaptive", action="store_true",
                    help="drive next-step Hadamard/incast/participation "
                         "from the runtime ControlPlane (paper §3.2 + the "
                         "straggler detector) fed by observed telemetry")
    ap.add_argument("--rebalance", action="store_true",
                    help="with --adaptive: emit straggler-proportional "
                         "shard weights and link-avoiding schedules instead "
                         "of relying on ejection alone")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write a per-step JSON report (per-peer straggler "
                         "scores, shard weights, dead links)")
    ap.add_argument("--trace", nargs="?", const=".", default=None,
                    metavar="DIR",
                    help="record step spans and every ControlPlane "
                         "transition, and write Perfetto trace_event JSON "
                         "into DIR (default '.') at exit; inspect with "
                         "python -m repro_torch.obs.report")
    ap.add_argument("--trace-capacity", type=int, default=None,
                    help="trace ring-buffer capacity in records (default "
                         "65536; the oldest records drop on wraparound)")
    ap.add_argument("--policy-cache", type=int, default=4,
                    help="step functions kept per SyncPolicy (LRU)")
    ap.add_argument("--dp-mode", default="replicated")
    ap.add_argument("--sync-mode", default="pipelined",
                    choices=("pipelined", "scan", "vmap"))
    ap.add_argument("--kernel-mode", default=None, choices=KERNEL_MODES,
                    help="kernel dispatch (kernels/runtime): auto (by "
                         "device), kernel (require the card) or ref "
                         "(require the plain versions)")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save checkpoints here (every --ckpt-every steps "
                         "and after the last)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


# flags of the reference whose non-default values wait for later slices
_NOT_PORTED = (
    ("transport", "lossy", "--transport inproc|udp (wire): ROADMAP A18"),
    ("wire_deadline", None, "--wire-deadline: ROADMAP A18"),
    ("rendezvous", None, "--rendezvous: ROADMAP A18"),
)


def run(argv=None) -> list[dict]:
    """Parse ``argv``, train, and return one record per step run (loss,
    grad_norm, loss_frac, skipped, ``filled`` under ``--recovery``, step_s:
    host seconds to the step's last result)."""
    ap = parser()
    args = ap.parse_args(argv)
    mesh = (make_production_mesh() if args.production_mesh
            else make_host_mesh(dp=args.dp, tp=args.tp))
    tp = mesh.shape.get("model", 1)
    n_data = mesh.shape.get("data", 1)
    if args.transport != "lossy" and tp != 1:
        ap.error("--transport needs --tp=1: with model parallelism every tp "
                 "sibling of a data rank would run the io_callback, "
                 "advancing the ring's per-rank exchange counter tp times "
                 "per bucket and pairing deposits from different buckets "
                 "into one wire exchange")
    for name, default, what in _NOT_PORTED:
        if getattr(args, name) != default:
            raise NotImplementedError(f"not ported yet: {what}")
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} mesh={mesh.shape} device={device} "
          f"strategy={args.strategy} drop_rate={args.drop_rate}", flush=True)

    tracer = None
    if args.trace is not None:
        tracer = obs.configure(
            True, capacity=args.trace_capacity or obs.trace.DEFAULT_CAPACITY)
    control = None
    with_budget = args.recovery == "ef+budget"
    if args.adaptive or args.report or with_budget:
        control = ControlPlane.create(n_nodes=n_data,
                                      rebalance=args.rebalance,
                                      **({"budget": {}} if with_budget
                                         else {}))

    tc = TrainConfig(
        sync=OptiReduceConfig(strategy=args.strategy,
                              drop_rate=args.drop_rate,
                              drop_pattern=args.drop_pattern,
                              incast=args.incast, recovery=args.recovery,
                              hadamard_block=1024),
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr),
        dp_mode=args.dp_mode, microbatch=args.microbatch,
        sync_mode=args.sync_mode,
        kernel_mode=args.kernel_mode, seq_chunk=min(512, args.seq_len))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  seed=args.seed))
    key = make_key(args.seed)
    params = init_params(generator(key, device), cfg, device=device, tp=tp)
    step_fn, opt = build_train_step(cfg, tc, mesh, device=device)
    opt_state = opt.init(params)
    rec_state = None
    if args.recovery != "none":
        plan = BucketPlan.for_tree(params, tc.bucket_elems)
        rec_state = recovery_lib.init_state(
            recovery_lib.parse(args.recovery), plan.num_buckets,
            plan.bucket_elems, peers=n_data, device=device)

    def ckpt_tree():
        return ((params, opt_state) if rec_state is None
                else (params, opt_state, rec_state))

    start_step = 0
    ckpt = ckpt_lib.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        try:
            start_step, restored, _ = ckpt_lib.restore(
                args.ckpt_dir, ckpt_tree(), device=device)
            if rec_state is None:
                params, opt_state = restored
            else:
                params, opt_state, rec_state = restored
            print(f"resumed from step {start_step}", flush=True)
        except FileNotFoundError:
            pass

    if args.adaptive:
        # start from the configured codec so step 0 never rebuilds, and learn
        # which knobs this spec can observe, by the reference's rules:
        # incast only lowers rounds schedules; use_hadamard matters when
        # toggling it resolves to another spec object (every factory-
        # registered name); degraded participation needs a mask-capable or
        # reschedulable topology, weights and dead links a resizable one
        control.use_hadamard = tc.sync.use_hadamard
        topo = resolve_spec(tc.sync).topology
        rounds = isinstance(topo, TarTopology) and topo.schedule == "rounds"
        ring = isinstance(topo, RingTopology) and topo.kind == "ring"
        incast_matters = rounds
        ht_matters = (resolve_spec(dataclasses.replace(
            tc.sync, use_hadamard=True)) is not resolve_spec(
                dataclasses.replace(tc.sync, use_hadamard=False)))
        participation_matters = isinstance(topo, TarTopology) or ring
        rebalance_matters = args.rebalance and (rounds or ring)
        deadlink_matters = rounds or ring
        step_cache = PolicyStepCache(maxsize=max(1, args.policy_cache))
        step_cache.put(_policy_of(tc.sync), step_fn)
        stable_rec, stable_for = None, 0

    monitor = LossMonitor(skip_threshold=tc.sync.skip_threshold)
    records, report_rows = [], []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = data.host_batch(step, 0, 1)
        st0 = tracer.now() if tracer is not None else 0.0
        t_step = time.perf_counter()
        if rec_state is None:
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step, key)
        else:
            params, opt_state, rec_state, metrics = step_fn(
                params, opt_state, batch, step, key, rec_state=rec_state)
        m = {k: float(v) for k, v in metrics.items()}  # waits for the step
        m["step_s"] = time.perf_counter() - t_step
        records.append(m)
        if with_budget:
            # the phase follows the run's progress and the loss curve; the
            # loss EMA is fed through control.observe below
            control.state.budget.update_phase(
                progress=(step + 1) / max(args.steps, 1),
                train_loss=m["loss"])
        if step % args.log_every == 0 or step == args.steps - 1:
            rate = (step - start_step + 1) / (time.perf_counter() - t0)
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} "
                  f"loss_frac {m['loss_frac']:.5f} "
                  f"skipped {int(m['skipped'])} ({rate:.2f} it/s)",
                  flush=True)
        if control is not None:
            control.observe(StepTelemetry(step=step, loss_frac=m["loss_frac"],
                                          step_time=m["step_s"]))
            if args.report:
                det = control.detector
                report_rows.append({
                    "step": step,
                    "scores": [float(x) for x in det.scores()],
                    "weights": [int(w) for w in det.weights()],
                    "active": [int(p) for p in det.active_peers()],
                    "dead_links": [list(link)
                                   for link in control.dead_links()],
                    "dead_link_events": []})     # wire only (A18)
                if with_budget:
                    budget = control.state.budget
                    report_rows[-1]["budget"] = {
                        "phase": budget.phase, "loss_ema": budget.loss_ema,
                        "budget": budget.budget(),
                        "deadline_factor": budget.deadline_factor()}
        if args.adaptive:
            new_sync = control.apply(tc.sync)
            if not incast_matters:
                new_sync = dataclasses.replace(new_sync,
                                               incast=tc.sync.incast)
            if not ht_matters:
                new_sync = dataclasses.replace(
                    new_sync, use_hadamard=tc.sync.use_hadamard)
            if not participation_matters:
                new_sync = dataclasses.replace(
                    new_sync, active_peers=tc.sync.active_peers)
            if not rebalance_matters:
                new_sync = dataclasses.replace(new_sync, shard_weights=None)
            if not deadlink_matters:
                new_sync = dataclasses.replace(new_sync, dead_links=())
            # debounce: a growing incast ramps one step at a time, so wait
            # for the controller to settle; a codec flip, an ejection and a
            # link failure switch at once
            stable_for = stable_for + 1 if new_sync == stable_rec else 1
            stable_rec = new_sync
            urgent = (new_sync.use_hadamard != tc.sync.use_hadamard or
                      new_sync.active_peers != tc.sync.active_peers or
                      new_sync.dead_links != tc.sync.dead_links)
            if new_sync != tc.sync and (urgent or stable_for >= 3):
                tc = dataclasses.replace(tc, sync=new_sync)
                step_fn = step_cache.get(_policy_of(new_sync))
                if step_fn is not None:
                    how = "cached step reused"
                else:
                    step_fn, _ = build_train_step(cfg, tc, mesh,
                                                  device=device)
                    step_cache.put(_policy_of(new_sync), step_fn)
                    how = "step rebuilt"
                print(f"adaptive: use_hadamard={new_sync.use_hadamard} "
                      f"incast={new_sync.incast} "
                      f"active={new_sync.active_peers} "
                      f"weights={new_sync.shard_weights} "
                      f"dead={new_sync.dead_links} ({how})", flush=True)
        if tracer is not None:
            tracer.complete("step", "trainer", ts=st0,
                            dur=tracer.now() - st0,
                            args={"step": step,
                                  "loss_frac": round(m["loss_frac"], 6)})
            tracer.counter("loss_frac", m["loss_frac"])
        monitor.observe(step, m["loss_frac"], m["skipped"] > 0)
        if monitor.halted:
            print("HALT: excessive gradient loss (§3.4); rolling back")
            rb = monitor.rollback()
            if rb is not None:
                _, params = rb
        if ckpt and step > 0 and step % args.ckpt_every == 0:
            ckpt.save(step, ckpt_tree())
    if ckpt:
        ckpt.save(args.steps, ckpt_tree())
        ckpt.wait()
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"n_peers": control.detector.n_peers,
                       "rebalance": bool(args.rebalance),
                       "steps": report_rows}, f, indent=1)
        print(f"report: {len(report_rows)} steps -> {args.report}",
              flush=True)
    if tracer is not None:
        path = obs.export.write_trace(args.trace, tracer,
                                      meta={"transport": args.transport,
                                            "strategy": args.strategy})
        print(f"trace: {len(tracer)} records ({tracer.dropped} dropped) "
              f"-> {path}", flush=True)
        obs.configure(False)
    print("done", flush=True)
    return records


def _policy_of(sync: OptiReduceConfig) -> SyncPolicy:
    return SyncPolicy(use_hadamard=sync.use_hadamard, incast=sync.incast,
                      active_peers=sync.active_peers,
                      shard_weights=sync.shard_weights,
                      dead_links=sync.dead_links)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
