"""Training launcher of the port: OptiReduce-synced data-parallel training
with the P peers on one card.

Counterpart of ``src/repro/launch/train.py``, with the reference's flags.
``--transport inproc|udp`` exchanges each bucket's stage-1 shards between
host peers over a wire backend (``repro_torch/net``: in-memory loopback,
or localhost UDP sockets, which need an environment that lets a process
bind them) and masks by what arrived; ``--drop-rate`` then injects i.i.d.
wire loss (``bernoulli_drops``), ``--wire-deadline`` is the receive
deadline before the ``AdaptiveTimeout`` is profiled, and ``--rendezvous
auto|host:port`` (udp) joins the ring's peers through the socket
rendezvous, whose live membership view they consume. Each step then ends
by letting the wire's exchanges land, and its per-peer stage times,
timeouts and received fractions feed the ``ControlPlane`` (one
``wire[...]`` line a logged step). ``--tp T`` trains with T tensor-parallel
ranks beside the ``--dp`` data peers (``train/trainer.py``),
``--production-mesh`` on the reference's 16 x 16 ``(data, model)`` grid.
``--dp-mode fsdp`` trains ZeRO-3 style: the sharded weights' gradients are
reduced by OptiReduce's reduce-scatter (``train/trainer.py``).
``--recovery stale|ef|ef+budget`` arms the loss-recovery codec
(core/recovery.py) and threads its state through the steps; ``ef+budget``
adds the control plane's phase-aware ``LossBudget``, its phase fed from the
step count and the loss.
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
``--dp`` is the number of data-parallel peers. Run as one process, the
launcher holds all of them on one card, as the leading axis of stacked
tensors (``core/collectives.py``), ``--device`` where they run (the CUDA
device unless asked otherwise). Run under ``torchrun`` (``WORLD_SIZE`` set)
it runs one peer a rank, as the reference runs one a device: ``--dp`` is
the world size (another value is an error), each rank runs on
``cuda:(LOCAL_RANK % device_count())`` unless ``--device cpu``, and the
sync's collectives go over a ``torch.distributed`` process group,
``--dist-backend nccl`` (the default on the card; NCCL refuses two ranks
on one card) or ``gloo`` (the default on the CPU; it stages CUDA tensors
through the host). Rank 0 prints and writes the report, trace and
checkpoints. This form runs replicated data parallelism and, with
``--dp-mode fsdp``, ZeRO-3 on one pod in ``--sync-mode scan`` or
``pipelined``. Under FSDP each rank holds only its shard of every sharded
leaf and of its optimizer state: it draws the parameters one full leaf at
a time and keeps its slice (``train/elastic.py``); ``--ckpt-dir`` gathers
the shards one leaf at a time and rank 0 writes the full leaves, the
format the one-process form writes, and ``--resume`` hands each rank its
slice of them, so either form resumes the other's checkpoints (at the same
world size; resuming over ranks at another is a later slice). ``--dp N
--tp T`` under torchrun takes a world of N x T, rank ``i * T + t`` data
index i and tp rank t (the reference's ``("data", "model")`` mesh, model
innermost): each rank holds only its tp shard of every tp-sharded leaf and
of its moments (drawn a full leaf at a time, checkpointed as full leaves
gathered over its tp group), and the model's tp sums run in its tp group;
the dense, MoE, SSM and frontend-prefix families (a rank holds and
computes only its own ``E_pad / T`` experts, its own ``H / T`` SSM heads;
under ``--prefix`` every rank draws the global batch's prefix embeddings
from ``(--seed, step)`` alike and keeps its data index's rows), and
``--seq-parallel`` with the dense block (a rank's residual stream its
sequence slice, gathered and reduce-scattered in its tp group). With
``--dp-mode fsdp`` as well (FSDP x TP) rank ``i * T + t`` holds only data shard i of
tp chunk t of every leaf sharded over both, and of its moments: init
cuts both from each full leaf as it is drawn, a checkpoint gathers each
leaf over the data group and then over the tp group into the full leaf,
and ``--resume`` cuts them again
(``train/elastic.py``'s ``rank_cuts``). The launcher has no pod flag (nor
the reference's): the ``(pod, data)`` grid over ranks runs through
``build_train_step(..., group=)`` on a pod mesh (``tools/distcheck.py
--pod-train``). ``--production-mesh``, ``--sync-mode vmap``,
``--recovery``, ``--transport``, ``--adaptive``, and with ``--tp`` the
hybrid family and ``--seq-parallel`` with the MoE or SSM block over ranks
raise (later slices of ROADMAP A18c), as does ``--seq-parallel`` on a
sequence (prefix and tokens) that does not split over T, and pods x tp
and Adafactor over tp ranks in ``build_train_step``.
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
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 --transport inproc --drop-rate 0.02
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2 --transport udp --rendezvous auto --wire-deadline 0.05
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch gpt2-paper --steps 3 --drop-rate 0.01 --dist-backend gloo
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --device cpu --steps 2 --drop-rate 0.01 --dp-mode fsdp
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --device cpu --dist-backend gloo --dp 2 --tp 2 --steps 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --device cpu --dist-backend gloo --dp 2 --tp 2 --steps 2 \\
      --dp-mode fsdp
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import collectives
from repro_torch.core import recovery as recovery_lib
from repro_torch.core.allreduce import OptiReduceConfig, strategy_names
from repro_torch.core.bucket_plan import BucketPlan
from repro_torch.core.pipeline import (RingTopology, TarTopology,
                                       WireTransport, resolve_spec)
from repro_torch.core.keys import key as make_key
from repro_torch.core.safeguards import LossMonitor
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.runtime import MODES as KERNEL_MODES
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.models.transformer import check_tp_ranks
from repro_torch.net import (HostRing, RendezvousClient, RendezvousServer,
                             bernoulli_drops)
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime import (ControlPlane, PolicyStepCache, StepTelemetry,
                                 SyncPolicy)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.train.trainer import TrainConfig, build_train_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--dp", type=int, default=None,
                    help="number of data-parallel peers (default 4): all "
                         "of them on one card as stacked tensors, or, under "
                         "torchrun, the world size, one peer a rank")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun: the process group's backend "
                         "(default nccl on the card, gloo on the CPU)")
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
    ap.add_argument("--transport", default="lossy",
                    choices=("lossy", "inproc", "udp"),
                    help="stage-1 arrival masks: 'lossy' = the synthetic "
                         "drop model (core/drops.py); 'inproc'/'udp' really "
                         "exchange the shard bytes between host peers over "
                         "the wire backend (repro_torch/net) and mask by "
                         "what arrived — per-peer stage times, timeout "
                         "flags and received fractions feed the "
                         "ControlPlane")
    ap.add_argument("--wire-deadline", type=float, default=None,
                    help="receive deadline before the AdaptiveTimeout is "
                         "profiled (backend clock units)")
    ap.add_argument("--rendezvous", default=None,
                    help="with --transport=udp: coordinate the ring's peers "
                         "through the socket rendezvous (repro_torch/net/"
                         "rendezvous.py) — 'auto' starts an in-process "
                         "coordinator, host:port joins an external one; the "
                         "peers consume the live membership view (a rank "
                         "that leaves or dies is skipped, not waited on)")
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
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron sequence parallelism over the --tp ranks "
                         "(the prefix and tokens must split evenly)")
    ap.add_argument("--prefix", action="store_true",
                    help="frontend archs: each batch carries the config's "
                         "prefix_len precomputed patch / frame embeddings "
                         "(standard normal, from --seed and the step) "
                         "before the --seq-len tokens")
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


def prefix_embeds(cfg, args, step: int) -> np.ndarray:
    """``--prefix``: step ``step``'s (global batch, prefix_len,
    frontend_dim) fp32 frontend embeddings, standard normal from
    ``(--seed, step)``."""
    rng = np.random.default_rng((args.seed, step, 1))
    return rng.standard_normal(
        (args.global_batch, cfg.prefix_len, cfg.frontend_dim),
        dtype=np.float32)


# flags the one-rank-a-peer form refuses: each is a later slice of A18c
RANK_REFUSED = (
    ("--production-mesh", lambda a: a.production_mesh),
    ("--sync-mode vmap", lambda a: a.sync_mode == "vmap"),
    ("--recovery", lambda a: a.recovery != "none"),
    ("--transport", lambda a: a.transport != "lossy"),
    ("--adaptive", lambda a: a.adaptive))


def _rank_setup(args):
    """Under torchrun: check the flags, join the default process group
    (once a process) and return ``(group, device)``; ``(None, None)``
    otherwise."""
    if "WORLD_SIZE" not in os.environ:
        if args.dist_backend is not None:
            raise ValueError("--dist-backend needs torchrun (WORLD_SIZE "
                             "unset)")
        return None, None
    import torch
    import torch.distributed as dist
    world = int(os.environ["WORLD_SIZE"])
    for flag, refused in RANK_REFUSED:
        if refused(args):
            raise ValueError(
                f"{flag} over ranks is a later slice of ROADMAP A18c (over "
                "ranks the launcher runs replicated and --dp-mode fsdp, at "
                "tp 1 and, for the dense, MoE, SSM and frontend-prefix "
                "families, at --tp T, with --seq-parallel for the dense "
                "block; it refuses "
                + ", ".join(f for f, _ in RANK_REFUSED) + ")")
    if args.tp != 1:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        check_tp_ranks(cfg, seq_parallel=args.seq_parallel, tp=args.tp,
                       positions=args.seq_len + (
                           cfg.prefix_len if args.prefix and cfg.frontend
                           else 0))
    if world % args.tp or (args.dp is not None
                           and args.dp * args.tp != world):
        raise ValueError(f"--dp {args.dp} --tp {args.tp} under torchrun "
                         f"with a world of {world}: one peer a rank, the "
                         "world --dp x --tp")
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not "
                         f"--dist-backend {backend}")
    if dist.get_world_size() != world:
        raise ValueError(f"WORLD_SIZE {world} and the process group's "
                         f"{dist.get_world_size()} ranks differ")
    return dist.group.WORLD, device


def run(argv=None) -> list[dict]:
    """Parse ``argv``, train, and return one record per step run (loss,
    grad_norm, loss_frac, skipped, ``filled`` under ``--recovery``, step_s:
    host seconds to the step's last result). With a wire transport each
    record also has ``wire_loss_frac`` (the step's exchanges as the wire
    observed them, NaN when none was drained), ``wire_flush_s`` (host
    seconds the step's end waited for them), ``wire_misses`` (the bridge's
    misses so far) and ``wire_error`` (1 when the bridge worker failed since
    the last step). Under torchrun each rank returns its own records, with
    ``dist_bytes`` (bytes the rank sent through the process group in the
    step; ``dist_axis_bytes`` the same by axis: "data", "model", ...),
    ``dist_s`` (host seconds inside its calls: over gloo the whole
    wait, over NCCL the enqueue only) and, on the card,
    ``peak_bytes`` (``torch.cuda.max_memory_allocated`` so far); only rank
    0 prints."""
    ap = parser()
    args = ap.parse_args(argv)
    group, device = _rank_setup(args)
    if group is None:
        return _run(ap, args, None, None)
    import torch.distributed as dist
    with open(os.devnull, "w") as sink:
        with (contextlib.redirect_stdout(sink) if dist.get_rank(group)
              else contextlib.nullcontext()):
            return _run(ap, args, group, device)


def _run(ap, args, group, device) -> list[dict]:
    ranks = rank = None
    if group is not None:
        import torch.distributed as dist
        ranks, rank = dist.get_world_size(group), dist.get_rank(group)
        leader = rank == 0
    else:
        leader = True
    dp = ranks // args.tp if ranks else (4 if args.dp is None else args.dp)
    mesh = (make_production_mesh() if args.production_mesh
            else make_host_mesh(dp=dp, tp=args.tp))
    tp = mesh.shape.get("model", 1)
    n_data = mesh.shape.get("data", 1)
    if args.transport != "lossy":
        if args.dp_mode != "replicated":
            ap.error("--transport needs --dp-mode=replicated (fsdp grads "
                     "reduce through rs_spec, which has no wire bridge)")
        if args.sync_mode == "vmap":
            ap.error("--transport bridges per-bucket io_callbacks; vmap "
                     "would batch them (use --sync-mode pipelined or scan)")
        if args.recovery in ("ef", "ef+budget"):
            ap.error("--recovery=ef/ef+budget reconstructs sender-arrival "
                     "masks from the synthetic drop model; with wire "
                     "transports use --recovery=stale")
        if tp != 1:
            ap.error("--transport needs --tp=1: with model parallelism "
                     "every tp sibling of a data rank would run the "
                     "io_callback, advancing the ring's per-rank exchange "
                     "counter tp times per bucket and pairing deposits "
                     "from different buckets into one wire exchange")
        if args.rendezvous and args.transport != "udp":
            ap.error("--rendezvous coordinates real socket peers; it needs "
                     "--transport=udp")
    if device is None:
        device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.prefix and not cfg.frontend:
        ap.error(f"--prefix needs a frontend arch; {cfg.name} has none")
    print(f"arch={cfg.name} mesh={mesh.shape} device={device} "
          f"strategy={args.strategy} drop_rate={args.drop_rate} "
          f"transport={args.transport}"
          + ("" if group is None else
             f" ranks={ranks} dist_backend={dist.get_backend(group)}"),
          flush=True)

    tracer = None
    if args.trace is not None:
        tracer = obs.configure(
            True, capacity=args.trace_capacity or obs.trace.DEFAULT_CAPACITY)
    control = None
    with_budget = args.recovery == "ef+budget"
    wire = args.transport != "lossy"
    if args.adaptive or args.report or with_budget or wire:
        control = ControlPlane.create(n_nodes=n_data,
                                      rebalance=args.rebalance,
                                      **({"budget": {}} if with_budget
                                         else {}))
    # host wire transport (DESIGN §7): a HostRing of per-rank peers really
    # exchanges the stage-1 shard bytes (in-memory loopback or localhost
    # UDP); --drop-rate becomes injected *wire* loss instead of the
    # synthetic mask model, and the ring's telemetry feeds the ControlPlane
    # per-peer stage times
    ring = rdv_server = None
    rdv_clients = []
    if wire:
        ring, rdv_server, rdv_clients = _wire_ring(args, n_data, control,
                                                   device)
    try:
        tc = TrainConfig(
            sync=OptiReduceConfig(strategy=args.strategy,
                                  # wire mode: drops are observed on the wire
                                  drop_rate=0.0 if wire else args.drop_rate,
                                  drop_pattern=args.drop_pattern,
                                  incast=args.incast, recovery=args.recovery,
                                  hadamard_block=1024),
            optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr),
            dp_mode=args.dp_mode, microbatch=args.microbatch,
            sync_mode=args.sync_mode, seq_parallel=args.seq_parallel,
            transport_override=(WireTransport(ring.bridge_exchange)
                                if wire else None),
            kernel_mode=args.kernel_mode, seq_chunk=min(512, args.seq_len))
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq_len,
                                      global_batch=args.global_batch,
                                      seed=args.seed))
        key = make_key(args.seed)
        # over ranks under FSDP or tp: this rank's piece of each leaf (its
        # FSDP shard, its tp chunk, or under FSDP x TP the shard of its tp
        # chunk), cut from the full leaf as it is drawn
        sharded = group is not None and (args.dp_mode == "fsdp" or tp > 1)
        cuts = (elastic.rank_cuts(cfg, ranks=ranks, rank=rank, tp=tp,
                                  fsdp=args.dp_mode == "fsdp")
                if sharded else None)
        params = init_params(key, cfg, device=device, tp=tp, keep=(
            (lambda i, w: elastic.cut_piece(w, cuts[i])) if sharded
            else None))
        step_fn, opt = build_train_step(cfg, tc, mesh, device=device,
                                        group=group)
        opt_state = opt.init(params)
        if sharded:
            cuts = cuts + elastic.state_dims(
                cfg, opt_state, opt.state_like_params, dims=cuts)
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
        ckpt = (ckpt_lib.AsyncCheckpointer(args.ckpt_dir)
                if args.ckpt_dir and leader else None)

        def save(label: int) -> None:
            tree = ckpt_tree()
            if sharded:       # every rank joins each leaf's gathers
                tree = elastic.gather_cut_tree(
                    tree, cuts, collectives.rank_grid(group, tp=tp),
                    keep=ckpt is not None)
            if ckpt is not None:
                ckpt.save(label, tree)

        if args.resume and args.ckpt_dir:
            try:
                start_step, restored, _ = ckpt_lib.restore(
                    args.ckpt_dir, ckpt_tree(),
                    device="cpu" if sharded else device)
                if sharded:   # this rank's piece of each full leaf
                    restored = elastic.cut_tree(restored, cuts, device)
                if rec_state is None:
                    params, opt_state = restored
                else:
                    params, opt_state, rec_state = restored
                print(f"resumed from step {start_step}", flush=True)
            except FileNotFoundError:
                pass

        if args.adaptive:
            # start from the configured codec so step 0 never rebuilds, and
            # learn which knobs this spec can observe, by the reference's
            # rules: incast only lowers rounds schedules; use_hadamard
            # matters when toggling it resolves to another spec object
            # (every factory-registered name); degraded participation needs
            # a mask-capable or reschedulable topology, weights and dead
            # links a resizable one
            control.use_hadamard = tc.sync.use_hadamard
            topo = resolve_spec(tc.sync).topology
            rounds = (isinstance(topo, TarTopology)
                      and topo.schedule == "rounds")
            true_ring = (isinstance(topo, RingTopology)
                         and topo.kind == "ring")
            incast_matters = rounds
            ht_matters = (resolve_spec(dataclasses.replace(
                tc.sync, use_hadamard=True)) is not resolve_spec(
                    dataclasses.replace(tc.sync, use_hadamard=False)))
            # degraded rounds schedules exchange over a virtual ring the wire
            # bridge does not model (WireTransport raises): over a wire they
            # hold full participation while the detector keeps observing
            participation_matters = ((isinstance(topo, TarTopology)
                                      and not (wire and rounds)) or true_ring)
            # weighted shards and dead-link rewiring need a resizable schedule
            # and the synthetic transport (the bridge's geometry is fixed)
            rebalance_matters = (args.rebalance and (rounds or true_ring)
                                 and not wire)
            deadlink_matters = (rounds or true_ring) and not wire
            step_cache = PolicyStepCache(maxsize=max(1, args.policy_cache))
            step_cache.put(_policy_of(tc.sync), step_fn)
            stable_rec, stable_for = None, 0

        monitor = LossMonitor(skip_threshold=tc.sync.skip_threshold)
        records, report_rows = [], []
        t0 = time.perf_counter()
        for step in range(start_step, args.steps):
            batch = data.host_batch(step, 0, 1)
            if args.prefix:
                batch["prefix_embeds"] = prefix_embeds(cfg, args, step)
            st0 = tracer.now() if tracer is not None else 0.0
            t_step = time.perf_counter()
            sent, held = collectives.dist_bytes, collectives.dist_s
            by_axis = dict(collectives.dist_axis_bytes)
            if rec_state is None:
                params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                     step, key)
            else:
                params, opt_state, rec_state, metrics = step_fn(
                    params, opt_state, batch, step, key, rec_state=rec_state)
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            m["step_s"] = time.perf_counter() - t_step
            if group is not None:
                m["dist_bytes"] = collectives.dist_bytes - sent
                m["dist_s"] = collectives.dist_s - held
                m["dist_axis_bytes"] = {
                    a: v - by_axis.get(a, 0)
                    for a, v in collectives.dist_axis_bytes.items()}
                if device.type == "cuda":
                    import torch
                    m["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            records.append(m)
            logged = step % args.log_every == 0 or step == args.steps - 1
            if with_budget:
                # the phase follows the run's progress and the loss curve; the
                # loss EMA is fed through control.observe below
                control.state.budget.update_phase(
                    progress=(step + 1) / max(args.steps, 1),
                    train_loss=m["loss"])
            if logged:
                rate = (step - start_step + 1) / (time.perf_counter() - t0)
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} "
                      f"loss_frac {m['loss_frac']:.5f} "
                      f"skipped {int(m['skipped'])} ({rate:.2f} it/s)",
                      flush=True)
            wire_t = None
            if ring is not None:
                wire_t = _wire_step_end(ring, args.transport, step, m)
            if control is not None:
                if wire_t is not None:
                    # per-peer stage times, per-round deadlines, timeouts and
                    # received fractions, observed on the wire
                    control.observe(wire_t)
                    if logged:
                        pst = ", ".join(f"{t:.3g}" for t
                                        in (wire_t.peer_stage_times or ()))
                        print(f"wire[{args.transport}] peers="
                              f"{len(wire_t.peer_stage_times or ())} "
                              f"stage_times=[{pst}] "
                              f"loss_frac={wire_t.loss_frac:.5f} "
                              f"deadline={ring.peers[0].round_deadline():.4g}"
                              + (f" misses={ring.bridge_misses}"
                                 if ring.bridge_misses else ""), flush=True)
                elif ring is None:
                    # wall-clock only for the synthetic transport: a wire-fed
                    # AdaptiveTimeout is profiled in the backend's clock units
                    control.observe(StepTelemetry(step=step,
                                                  loss_frac=m["loss_frac"],
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
                        "dead_link_events": [
                            list(link) for link in
                            ((wire_t.dead_link_events or ())
                             if wire_t is not None else ())]})
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
                    new_sync = dataclasses.replace(new_sync,
                                                   shard_weights=None)
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
            if args.ckpt_dir and step > 0 and step % args.ckpt_every == 0:
                save(step)
        if args.ckpt_dir:
            save(args.steps)
        if ckpt:
            ckpt.wait()
    finally:
        if ring is not None:
            ring.close()          # UDP sockets + the bridge worker
        for c in rdv_clients:
            c.leave()
        if rdv_server is not None:
            rdv_server.close()
    if args.report and leader:
        with open(args.report, "w") as f:
            json.dump({"n_peers": control.detector.n_peers,
                       "rebalance": bool(args.rebalance),
                       "steps": report_rows}, f, indent=1)
        print(f"report: {len(report_rows)} steps -> {args.report}",
              flush=True)
    if tracer is not None and not leader:
        obs.configure(False)
    elif tracer is not None:
        path = obs.export.write_trace(args.trace, tracer,
                                      meta={"transport": args.transport,
                                            "strategy": args.strategy})
        print(f"trace: {len(tracer)} records ({tracer.dropped} dropped) "
              f"-> {path}", flush=True)
        obs.configure(False)
    print("done", flush=True)
    return records


def _wire_ring(args, n_data: int, control: ControlPlane, device):
    """The launcher's HostRing (and its rendezvous server and clients under
    ``--rendezvous``): the reference's, its peers on ``device``."""
    membership = rdv_server = None
    rdv_clients = []
    if args.rendezvous:
        if args.rendezvous == "auto":
            rdv_server = RendezvousServer(n_data)
            rdv_addr = rdv_server.addr
        else:
            host, _, port = args.rendezvous.rpartition(":")
            rdv_addr = (host or "127.0.0.1", int(port))
        # one client per ring peer; joins are sequential so rank i is peer
        # i, and every client heartbeats — the shared membership view is
        # live, not a snapshot
        for uid in range(n_data):
            c = RendezvousClient(rdv_addr, uid=uid)
            c.join()
            rdv_clients.append(c)
        membership = rdv_clients[0]
        print(f"rendezvous: {n_data} peers joined at "
              f"{rdv_addr[0]}:{rdv_addr[1]} "
              f"generation={membership.generation}", flush=True)
    ring = HostRing(
        n_data,
        OptiReduceConfig(strategy=args.strategy, incast=args.incast,
                         hadamard_block=1024),
        backend=args.transport, timeout=control.state.timeout,
        default_deadline=args.wire_deadline, budget=control.state.budget,
        drop_fn=(bernoulli_drops(args.drop_rate, seed=args.seed)
                 if args.drop_rate > 0 else None),
        membership=membership, device=device)
    return ring, rdv_server, rdv_clients


def _wire_step_end(ring: HostRing, transport: str, step: int,
                   m: dict) -> StepTelemetry | None:
    """Let the step's exchanges land, surface a failed bridge worker, and
    drain the step's wire telemetry; records the wire fields in ``m``."""
    t0 = time.perf_counter()
    if not ring.flush():
        print(f"wire[{transport}] WARNING: exchanges still in flight at "
              f"step {step} (flush timed out)", flush=True)
    m["wire_flush_s"] = time.perf_counter() - t0
    m["wire_error"] = float(ring.bridge_error is not None)
    if ring.bridge_error is not None:
        # a wedged or dead wire layer must be loud, not silently degrade
        # to all-ones masks
        print(f"wire[{transport}] ERROR: bridge worker died: "
              f"{ring.bridge_error!r} — masks degrade to all-ones and "
              "telemetry stops", flush=True)
        ring.bridge_error = None
    wire_t = ring.drain_telemetry(step)
    m["wire_loss_frac"] = (wire_t.loss_frac if wire_t is not None
                           else math.nan)
    m["wire_misses"] = float(ring.bridge_misses)
    return wire_t


def _policy_of(sync: OptiReduceConfig) -> SyncPolicy:
    return SyncPolicy(use_hadamard=sync.use_hadamard, incast=sync.incast,
                      active_peers=sync.active_peers,
                      shard_weights=sync.shard_weights,
                      dead_links=sync.dead_links)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
