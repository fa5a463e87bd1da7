"""Training launcher of the port: OptiReduce-synced data-parallel training
with the P peers on one card.

Counterpart of ``src/repro/launch/train.py``. It takes the reference's
flags; the values this slice does not run (wire transports, the adaptive
control plane, checkpoints, tracing, tensor parallelism, FSDP, ...) raise,
naming their ROADMAP item. ``--dp`` is the number of peers simulated on the
card, ``--device`` where they run (the CUDA device unless asked otherwise).
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
"""
from __future__ import annotations

import argparse
import sys
import time


from repro_torch.configs import get_config, get_smoke
from repro_torch.core.allreduce import OptiReduceConfig, strategy_names
from repro_torch.core.keys import generator, key as make_key
from repro_torch.core.safeguards import LossMonitor
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.runtime import MODES as KERNEL_MODES
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import init_params
from repro_torch.optim.optimizers import OptimizerConfig
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
    ap.add_argument("--recovery", default="none")
    ap.add_argument("--transport", default="lossy")
    ap.add_argument("--wire-deadline", type=float, default=None)
    ap.add_argument("--rendezvous", default=None)
    ap.add_argument("--incast", type=int, default=1)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--rebalance", action="store_true")
    ap.add_argument("--report", default=None)
    ap.add_argument("--trace", nargs="?", const=".", default=None)
    ap.add_argument("--trace-capacity", type=int, default=None)
    ap.add_argument("--policy-cache", type=int, default=4)
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


# flags of the reference whose non-default values wait for later slices
_NOT_PORTED = (
    ("transport", "lossy", "--transport inproc|udp (wire): ROADMAP A18"),
    ("wire_deadline", None, "--wire-deadline: ROADMAP A18"),
    ("rendezvous", None, "--rendezvous: ROADMAP A18"),
    ("recovery", "none", "--recovery: ROADMAP A16"),
    ("adaptive", False, "--adaptive (control plane): ROADMAP A17"),
    ("rebalance", False, "--rebalance (the control plane): ROADMAP A17"),
    ("report", None, "--report: ROADMAP A17"),
    ("trace", None, "--trace: ROADMAP A19"),
    ("trace_capacity", None, "--trace-capacity: ROADMAP A19"),
    ("tp", 1, "--tp > 1 (tensor parallelism): ROADMAP A15"),
    ("production_mesh", False, "--production-mesh: ROADMAP A15"),
    ("dp_mode", "replicated", "--dp-mode fsdp: ROADMAP A15"),
    ("ckpt_dir", None, "--ckpt-dir (checkpoints): ROADMAP A12"),
    ("resume", False, "--resume (checkpoints): ROADMAP A12"),
)


def run(argv=None) -> list[dict]:
    """Parse ``argv``, train, and return one record per step (loss,
    grad_norm, loss_frac, skipped, step_s: host seconds to the step's last
    result)."""
    ap = parser()
    args = ap.parse_args(argv)
    for name, default, what in _NOT_PORTED:
        if getattr(args, name) != default:
            raise NotImplementedError(f"not ported yet: {what}")
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} peers={args.dp} device={device} "
          f"strategy={args.strategy} drop_rate={args.drop_rate}", flush=True)

    tc = TrainConfig(
        sync=OptiReduceConfig(strategy=args.strategy,
                              drop_rate=args.drop_rate,
                              drop_pattern=args.drop_pattern,
                              incast=args.incast, hadamard_block=1024),
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr),
        microbatch=args.microbatch, sync_mode=args.sync_mode,
        kernel_mode=args.kernel_mode, seq_chunk=min(512, args.seq_len))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  seed=args.seed))
    key = make_key(args.seed)
    params = init_params(generator(key, device), cfg, device=device)
    step_fn, opt = build_train_step(cfg, tc, peers=args.dp, device=device)
    opt_state = opt.init(params)

    monitor = LossMonitor(skip_threshold=tc.sync.skip_threshold)
    records = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = data.host_batch(step, 0, 1)
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch, step,
                                             key)
        m = {k: float(v) for k, v in metrics.items()}  # waits for the step
        m["step_s"] = time.perf_counter() - t_step
        records.append(m)
        if step % args.log_every == 0 or step == args.steps - 1:
            rate = (step + 1) / (time.perf_counter() - t0)
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} "
                  f"loss_frac {m['loss_frac']:.5f} "
                  f"skipped {int(m['skipped'])} ({rate:.2f} it/s)",
                  flush=True)
        monitor.observe(step, m["loss_frac"], m["skipped"] > 0)
        if monitor.halted:
            print("HALT: excessive gradient loss (§3.4); rolling back")
            rb = monitor.rollback()
            if rb is not None:
                _, params = rb
    print("done", flush=True)
    return records


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
