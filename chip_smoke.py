"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:

1. the card (``nvidia-smi`` name and power limit, also printed raw);
2. the build of every CUDA kernel of ``src/repro_torch`` (one ``nvcc`` per
   source, all at once), with the ptxas register report;
3. kernel B1 (FWHT) against its plain PyTorch version at the main path's
   shape (25,600 x 1024) and at (6,400 x 4096), sign modes none/pre/post:
   max abs error, kernel / plain / library (fp32 matmul with H) ms;
4. kernel B2 (drop-compensated mean) against its plain version at
   (4, 4, 1,638,400), some columns dropped by every peer, on the strided
   all_to_all view the main path hands it;
5. the main path: ``repro_torch.launch.train`` on gpt2-paper at full width
   (151,862,784 params, 24 buckets of 6,553,600), 4 peers, optireduce,
   drop rate 0.01 tail, seq 128, global batch 8, adamw — per-step loss,
   loss_frac, step ms, peak memory, and the kernels' launch counts, which
   must be 48 (B1) and 24 (B2) per step;
6. the same trainer on gpt2-smoke, 2 steps on the card against 2 steps of
   the plain versions on the CPU from the same parameters and draws;
7. one more main-path step under ``torch.profiler``: wall time, device busy
   time and idle share, and the largest device and host entries.

Then the ``{"kernels": [...]}`` line, and last the device line. Any error,
disagreement past the stated tolerance or missing launch exits non-zero.
Without CUDA, or without the repository around it, it prints no result and
exits 1.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
FWHT_TOL = 1e-5      # fp32: log2(n) adds of unit-scale values, same order
MEAN_TOL = 2e-6      # fp32: <= 4 products summed, order may differ
STEP_TOL = 2e-3      # whole-step card vs CPU: bf16-free smoke model, fp32
                     # sums in other orders through 2 AdamW steps


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs the GPU")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not beside this script: {e}")
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.masked_sum import ops as mm_ops
    from repro_torch.kernels.masked_sum import ref as mm_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0))})

    # 2. build every kernel, in parallel
    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(logs), "ptxas": ptxas})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = []

    # 3. B1, FWHT
    b1 = None
    for rows, n in ((25_600, 1024), (6_400, 4096)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        sign = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5,
                           1.0, -1.0)
        h = fwht_ref.hadamard_matrix(n, device=dev)
        for mode in ("none", "pre", "post"):
            got = fwht_ops.fwht_launch(x, sign, mode)
            if mode == "none":
                def plain():
                    return fwht_ref.fwht_ref(x)
            else:
                rmode = "encode" if mode == "pre" else "decode"

                def plain():
                    return fwht_ref.randomized_fwht_ref(x, sign, mode=rmode)
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not math.isfinite(err) or err > FWHT_TOL:
                fail(f"fwht {rows}x{n} {mode}: max abs err {err} > "
                     f"{FWHT_TOL}")
            ms = time_ms(lambda: fwht_ops.fwht_launch(x, sign, mode))
            plain_ms = time_ms(plain, reps=5)
            if mode == "pre":
                lib_ms = time_ms(lambda: torch.matmul(x * sign, h), reps=5)
            else:
                lib_ms = time_ms(lambda: torch.matmul(x, h), reps=5)
            b_ms, b_by = bound(fwht_ref.fwht_bytes(rows, n),
                               fwht_ref.fwht_flops(rows, n))
            row = {"phase": "fwht", "rows": rows, "n": n, "mode": mode,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            if (rows, n, mode) == (25_600, 1024, "pre"):
                b1 = row
        del x, h

    # 4. B2, drop-compensated mean on the all_to_all view
    r = nn = 4
    length = 1_638_400
    data = torch.randn((r, nn * length), generator=gen, device=dev)
    received = data.view(r, nn, length).transpose(0, 1)
    mask = (torch.rand((r, nn, length), generator=gen, device=dev)
            < 0.99).to(torch.float32)
    mask[:, :, 1000:1300] = 0.0          # columns no peer delivered
    got = mm_ops.masked_mean_launch(received, mask)
    want = mm_ref.masked_mean_ref(received, mask)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not math.isfinite(err) or err > MEAN_TOL:
        fail(f"masked_mean: max abs err {err} > {MEAN_TOL}")
    if bool((got[:, 1000:1300] != 0).any()):
        fail("masked_mean: an all-dropped column is not exactly 0")
    b2_ms = time_ms(lambda: mm_ops.masked_mean_launch(received, mask))
    b2_plain = time_ms(lambda: mm_ref.masked_mean_ref(received, mask), reps=5)
    b_ms, b_by = bound(mm_ref.masked_mean_bytes(r, nn, length),
                       mm_ref.masked_mean_flops(r, nn, length))
    b2 = {"phase": "masked_mean", "shape": [r, nn, length],
          "max_abs_err": err, "ms": b2_ms, "plain_ms": b2_plain,
          "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit(b2)
    del data, received, mask, got, want

    # 5. the main path, through the launcher
    from repro_torch.launch import train as launch_train
    steps = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwht_ops.launches = 0
    mm_ops.launches = 0
    records = launch_train.run([
        "--arch", "gpt2-paper", "--steps", str(steps), "--dp", "4",
        "--drop-rate", "0.01", "--drop-pattern", "tail", "--seq-len", "128",
        "--global-batch", "8", "--optimizer", "adamw", "--device", "cuda",
        "--kernel-mode", "kernel", "--log-every", "1"])
    torch.cuda.synchronize()
    n_fwht, n_mm = fwht_ops.launches, mm_ops.launches
    peak = torch.cuda.max_memory_allocated()
    for i, rec in enumerate(records):
        emit({"phase": "train_step", "step": i, "loss": rec["loss"],
              "loss_frac": rec["loss_frac"], "grad_norm": rec["grad_norm"],
              "step_ms": rec["step_s"] * 1e3})
        if not (math.isfinite(rec["loss"]) and rec["loss_frac"] > 0):
            fail(f"step {i}: loss {rec['loss']} loss_frac "
                 f"{rec['loss_frac']}")
    emit({"phase": "train", "arch": "gpt2-paper", "peers": 4,
          "steps": steps, "peak_mem_bytes": peak,
          "fwht_launches": n_fwht, "masked_mean_launches": n_mm,
          "fwht_per_step": n_fwht / steps,
          "masked_mean_per_step": n_mm / steps})
    if n_fwht != 48 * steps or n_mm != 24 * steps:
        fail(f"launch counts {n_fwht} fwht / {n_mm} masked_mean over "
             f"{steps} steps, expected {48 * steps} / {24 * steps}")

    # 6. the same trainer on the card and on the CPU, same params and draws
    check_step_against_cpu(dev)

    # 7. where one main-path step's time goes
    profile_step(dev)

    kernels.append({
        "name": "fwht", "route": "cuda",
        "source": "src/repro_torch/kernels/fwht/csrc/fwht.cu",
        "replaces": "src/repro/kernels/fwht/fwht.py:130",
        "launches": n_fwht, "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"]})
    kernels.append({
        "name": "masked_mean", "route": "cuda",
        "source": "src/repro_torch/kernels/masked_sum/csrc/masked_mean.cu",
        "replaces": "src/repro/kernels/masked_sum/masked_sum.py:68",
        "launches": n_mm, "max_abs_err": b2["max_abs_err"],
        "ms": b2["ms"], "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
        "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


class _HostDraws:
    """The CPU generators' draws, served on any device: both runs of the
    comparison see the same signs and masks."""

    def __init__(self, inner, device):
        self.inner, self.device = inner, device

    def sign(self, bucket, block):
        return self.inner.sign(bucket, block).to(self.device)

    def mask(self, bucket, receiver, n, s):
        return self.inner.mask(bucket, receiver, n, s).to(self.device)


def check_step_against_cpu(dev) -> None:
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, generator, key
    from repro_torch.core.pipeline import GeneratorDraws
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_leaves, tree_map

    runtime.set_kernel_mode(None)       # by device: card kernels, CPU plain
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(drop_rate=0.05, drop_pattern="bernoulli",
                            hadamard_block=256)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=1e-2),
                     bucket_elems=16_384, seq_chunk=32)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    base = init_params(generator(k), cfg, device="cpu")
    runs = {}
    for device in ("cpu", dev):
        params = tree_map(lambda p: p.clone().to(device), base)
        step_fn, opt = build_train_step(cfg, tc, peers=4, device=device)
        state = opt.init(params)
        metrics = []
        for step in range(2):
            draws = _HostDraws(GeneratorDraws(
                key=fold_in(fold_in(k, step), 7), cfg=sync,
                device=torch.device("cpu")), device)
            params, state, m = step_fn(params, state,
                                       data.host_batch(step, 0, 1), step, k,
                                       draws=draws)
            metrics.append({n: float(v) for n, v in m.items()})
        runs[str(torch.device(device).type)] = (params, metrics)
    (p_cpu, m_cpu), (p_gpu, m_gpu) = runs["cpu"], runs["cuda"]
    worst = max(abs(a[n] - b[n]) for a, b in zip(m_cpu, m_gpu) for n in a)
    p_err = max(float((a.detach() - b.detach().cpu()).abs().max())
                for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)))
    emit({"phase": "reference_check", "arch": cfg.name, "steps": 2,
          "metrics_max_abs_diff": worst, "params_max_abs_diff": p_err,
          "tolerance": STEP_TOL, "cpu": m_cpu, "gpu": m_gpu})
    if not (worst <= STEP_TOL and p_err <= STEP_TOL):
        fail(f"card vs CPU step: metrics {worst}, params {p_err} > "
             f"{STEP_TOL}")


def profile_step(dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import generator, key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train.trainer import TrainConfig, build_train_step

    cfg = get_config("gpt2-paper")
    sync = OptiReduceConfig(drop_rate=0.01, drop_pattern="tail",
                            hadamard_block=1024)
    tc = TrainConfig(sync=sync, seq_chunk=128)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    k = key(0)
    params = init_params(generator(k, dev), cfg, device=dev)
    step_fn, opt = build_train_step(cfg, tc, peers=4, device=dev)
    state = opt.init(params)
    batches = [data.host_batch(s, 0, 1) for s in range(3)]
    wall = []
    for s in range(2):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[s], s, k)
        float(m["loss"])
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[2], 2, k)
        float(m["loss"])
        prof_wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()

    def dev_us(r):
        return getattr(r, "self_device_time_total",
                       getattr(r, "self_cuda_time_total", 0.0))
    # device-side rows only (kernels, copies, sets): the host op rows
    # above them report the same device time again
    on_dev = [r for r in rows if str(r.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(r) for r in on_dev) / 1e3
    top_dev = sorted(on_dev, key=dev_us, reverse=True)[:12]
    host = [r for r in rows if not str(r.device_type).endswith("CUDA")]
    top_cpu = sorted(host, key=lambda r: r.self_cpu_time_total,
                     reverse=True)[:12]
    launches = sum(r.count for r in host
                   if r.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    emit({"phase": "profile", "arch": cfg.name, "peers": 4,
          "step_ms_unprofiled": wall[-1], "step_ms_profiled": prof_wall,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "device_idle_share": (1 - busy_ms / prof_wall) if busy_ms > 0
          else "not measured",
          "kernel_launches": launches,
          "top_device": [{"name": r.key[:90], "ms": dev_us(r) / 1e3,
                          "count": r.count} for r in top_dev],
          "top_host": [{"name": r.key[:90],
                        "ms": r.self_cpu_time_total / 1e3,
                        "count": r.count} for r in top_cpu]})


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
