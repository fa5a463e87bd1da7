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
5. the quantized exchange's kernels against their plain versions at the
   shapes ``optireduce_q`` gives them (blocks of 1024, 6,400 a peer, shards
   of 1,600 blocks, one shared copy of the sign, noises and grids): B3
   (rotate + amax) and B4 (rotate + quantize) on a strided (4, 6,400,
   1024) arena slice, B5 (dequant + mean) with and without a mask on the
   all_to_all view of (4, 4, 1,638,400) codes, B6 (grid quantize) on
   (6,400, 1024) — B3, B4 and B6 must be equal, B5 within 8 ulp of amax;
   then B3 and B4 at blocks of 1024, 2048 and 4096 with 1 or 4 peers of one
   bucket each (phases ``ht_amax_sweep``, ``ht_quant_sweep``): bitwise,
   timed, with the bound, its share and the registers a thread;
6. the main path: ``repro_torch.launch.train`` on gpt2-paper at full width
   (151,862,784 params, 24 buckets of 6,553,600), 4 peers, optireduce,
   drop rate 0.01 tail, seq 128, global batch 8, adamw — per-step loss,
   loss_frac, step ms, peak memory, and the kernels' launch counts, which
   must be 48 (B1) and 24 (B2) per step;
7. the same run with ``--strategy optireduce_q`` (8-bit codes): 24
   launches a step of each of B1 (decode only), B3, B4, B5 and B6, none of
   B2;
8. the same trainer on gpt2-smoke, 2 steps on the card against 2 steps of
   the plain versions on the CPU from the same parameters and draws, for
   optireduce and for optireduce_q (noise included);
9. one more step of each main path under ``torch.profiler``: wall time,
   device busy time and idle share, the largest device and host entries,
   and each of the port's kernels' device time;
10. kernel B7 (THC's quantizer onto one shared range) against its plain
    version at the THC path's full-width shape: x (8, 148,304, 1024), one
    shared (148,304, 1024) noise copy, the range formed from the data as
    the harness forms it, bits 4 and 8 — codes bitwise equal, a NaN giving
    code 0;
11. the THC path: ``repro_torch.sim.tta.run_training`` with the THC
    compressor, 8 workers, seq 64, 3 steps on gpt2-paper at full width,
    kernels required — per-step accuracy, replica divergence (exactly 0)
    and step ms, peak memory, and the launch counts, which must be 1 (B7)
    and 2 (B1) a step and none of B2-B6; then its third step of a new run
    under ``torch.profiler``, as in 9.;
12. the harness's other paths on gpt2-smoke, 2 steps each: Top-K,
    TernGrad, tail drops at 0.01 (divergence > 0) and the same with error
    feedback — every accuracy finite;
13. 2 THC steps of the harness on gpt2-smoke on the card against the CPU,
    same parameters and draws: the codes that differ counted, accuracy
    within one eval token a differing code, parameters within what those
    codes move through momentum SGD;
14. ``rounds_main``: the launcher again, ``--strategy optireduce_rounds
    --incast 2`` (the paper's round schedule), as in 6.: 48 B1 and 24 B2
    launches and 144 peer-axis permutes (24 buckets x 2 (4 - 1)) a step,
    96 incast groups, none of B3-B7;
15. ``strategies``: one full-width arena (4, 24, 6,553,600) fp32 with
    distinct peers through ``sync_packed(mode="pipelined")`` for every
    ported strategy (psum, gloo_ring, nccl_tree, bcube, tar_tcp,
    tar_rounds, optireduce, optireduce_q, optireduce_rounds, tar_rounds_q,
    ring_ht): at drop 0 against the fp64 peer mean (fp32 sums, the
    rotation's rounding, or the quantizers' grid-step bound), at drop 0.01
    (the lossy ones) every peer's row bitwise equal; device ms (CUDA
    events), launches per kernel and permutes of each;
16. ``policies``: the same arena with peer 2 ejected (``active_peers=(0, 1,
    3)``) on optireduce, optireduce_rounds, tar_rounds_q, ring_ht and
    gloo_ring (every row bitwise equal, the mean over the active peers
    within tolerance); ``shard_weights=(2, 2, 2, 1)`` at drop 0 on
    tar_rounds and optireduce_rounds (bitwise the uniform result) and
    gloo_ring (within the fp32 sum bound: its chunks add in another order
    once re-cut); ``dead_links=((1, 2),)`` on optireduce_rounds at drop
    0.01 (bitwise the run without it, 6 + 4 permutes a bucket);
17. ``rounds_cpu``: 8.'s comparison for optireduce_rounds and tar_rounds_q;
    and 9.'s profile for optireduce_rounds, with the permutes and the device
    ms of the index kernels (the permutes' gathers and indexed writes).

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
DEQ_ULPS = 8         # B5: <= 4 dequantized values summed, order may differ:
                     # within 8 ulp (2^-23) of the largest |value| (amax)
STEP_TOL = 2e-3      # whole-step card vs CPU: bf16-free smoke model, fp32
                     # sums in other orders through 2 AdamW steps
PEERS = 4
BLOCK = 1024                     # hadamard_block as the launcher sets it
BUCKET = 6_553_600
PEER_BLOCKS = BUCKET // BLOCK    # 6,400 blocks a peer
SHARD = BUCKET // PEERS          # 1,638,400 = 1,600 blocks a shard
ROUNDS_INCAST = 2                # the round schedule's I (a2a ignores it)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


HOLD_CYCLES = 40_000_000   # ~20 ms of spinning at the H100's ~2 GHz


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, timed with CUDA events.
    A spin kernel holds the stream while the calls are queued, so they run
    back to back: a wrapper's host time (tens of us a launch) does not count
    as kernel time unless queueing them all takes longer than the spin."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
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
    from repro_torch.kernels.dequant_reduce import ops as dq_ops
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.ht_quant import ops as hq_ops
    from repro_torch.kernels.masked_sum import ops as mm_ops
    from repro_torch.kernels.masked_sum import ref as mm_ref
    from repro_torch.kernels import runtime
    from repro_torch.kernels.quant import ops as gq_ops
    from repro_torch.core import collectives, tar

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
    regs = {}
    for name, log in logs.items():
        regs.update(build.registers(log or build.ptxas_log(name)))
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

    # 5. B3-B6, the quantized exchange's kernels
    quant = check_quant_kernels(dev, gen, regs)
    sweep_ht_kernels(dev, gen, regs)

    # 6., 7., 14. the main paths, through the launcher; each counts its own
    # kernel launches and peer-axis permutes
    counters = {"fwht": (fwht_ops, "launches"),
                "masked_mean": (mm_ops, "launches"),
                "ht_amax": (hq_ops, "amax_launches"),
                "ht_quant": (hq_ops, "quant_launches"),
                "dequant_mean": (dq_ops, "launches"),
                "grid_quant": (gq_ops, "launches"),
                "uniform_quant": (gq_ops, "uniform_launches"),
                "permutes": (collectives, "permutes")}
    none = {k: 0 for k in counters}
    per_step = {
        "optireduce": {**none, "fwht": 48, "masked_mean": 24},
        "optireduce_q": {**none, "fwht": 24, "ht_amax": 24, "ht_quant": 24,
                         "dequant_mean": 24, "grid_quant": 24},
        # the paper's round schedule: 2 (4 - 1) permutes a bucket
        "optireduce_rounds": {**none, "fwht": 48, "masked_mean": 24,
                              "permutes": 24 * 2 * (PEERS - 1)}}
    steps = {"optireduce": 4, "optireduce_q": 4, "optireduce_rounds": 4}
    launches = {}
    for strategy, want_counts in per_step.items():
        groups = tar.round_groups
        launches[strategy] = train_main_path(strategy, steps[strategy],
                                             counters)
        want_counts = {k: v * steps[strategy] for k, v in want_counts.items()}
        if launches[strategy] != want_counts:
            fail(f"{strategy}: launch counts {launches[strategy]} over "
                 f"{steps[strategy]} steps, expected {want_counts}")
        if strategy == "optireduce_rounds":
            # incast 2: ceil(3 / 2) = 2 round groups a stage
            groups = (tar.round_groups - groups) / steps[strategy]
            emit({"phase": "rounds_main", "incast": ROUNDS_INCAST,
                  "round_groups_per_step": groups,
                  "permutes_per_step": launches[strategy]["permutes"]
                  / steps[strategy]})
            if groups != 24 * 2 * 2:
                fail(f"optireduce_rounds: {groups} round groups a step, "
                     "expected 96")

    # 15., 16. every ported strategy, and the participation policies, on one
    # full-width arena
    sync_strategies(dev, counters)

    # 8., 17. the same trainer on the card and on the CPU, same params and
    # draws
    for strategy in ("optireduce", "optireduce_q", "optireduce_rounds",
                     "tar_rounds_q"):
        check_step_against_cpu(dev, strategy)

    # 9. where one step of each main path's time goes
    for strategy in ("optireduce", "optireduce_q", "optireduce_rounds"):
        profile_step(dev, strategy)

    # 10. B7, THC's quantizer, at the THC path's full-width shape
    b7 = check_uniform_quant(dev, gen)

    # 11. the THC path of the harness at full width; it counts its own
    runtime.set_kernel_mode("kernel")
    launches["thc"] = train_thc(counters)
    runtime.set_kernel_mode(None)
    thc_steps = 3
    want_counts = {k: 0 for k in counters}
    want_counts.update(fwht=2 * thc_steps, uniform_quant=thc_steps)
    if launches["thc"] != want_counts:
        fail(f"thc: launch counts {launches['thc']} over {thc_steps} "
             f"steps, expected {want_counts}")

    profile_thc(dev)

    # 12., 13. the harness's other paths; THC on the card against the CPU
    tta_paths(dev)
    check_thc_against_cpu(dev)

    kernels.append({
        "name": "fwht", "route": "cuda",
        "source": "src/repro_torch/kernels/fwht/csrc/fwht.cu",
        "replaces": "src/repro/kernels/fwht/fwht.py:130",
        "launches": launches["optireduce"]["fwht"],
        "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"]})
    kernels.append({
        "name": "masked_mean", "route": "cuda",
        "source": "src/repro_torch/kernels/masked_sum/csrc/masked_mean.cu",
        "replaces": "src/repro/kernels/masked_sum/masked_sum.py:68",
        "launches": launches["optireduce"]["masked_mean"],
        "max_abs_err": b2["max_abs_err"],
        "ms": b2["ms"], "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
        "library_ms": None})
    for name, replaces, source in (
            ("ht_amax", "src/repro/kernels/ht_quant/ht_quant.py:123",
             "src/repro_torch/kernels/ht_quant/csrc/ht_quant.cu"),
            ("ht_quant", "src/repro/kernels/ht_quant/ht_quant.py:177",
             "src/repro_torch/kernels/ht_quant/csrc/ht_quant.cu"),
            ("dequant_mean",
             "src/repro/kernels/dequant_reduce/dequant_reduce.py:126",
             "src/repro_torch/kernels/dequant_reduce/csrc/dequant_mean.cu"),
            ("grid_quant", "src/repro/kernels/quant/quant.py:79",
             "src/repro_torch/kernels/quant/csrc/grid_quant.cu")):
        q = quant[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches["optireduce_q"][name],
            "max_abs_err": q["max_abs_err"], "ms": q["ms"],
            "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
            "bound_by": q["bound_by"], "library_ms": q["library_ms"]})
    kernels.append({
        "name": "uniform_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/quant/csrc/grid_quant.cu",
        "replaces": "src/repro/kernels/quant/quant.py:124",
        "launches": launches["thc"]["uniform_quant"],
        "max_abs_err": b7["max_abs_err"], "ms": b7["ms"],
        "plain_ms": b7["plain_ms"], "bound_ms": b7["bound_ms"],
        "bound_by": b7["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def ht_registers(regs: dict, n: int, quant: bool):
    """Registers a thread of B3's (quant False) or B4's instantiation for
    block length n, from the ptxas report."""
    key = f"ht_kernelILi{n.bit_length() - 1}ELb{int(quant)}E"
    hits = [r for entry, r in regs.items() if key in entry]
    return hits[0] if hits else "not measured"


HT_SWEEP_N = (1024, 2048, 4096)


def sweep_ht_kernels(dev, gen, regs: dict) -> None:
    """B3 and B4 at block lengths 1024, 2048 and 4096 and 1 or 4 peers, each
    peer holding one bucket (6,553,600 fp32) as 6,553,600 / n rows of a
    strided arena slice, with G = rows a peer: bitwise against the plain
    versions, then timed, with the bound, its share and the registers."""
    import torch
    from repro_torch.kernels.ht_quant import ops as hq_ops
    from repro_torch.kernels.ht_quant import ref as hq_ref

    for n in HT_SWEEP_N:
        per_peer = BUCKET // n
        sign = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5,
                           1.0, -1.0)
        noise = torch.rand((per_peer, n), generator=gen, device=dev)
        for peers in (1, PEERS):
            arena = torch.randn((peers, 2, BUCKET), generator=gen, device=dev)
            x = arena[:, 1].view(peers, per_peer, n)
            rows = peers * per_peer
            amax = hq_ops.ht_amax_launch(x, sign)
            shared = torch.clamp(amax.amax(0), min=1e-12)
            lo, step = -shared, 2.0 * shared / 255
            codes = hq_ops.ht_quant_launch(x, sign, noise, lo, step, bits=8)
            if not torch.equal(amax, hq_ref.ht_amax_ref(x, sign)):
                fail(f"ht_amax n={n} peers={peers}: differs from plain")
            mismatched = int((codes != hq_ref.ht_quant_ref(
                x, sign, noise, lo, step, bits=8)).sum())
            if mismatched:
                fail(f"ht_quant n={n} peers={peers}: {mismatched} codes "
                     "differ from the plain version")
            for name, fn, nbytes, flops in (
                    ("ht_amax", lambda: hq_ops.ht_amax_launch(x, sign),
                     hq_ref.ht_amax_bytes(rows, n),
                     hq_ref.ht_amax_flops(rows, n)),
                    ("ht_quant", lambda: hq_ops.ht_quant_launch(
                        x, sign, noise, lo, step, bits=8),
                     hq_ref.ht_quant_bytes(rows, n, per_peer),
                     hq_ref.ht_quant_flops(rows, n))):
                ms = time_ms(fn)
                b_ms, b_by = bound(nbytes, flops)
                emit({"phase": f"{name}_sweep", "n": n, "peers": peers,
                      "rows_per_peer": per_peer, "grid_rows": per_peer,
                      "bitwise_equal_plain": True, "ms": ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "share_of_bound": b_ms / ms,
                      "registers": ht_registers(regs, n, name == "ht_quant")})
            del arena, x, amax, codes
        del noise
    torch.cuda.empty_cache()


def check_quant_kernels(dev, gen, regs: dict) -> dict:
    """B3-B6 against their plain versions on the card, at the shapes
    ``optireduce_q`` gives them on the full-width path, chained as the
    exchange chains them: amax -> shared grids -> stage-1 codes -> the
    all_to_all view -> dequant + mean -> stage-2 codes."""
    import torch
    from repro_torch.kernels.dequant_reduce import ops as dq_ops
    from repro_torch.kernels.dequant_reduce import ref as dq_ref
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.ht_quant import ops as hq_ops
    from repro_torch.kernels.ht_quant import ref as hq_ref
    from repro_torch.kernels.quant import ops as gq_ops
    from repro_torch.kernels.quant import ref as gq_ref

    out = {}
    rows = PEERS * PEER_BLOCKS
    shard_blocks = SHARD // BLOCK

    def record(name, phase, err, ms, plain_ms, nbytes, flops, lib_ms=None,
               **extra):
        b_ms, b_by = bound(nbytes, flops)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        if "registers" in extra:           # B3, B4: the share too
            extra["share_of_bound"] = b_ms / ms
        emit({"phase": phase, **row, **extra})
        if name is not None:
            out[name] = row

    # B3: per-block amax of the rotation, on a strided arena slice
    arena = torch.randn((PEERS, 2, BUCKET), generator=gen, device=dev)
    x = arena[:, 1].view(PEERS, PEER_BLOCKS, BLOCK)
    sign = torch.where(torch.rand((BLOCK,), generator=gen, device=dev) < 0.5,
                       1.0, -1.0)
    amax = hq_ops.ht_amax_launch(x, sign)
    want = hq_ref.ht_amax_ref(x, sign)
    torch.cuda.synchronize()
    err = float((amax - want).abs().max())
    if err != 0.0:
        fail(f"ht_amax: max abs err {err}, expected bitwise equality")
    h = fwht_ref.hadamard_matrix(BLOCK, device=dev)
    record("ht_amax", "ht_amax", err,
           time_ms(lambda: hq_ops.ht_amax_launch(x, sign)),
           time_ms(lambda: hq_ref.ht_amax_ref(x, sign), reps=5),
           hq_ref.ht_amax_bytes(rows, BLOCK),
           hq_ref.ht_amax_flops(rows, BLOCK),
           time_ms(lambda: torch.matmul(x * sign, h).abs().amax(-1), reps=5),
           shape=list(x.shape), registers=ht_registers(regs, BLOCK, False),
           library="composite: torch.matmul(x * sign, H).abs().amax(-1), "
                   "fp32, TF32 off")
    del h

    # B4: stage-1 codes on the peer-shared grids, one shared noise copy
    shared = torch.clamp(amax.amax(0), min=1e-12)
    lo, step = -shared, 2.0 * shared / 255
    noise = torch.rand((PEER_BLOCKS, BLOCK), generator=gen, device=dev)
    codes = hq_ops.ht_quant_launch(x, sign, noise, lo, step, bits=8)
    want = hq_ref.ht_quant_ref(x, sign, noise, lo, step, bits=8)
    torch.cuda.synchronize()
    diff = (codes.int() - want.int()).abs()
    mismatched = int((diff > 0).sum())
    if mismatched:
        fail(f"ht_quant: {mismatched} codes differ from the plain version")
    record("ht_quant", "ht_quant", float(diff.max()),
           time_ms(lambda: hq_ops.ht_quant_launch(x, sign, noise, lo, step,
                                                  bits=8)),
           time_ms(lambda: hq_ref.ht_quant_ref(x, sign, noise, lo, step,
                                               bits=8), reps=5),
           hq_ref.ht_quant_bytes(rows, BLOCK, PEER_BLOCKS),
           hq_ref.ht_quant_flops(rows, BLOCK), shape=list(x.shape),
           mismatched_codes=mismatched,
           registers=ht_registers(regs, BLOCK, True))
    del arena, want, diff

    # B3 and B4 on non-finite input: a NaN and an inf each spread over their
    # Hadamard block; the block's amax must come out NaN / inf as in the
    # plain version (torch.amax passes NaN), and its codes equal the plain
    # version's (a NaN quotient gives code 0), so the block decodes to NaN
    bad = x[:, :8].clone()
    bad[1, 2, 5] = float("nan")
    bad[2, 6, 0] = float("inf")
    bad_amax = hq_ops.ht_amax_launch(bad, sign)
    want = hq_ref.ht_amax_ref(bad, sign)
    bad_shared = bad_amax.amax(0)
    bad_lo, bad_step = -bad_shared, 2.0 * bad_shared / 255
    bad_codes = hq_ops.ht_quant_launch(bad, sign, noise[:8], bad_lo,
                                       bad_step, bits=8)
    torch.cuda.synchronize()
    if not (torch.equal(bad_amax.isnan(), want.isnan())
            and torch.equal(bad_amax.nan_to_num(), want.nan_to_num())
            and bool(bad_amax[1, 2].isnan()) and bool(bad_shared[6].isinf())):
        fail(f"ht_amax on non-finite input: {bad_amax[:, :8].tolist()} vs "
             f"plain {want[:, :8].tolist()}")
    if not torch.equal(bad_codes, hq_ref.ht_quant_ref(
            bad, sign, noise[:8], bad_lo, bad_step, bits=8)):
        fail("ht_quant on non-finite input differs from the plain version")
    emit({"phase": "ht_nonfinite", "amax_nan_rows": int(bad_amax.isnan()
                                                        .sum()),
          "amax_inf_rows": int(bad_amax.isinf().sum()),
          "codes_equal_plain": True})
    del x, bad, bad_codes

    # B5: the all_to_all view of the codes, each receiver on its own grid
    # slice; with the arrival mask and without
    received = codes.view(PEERS, PEERS, SHARD).transpose(0, 1)
    lo_r, step_r = lo.view(PEERS, -1), step.view(PEERS, -1)
    lo_col = lo_r.repeat_interleave(BLOCK, dim=-1)
    step_col = step_r.repeat_interleave(BLOCK, dim=-1)
    mask = (torch.rand((PEERS, PEERS, SHARD), generator=gen, device=dev)
            < 0.99).to(torch.float32)
    mask[:, :, 1000:1300] = 0.0          # columns no peer delivered
    tol = DEQ_ULPS * 2.0 ** -23 * float(shared.max())
    own = None
    for m in (mask, None):
        got = dq_ops.dequant_mean_launch(received, lo_r, step_r, m,
                                         block=BLOCK)
        want = dq_ref.dequant_masked_mean_ref(received, lo_col, step_col, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not math.isfinite(err) or err > tol:
            fail(f"dequant_mean (mask={m is not None}): max abs err {err} "
                 f"> {tol}")
        if m is not None and bool((got[:, 1000:1300] != 0).any()):
            fail("dequant_mean: an all-dropped column is not exactly 0")
        record("dequant_mean" if m is not None else None,
               "dequant_mean" if m is not None else "dequant_mean_nomask",
               err,
               time_ms(lambda: dq_ops.dequant_mean_launch(
                   received, lo_r, step_r, m, block=BLOCK)),
               time_ms(lambda: dq_ref.dequant_masked_mean_ref(
                   received, lo_r.repeat_interleave(BLOCK, dim=-1),
                   step_r.repeat_interleave(BLOCK, dim=-1), m), reps=5),
               dq_ref.dequant_mean_bytes(PEERS, PEERS, SHARD, BLOCK,
                                         masked=m is not None),
               dq_ref.dequant_mean_flops(PEERS, PEERS, SHARD,
                                         masked=m is not None),
               shape=[PEERS, PEERS, SHARD], masked=m is not None,
               tolerance=tol)
        if m is not None:
            own = got
    del received, mask, want, codes

    # B6: stage-2 codes of the reduced shards on the bucket's grids, one
    # shared (1,600, 1024) noise copy
    x6 = own.view(-1, BLOCK)
    noise2 = torch.rand((shard_blocks, BLOCK), generator=gen, device=dev)
    codes2 = gq_ops.grid_quant_launch(x6, noise2, lo, step, bits=8)
    want = gq_ref.grid_quant_ref(x6, noise2, lo, step, bits=8)
    torch.cuda.synchronize()
    diff = (codes2.int() - want.int()).abs()
    mismatched = int((diff > 0).sum())
    if mismatched:
        fail(f"grid_quant: {mismatched} codes differ from the plain version")
    record("grid_quant", "grid_quant", float(diff.max()),
           time_ms(lambda: gq_ops.grid_quant_launch(x6, noise2, lo, step,
                                                    bits=8)),
           time_ms(lambda: gq_ref.grid_quant_ref(x6, noise2, lo, step,
                                                 bits=8), reps=5),
           gq_ref.grid_quant_bytes(x6.shape[0], BLOCK, shard_blocks,
                                   PEER_BLOCKS),
           gq_ref.grid_quant_flops(x6.shape[0], BLOCK),
           shape=list(x6.shape), mismatched_codes=mismatched)
    return out


THC_WORKERS = 8
THC_ROWS = 148_304         # gpt2-paper's 151,862,784 params padded to
                           # 8 workers x blocks of 1024, over 1024


def check_uniform_quant(dev, gen) -> dict:
    """B1 and B7 against their plain versions at the shapes the THC path
    hands them: B1's encode of the 8 workers' gradients as one
    (8 x 148,304, 1024) launch with the pre sign and its decode of the
    (148,304, 1024) mean with the post sign; B7 on the rotated stack as one
    launch, one shared noise copy, the range from the data as the harness
    forms it. Returns B7's bits-4 row (the harness's default width)."""
    import torch
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.quant import ops as gq_ops
    from repro_torch.kernels.quant import ref as gq_ref

    x = torch.randn((THC_WORKERS * THC_ROWS, BLOCK), generator=gen,
                    device=dev)
    sign = torch.where(torch.rand((BLOCK,), generator=gen, device=dev) < 0.5,
                       1.0, -1.0)
    for rows, mode, rmode in ((x.shape[0], "pre", "encode"),
                              (THC_ROWS, "post", "decode")):
        xs = x[:rows]
        got = fwht_ops.fwht_launch(xs, sign, mode)
        want = fwht_ref.randomized_fwht_ref(xs, sign, mode=rmode)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        del got, want
        if not math.isfinite(err) or err > FWHT_TOL:
            fail(f"fwht at the THC shape {rows}x{BLOCK} {mode}: max abs err "
                 f"{err} > {FWHT_TOL}")
        b_ms, b_by = bound(fwht_ref.fwht_bytes(rows, BLOCK),
                           fwht_ref.fwht_flops(rows, BLOCK))
        emit({"phase": "fwht_thc", "rows": rows, "n": BLOCK, "mode": mode,
              "max_abs_err": err, "tolerance": FWHT_TOL,
              "ms": time_ms(lambda: fwht_ops.fwht_launch(xs, sign, mode),
                            reps=10),
              "bound_ms": b_ms, "bound_by": b_by})
    del xs
    torch.cuda.empty_cache()
    x.mul_(1e-3)                 # gradient scale, as the harness sees it
    noise = torch.rand((THC_ROWS, BLOCK), generator=gen, device=dev)
    lohi = torch.stack([x.min() * 1.2 - 1e-3, x.max() * 1.2 + 1e-3])
    rows = {}
    for bits in (4, 8):
        got = gq_ops.uniform_quant_launch(x, noise, lohi, bits=bits)
        want = gq_ref.uniform_quant_ref(x, noise, lohi[0], lohi[1],
                                        bits=bits)
        torch.cuda.synchronize()
        mismatched = int((got != want).sum())
        err = float((got.int() - want.int()).abs().max())
        del got, want
        if mismatched:
            fail(f"uniform_quant bits={bits}: {mismatched} codes differ "
                 "from the plain version")
        ms = time_ms(lambda: gq_ops.uniform_quant_launch(x, noise, lohi,
                                                         bits=bits))
        plain_ms = time_ms(lambda: gq_ref.uniform_quant_ref(
            x, noise, lohi[0], lohi[1], bits=bits), reps=3, warmup=1)
        b_ms, b_by = bound(
            gq_ref.uniform_quant_bytes(x.shape[0], BLOCK, THC_ROWS),
            gq_ref.uniform_quant_flops(x.shape[0], BLOCK))
        rows[bits] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "uniform_quant", "bits": bits,
              "shape": [THC_WORKERS, THC_ROWS, BLOCK],
              "noise_shape": [THC_ROWS, BLOCK], "lohi": lohi.tolist(),
              "mismatched_codes": mismatched, "library_ms": None,
              **rows[bits]})
    # a NaN gives code 0 and leaves the other codes as the plain version's
    bad = x[:4096].clone()
    bad[1, 3] = float("nan")
    got = gq_ops.uniform_quant_launch(bad, noise[:4096], lohi, bits=4)
    want = gq_ref.uniform_quant_ref(bad, noise[:4096], lohi[0], lohi[1],
                                    bits=4)
    if not (torch.equal(got, want) and int(got[1, 3]) == 0):
        fail("uniform_quant on a NaN differs from the plain version")
    emit({"phase": "uniform_quant_nan", "nan_code": int(got[1, 3]),
          "codes_equal_plain": True})
    del x, noise
    torch.cuda.empty_cache()
    return rows[4]


def train_thc(counters: dict) -> dict:
    """The THC path of the time-to-accuracy harness at full width, through
    its entry point; returns each kernel's launches in this run alone."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.sim.tta import TrainRunConfig, run_training

    rc = TrainRunConfig(compressor="thc", n_workers=THC_WORKERS,
                        per_worker_batch=4, seq_len=64, steps=3,
                        eval_every=1)
    cfg = get_config("gpt2-paper")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    hist = run_training(rc, device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, step in enumerate(hist["steps"]):
        acc, div = hist["acc"][i], hist["divergence"][i]
        emit({"phase": "tta_thc_step", "step": step, "acc": acc,
              "divergence": div, "step_ms": hist["step_s"][step] * 1e3})
        if not math.isfinite(acc) or div != 0.0:
            fail(f"thc step {step}: acc {acc}, divergence {div} (every "
                 "replica gets the same bucket: it must be exactly 0)")
    emit({"phase": "tta_thc", "arch": cfg.name, "workers": rc.n_workers,
          "steps": rc.steps, "bits": rc.thc_bits,
          "block": rc.hadamard_block, "wall_s": wall,
          "peak_mem_bytes": peak, "launches": counts,
          "per_step": {k: v / rc.steps for k, v in counts.items()}})
    return counts


def tta_paths(dev) -> None:
    """The harness's other paths on gpt2-smoke on the card, 2 steps each."""
    from repro_torch.sim.tta import TrainRunConfig, run_training

    paths = {"topk": {"compressor": "topk"},
             "terngrad": {"compressor": "terngrad"},
             "tail": {"drop_rate": 0.01},
             "tail_ef": {"drop_rate": 0.01, "recovery": "ef"}}
    for name, kw in paths.items():
        rc = TrainRunConfig(steps=2, eval_every=1, **kw)
        hist = run_training(rc, device=dev)
        emit({"phase": "tta_paths", "path": name, "acc": hist["acc"],
              "divergence": hist["divergence"], "drops": hist["drops"],
              "step_ms": [t * 1e3 for t in hist["step_s"]]})
        if not all(math.isfinite(a) for a in hist["acc"]):
            fail(f"tta path {name}: accuracy {hist['acc']}")
        if name.startswith("tail") and not hist["divergence"][-1] > 0:
            fail(f"tta path {name}: stage-2 drops left the replicas equal "
                 f"(divergence {hist['divergence']})")


def check_thc_against_cpu(dev) -> None:
    """2 THC steps of the harness on gpt2-smoke, card against CPU, same
    parameters and draws.

    A summed code that differs between the two (a floor on a boundary, the
    gradients summed in another order) moves each entry of its Hadamard
    block by |d| x step / (N sqrt(block)). Accuracy is held within one eval
    token a differing code so far. Momentum SGD (0.9) carries a step-0
    difference into step 1 as 1.9 x lr x it and a step-1 difference as lr x
    it, so each parameter is held within lr x (1.9 move_0 + move_1) x 1.1
    (the gradient's response to the moved parameters) + lr x 1e-5 (fp32
    sums in other orders through the model)."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.keys import generator, key
    from repro_torch.models import init_params
    from repro_torch.sim.tta import (KeyDraws, ReplicaRun, TrainRunConfig,
                                     _flatten)
    from repro_torch.tree import tree_map

    cpu = torch.device("cpu")
    rc = TrainRunConfig(compressor="thc", n_workers=4, per_worker_batch=4,
                        seq_len=32, steps=2, eval_every=1, lr=0.1)
    cfg = get_smoke("gpt2-paper")
    base = init_params(generator(key(0)), cfg, device="cpu")
    runs = {"cpu": ReplicaRun(rc, device=cpu, cfg=cfg, params=base,
                              draws=KeyDraws(cpu)),
            "cuda": ReplicaRun(rc, device=dev, cfg=cfg, params=base,
                               draws=_HostDraws(KeyDraws(cpu), dev))}
    tokens = runs["cpu"].eval_labels.numel()
    n, block = rc.n_workers, rc.hadamard_block
    flipped = 0
    moves, details = [], []
    for step in range(rc.steps):
        acc, sums = {}, {}
        for name, run in runs.items():
            sums[name] = _thc_code_sum(run, step)
            run.step(step)
            acc[name] = run.accuracy()
        (a, lohi), (b, lohi_b) = sums["cpu"], sums["cuda"]
        d = (a - b).abs()
        qstep = float(lohi[1] - lohi[0]) / ((1 << rc.thc_bits) - 1)
        moves.append((d.sum(1).double() * qstep / (n * math.sqrt(block)))
                     .repeat_interleave(block)[:runs["cpu"].length])
        flipped += int(d.sum())
        lohi_diff = float((lohi - lohi_b).abs().max())
        details.append({"step": step, "codes_differing": int((d > 0).sum()),
                        "code_sum_abs_diff": int(d.sum()),
                        "lohi_max_abs_diff": lohi_diff, "acc": acc})
        if abs(acc["cpu"] - acc["cuda"]) > flipped / tokens + 1e-9:
            fail(f"thc card vs CPU step {step}: accuracy {acc} apart by "
                 f"more than {flipped} of {tokens} eval tokens")
    # every replica holds the same parameters (divergence 0): worker 0's
    p_cpu, p_gpu = (_flatten(tree_map(lambda x: x[0], r.params))[0].cpu()
                    for r in runs.values())
    allowed = rc.lr * (1.1 * (1.9 * moves[0] + moves[1]) + 1e-5)
    excess = float(((p_cpu - p_gpu).abs() - allowed).max())
    p_err = float((p_cpu - p_gpu).abs().max())
    emit({"phase": "tta_reference_check", "arch": cfg.name, "steps": 2,
          "workers": n, "eval_tokens": tokens, "steps_detail": details,
          "params_max_abs_diff": p_err,
          "param_excess_over_bound": excess})
    if excess > 0:
        fail(f"thc card vs CPU: parameters {p_err} apart, {excess} past "
             "what the differing codes move")


def _thc_code_sum(run, step: int):
    """The summed codes and the range that ``run.step(step)`` aggregates:
    its workers' gradients, padded, rotated and quantized from the draws
    the step takes. Returns both on the CPU."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compression import thc_compress
    from repro_torch.core.keys import fold_in

    rc, block = run.rc, run.rc.hadamard_block
    flats = run.worker_flats(run.data.global_batch(step))
    g = F.pad(flats, (0, (-flats.shape[1]) % (rc.n_workers * block)))
    lohi = torch.stack([g.min() * 1.2 - 1e-3, g.max() * 1.2 + 1e-3])
    skey = fold_in(run.key, step)
    codes = thc_compress(
        g, run.draws.sign(skey, block),
        run.draws.uniform(fold_in(skey, 1), (g.shape[1] // block, block)),
        lohi, bits=rc.thc_bits, block=block).codes
    return codes.to(torch.int32).sum(0).cpu(), lohi.cpu()


def train_main_path(strategy: str, steps: int, counters: dict) -> dict:
    """One main path through the launcher at full width; returns each
    kernel's launches in this run alone."""
    import torch
    from repro_torch.launch import train as launch_train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    records = launch_train.run([
        "--arch", "gpt2-paper", "--steps", str(steps), "--dp", str(PEERS),
        "--strategy", strategy, "--drop-rate", "0.01", "--drop-pattern",
        "tail", "--seq-len", "128", "--global-batch", "8", "--optimizer",
        "adamw", "--device", "cuda", "--kernel-mode", "kernel",
        "--incast", str(ROUNDS_INCAST), "--log-every", "1"])
    torch.cuda.synchronize()
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, rec in enumerate(records):
        emit({"phase": "train_step", "strategy": strategy, "step": i,
              "loss": rec["loss"], "loss_frac": rec["loss_frac"],
              "grad_norm": rec["grad_norm"], "step_ms": rec["step_s"] * 1e3})
        if not (math.isfinite(rec["loss"]) and rec["loss_frac"] > 0):
            fail(f"{strategy} step {i}: loss {rec['loss']} loss_frac "
                 f"{rec['loss_frac']}")
    emit({"phase": "train", "strategy": strategy, "arch": "gpt2-paper",
          "peers": PEERS, "steps": steps, "peak_mem_bytes": peak,
          "launches": counts,
          "per_step": {k: v / steps for k, v in counts.items()}})
    return counts


STRATEGIES = ("psum", "gloo_ring", "nccl_tree", "bcube", "tar_tcp",
              "tar_rounds", "optireduce", "optireduce_q", "optireduce_rounds",
              "tar_rounds_q", "ring_ht")
LOSSY = ("optireduce", "optireduce_q", "optireduce_rounds", "tar_rounds_q")
ROTATED = ("optireduce", "optireduce_rounds", "ring_ht")
QUANTIZED = ("optireduce_q", "tar_rounds_q")
ROT_E2E_TOL = 5e-5   # encode and decode, each within 2e-5 of exact at unit
                     # scale (B1's check: 1e-5 from plain), plus fp32 sums
ARENA_BUCKETS = 24   # gpt2-paper's 151,862,784 params in 6,553,600 buckets


def sync_strategies(dev, counters: dict) -> None:
    """Phases ``strategies`` and ``policies``: one full-width arena, (4, 24,
    6,553,600) fp32 with distinct peers, through ``sync_packed(mode=
    "pipelined")`` for every ported strategy, and the three participation
    policies on the strategies that run them.

    Held against the fp64 mean over the contributing peers: within P 2^-23
    max|x| for fp32 sums; within ``ROT_E2E_TOL`` for the rotated ones; for
    the quantized ones each Hadamard block's error within the grid-step
    bound, L2 norm <= 2 step_b sqrt(block) (stage 1 and stage 2 each move a
    rotated entry by less than one step, and the rotation keeps L2 norms).
    Lossy strategies at drop 0.01: every peer's row bitwise equal."""
    import torch
    from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
    from repro_torch.core.pipeline import GeneratorDraws, SyncContext
    from repro_torch.kernels.ht_quant import ref as hq_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    arena = torch.empty((PEERS, ARENA_BUCKETS, BUCKET), device=dev)
    for p in range(PEERS):                      # distinct peers
        arena[p].normal_(generator=gen).mul_(1.0 + 0.25 * p)
    sum_tol = PEERS * 2.0 ** -23 * float(arena.abs().max())

    def run(strategy, rate=0.0, **policy):
        cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                               drop_pattern="tail", hadamard_block=BLOCK,
                               incast=ROUNDS_INCAST, **policy)
        draws = GeneratorDraws(key=(0, 7), cfg=cfg, device=dev)
        ctx = SyncContext(cfg=cfg, draws=draws)
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sync_packed(arena, ctx, mode="pipelined")
        end.record()
        torch.cuda.synchronize()
        counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        return out, start.elapsed_time(end), counts, draws

    def replicas_equal(out):
        return all(torch.equal(out[p], out[0]) for p in range(1, PEERS))

    def error(strategy, out, peers, draws):
        """The worst error against the fp64 mean over ``peers``, over its
        tolerance (<= 1 passes)."""
        worst = 0.0
        for b in range(ARENA_BUCKETS):
            want = arena[list(peers), b].double().mean(0)
            err = (out[:, b].double() - want).abs()
            if strategy not in QUANTIZED:
                tol = ROT_E2E_TOL if strategy in ROTATED else sum_tol
                worst = max(worst, float(err.max()) / tol)
                continue
            # the grids the codec shared: the max over every peer of each
            # rotated block's amax (ejected peers too), over the bucket
            # padded for the shards
            shards = len(peers)
            pad = (-BUCKET) % (shards * BLOCK)
            x = torch.nn.functional.pad(arena[:, b], (0, pad))
            amax = hq_ref.ht_amax_ref(x.view(PEERS, -1, BLOCK),
                                      draws.sign(b, BLOCK)).amax(0)
            step = 2.0 * amax.clamp(min=1e-12) / 255
            l2 = torch.nn.functional.pad(err, (0, pad)).view(
                PEERS, -1, BLOCK).norm(dim=-1)
            bound = 2.0 * step.double() * math.sqrt(BLOCK) + ROT_E2E_TOL
            worst = max(worst, float((l2 / bound).max()))
        return worst

    for strategy in STRATEGIES:
        out, ms, counts, draws = run(strategy)
        worst = error(strategy, out, range(PEERS), draws)
        row = {"phase": "strategies", "strategy": strategy, "drop_rate": 0.0,
               "device_ms": ms, "launches": counts,
               "error_over_tolerance": worst,
               "replicas_equal": replicas_equal(out)}
        del out
        if strategy in LOSSY:
            out, ms_d, counts_d, _ = run(strategy, 0.01)
            row.update(device_ms_drop_0_01=ms_d, launches_drop_0_01=counts_d,
                       replicas_equal_drop_0_01=replicas_equal(out))
            del out
        emit(row)
        if not (worst <= 1.0 and row["replicas_equal"]
                and row.get("replicas_equal_drop_0_01", True)):
            fail(f"strategies: {row}")

    # degraded participation: peer 2 ejected, every replica still the same
    active = (0, 1, 3)
    for strategy in ("optireduce", "optireduce_rounds", "tar_rounds_q",
                     "ring_ht", "gloo_ring"):
        out, ms, counts, draws = run(strategy, active_peers=active)
        worst = error(strategy, out, active, draws)
        row = {"phase": "policies", "policy": "active_peers",
               "active_peers": list(active), "strategy": strategy,
               "device_ms": ms, "launches": counts,
               "error_over_tolerance": worst,
               "replicas_equal": replicas_equal(out)}
        del out
        emit(row)
        if not (worst <= 1.0 and row["replicas_equal"]):
            fail(f"policies: {row}")

    # weighted shards at drop 0: the uniform result's bits on the TAR
    # rounds (each column's mean is over the same senders in the same
    # order); the ring sums each chunk starting at its owner, so re-cut
    # chunks add in another order: within the fp32 sum bound
    weights = (2, 2, 2, 1)
    for strategy in ("tar_rounds", "optireduce_rounds", "gloo_ring"):
        uniform, _, _, _ = run(strategy)
        out, ms, counts, _ = run(strategy, shard_weights=weights)
        diff = float((out - uniform).abs().max())
        row = {"phase": "policies", "policy": "shard_weights",
               "shard_weights": list(weights), "strategy": strategy,
               "device_ms": ms, "launches": counts,
               "bitwise_equal_uniform": bool(torch.equal(out, uniform)),
               "max_abs_diff_uniform": diff,
               "values_differing": int((out != uniform).sum()),
               "bit_patterns_differing": int(
                   (out.view(torch.int32) != uniform.view(torch.int32)).sum())}
        del out, uniform
        emit(row)
        ok = row["bitwise_equal_uniform"] if strategy != "gloo_ring" \
            else diff <= sum_tol
        if not ok:
            fail(f"policies: {row}")

    # a dead link under drops: relayed rounds, the same bits; one relayed
    # round in each stage (2 permutes more a stage)
    base, _, _, _ = run("optireduce_rounds", 0.01)
    out, ms, counts, _ = run("optireduce_rounds", 0.01,
                             dead_links=((1, 2),))
    row = {"phase": "policies", "policy": "dead_links",
           "dead_links": [[1, 2]], "strategy": "optireduce_rounds",
           "drop_rate": 0.01, "device_ms": ms, "launches": counts,
           "permutes_per_bucket": counts["permutes"] / ARENA_BUCKETS,
           "bitwise_equal_no_dead_link": bool(torch.equal(out, base))}
    del out, base, arena
    torch.cuda.empty_cache()
    emit(row)
    if not (row["bitwise_equal_no_dead_link"]
            and counts["permutes"] == ARENA_BUCKETS * (6 + 4)):
        fail(f"policies: {row}")


class _HostDraws:
    """A draws provider's CPU draws, served on any device: both runs of a
    comparison see the same signs, masks and noises."""

    def __init__(self, inner, device):
        self.inner, self.device = inner, device

    def __getattr__(self, name):
        draw = getattr(self.inner, name)
        return lambda *args, **kw: draw(*args, **kw).to(self.device)


def check_step_against_cpu(dev, strategy: str) -> None:
    """2 gpt2-smoke steps on the card against the plain versions on the
    CPU, same parameters and draws.

    ``optireduce`` runs both steps free and holds metrics and parameters
    to ``STEP_TOL``. ``optireduce_q`` starts step 1 on the card from the
    CPU's state after step 0: a code whose floor sits on a boundary may
    differ between the two gradients (fp32 sums in other orders), moving its
    Hadamard block by one grid step / sqrt(block), and one free step would
    carry that into every gradient of the next. Each step is then held to:
    loss within ``STEP_TOL``, loss_frac within 1e-7 (the same masks), the
    first moment within 1e-6 but on at most 4 blocks' worth of entries
    (4 x 256), and there within 0.1 x 4 grid steps / sqrt(256) of the
    clipped gradient norm, grad_norm within 2/255 relative a differing
    block, and the
    parameters within what AdamW makes of the measured moment difference,
    lr x (|dm_hat| + 1.0003 |d sqrt(v_hat)|) / (sqrt(v_hat) + eps), plus
    ``STEP_TOL`` x lr."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, generator, key
    from repro_torch.core.pipeline import GeneratorDraws
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import AdamState, OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_leaves, tree_map

    runtime.set_kernel_mode(None)       # by device: card kernels, CPU plain
    quantized = strategy in ("optireduce_q", "tar_rounds_q")
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(strategy=strategy, drop_rate=0.05,
                            drop_pattern="bernoulli", hadamard_block=256,
                            incast=ROUNDS_INCAST)
    ocfg = OptimizerConfig(lr=1e-2)
    tc = TrainConfig(sync=sync, optimizer=ocfg, bucket_elems=16_384,
                     seq_chunk=32)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    base = init_params(generator(k), cfg, device="cpu")
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    fns, params, states = {}, {}, {}
    for name, device in devices.items():
        fns[name], opt = build_train_step(cfg, tc, peers=PEERS,
                                          device=device)
        params[name] = tree_map(lambda p: p.clone().to(device), base)
        states[name] = opt.init(params[name])
    metrics = {"cpu": [], "cuda": []}
    worst = p_err = 0.0
    details = []
    for step in range(2):
        if quantized and step > 0:        # the card starts from the CPU's
            params["cuda"] = tree_map(lambda p: p.detach().clone().to(dev),
                                      params["cpu"])
            states["cuda"] = AdamState(
                *(tree_map(lambda t: t.clone().to(dev), part)
                  for part in states["cpu"]))
        for name, device in devices.items():
            draws = _HostDraws(GeneratorDraws(
                key=fold_in(fold_in(k, step), 7), cfg=sync,
                device=torch.device("cpu")), device)
            params[name], states[name], m = fns[name](
                params[name], states[name], data.host_batch(step, 0, 1), step,
                k, draws=draws)
            metrics[name].append({n: float(v) for n, v in m.items()})
        a, b = metrics["cpu"][-1], metrics["cuda"][-1]
        if not quantized:
            continue
        worst = max(worst, *(abs(a[n] - b[n])
                             for n in ("loss", "loss_frac", "skipped")))
        bc1 = 1 - ocfg.beta1 ** (step + 1)
        bc2 = 1 - ocfg.beta2 ** (step + 1)
        clip = min(a["grad_norm"], ocfg.grad_clip)
        m_tol = 1e-6 + 0.1 * 4 * 2 * clip / 255 / math.sqrt(256)
        moved = 0
        excess = m_err = 0.0
        for pc, pg, mc, mg, vc, vg in zip(
                *(tree_leaves(t) for t in (
                    params["cpu"], params["cuda"], states["cpu"].m,
                    states["cuda"].m, states["cpu"].v, states["cuda"].v))):
            dm = (mc - mg.cpu()).abs()
            moved += int((dm > 1e-6).sum())
            m_err = max(m_err, float(dm.max()))
            svc, svg = torch.sqrt(vc / bc2), torch.sqrt(vg.cpu() / bc2)
            du = (dm / bc1 + 1.0003 * (svc - svg).abs()) / (
                torch.maximum(svc, svg) + ocfg.eps)
            err = (pc.detach() - pg.detach().cpu()).abs()
            p_err = max(p_err, float(err.max()))
            excess = max(excess, float((err - ocfg.lr * du).max()))
        flips = min(4, math.ceil(moved / 256))
        g_rel = abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
        details.append({"step": step, "moment_entries_moved": moved,
                        "moment_max_abs_diff": m_err, "moment_tol": m_tol,
                        "grad_norm_rel_diff": g_rel,
                        "param_excess_over_adamw_bound": excess})
        if not (abs(a["loss"] - b["loss"]) <= STEP_TOL
                and moved <= 4 * 256 and m_err <= m_tol
                and abs(a["loss_frac"] - b["loss_frac"]) <= 1e-7
                and g_rel <= 1e-5 + flips * 2 / 255
                and excess <= STEP_TOL * ocfg.lr):
            fail(f"card vs CPU {strategy} step {step}: {details[-1]}, "
                 f"metrics {a} vs {b}")
    if not quantized:
        worst = max(abs(a[n] - b[n])
                    for a, b in zip(metrics["cpu"], metrics["cuda"])
                    for n in a)
        p_err = max(float((a.detach() - b.detach().cpu()).abs().max())
                    for a, b in zip(tree_leaves(params["cpu"]),
                                    tree_leaves(params["cuda"])))
        if not (worst <= STEP_TOL and p_err <= STEP_TOL):
            fail(f"card vs CPU step: metrics {worst}, params {p_err} > "
                 f"{STEP_TOL}")
    emit({"phase": "rounds_cpu" if "rounds" in strategy
          else "reference_check", "strategy": strategy,
          "arch": cfg.name, "steps": 2, "metrics_max_abs_diff": worst,
          "params_max_abs_diff": p_err, "tolerance": STEP_TOL,
          "each_step_from_cpu_state": quantized, "quant": details,
          "cpu": metrics["cpu"], "gpu": metrics["cuda"]})


def profile_step(dev, strategy: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import generator, key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train.trainer import TrainConfig, build_train_step

    cfg = get_config("gpt2-paper")
    sync = OptiReduceConfig(strategy=strategy, drop_rate=0.01,
                            drop_pattern="tail", hadamard_block=BLOCK,
                            incast=ROUNDS_INCAST)
    tc = TrainConfig(sync=sync, seq_chunk=128)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    k = key(0)
    params = init_params(generator(k, dev), cfg, device=dev)
    step_fn, opt = build_train_step(cfg, tc, peers=4, device=dev)
    state = opt.init(params)
    batches = [data.host_batch(s, 0, 1) for s in range(3)]

    def one(s):
        nonlocal params, state
        params, state, m = step_fn(params, state, batches[s], s, k)
        float(m["loss"])
    profile_third_step(one, {"strategy": strategy, "arch": cfg.name,
                             "peers": PEERS})


def profile_thc(dev) -> None:
    """The THC path's third step at full width under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.sim.tta import ReplicaRun, TrainRunConfig

    rc = TrainRunConfig(compressor="thc", n_workers=THC_WORKERS,
                        per_worker_batch=4, seq_len=64, steps=3)
    run = ReplicaRun(rc, device=dev, cfg=get_config("gpt2-paper"))

    def one(s):
        run.step(s)
        run.synchronize()
    profile_third_step(one, {"path": "tta_thc", "arch": "gpt2-paper",
                             "workers": rc.n_workers})


# the port's kernel functions, as the profiler names them
PORTED_KERNELS = ("fwht_rows_kernel", "masked_mean_vec4", "ht_kernel",
                  "dequant_mean_kernel", "grid_quant_kernel",
                  "uniform_quant_kernel")


def profile_third_step(one, label: dict) -> None:
    """Run ``one(0)``, ``one(1)`` (each a step ending in a synchronisation)
    on the host clock, then ``one(2)`` under ``torch.profiler``: wall time,
    device busy time and idle share, the largest device and host entries,
    and the device time of each of the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import collectives

    wall = []
    for s in range(2):
        t0 = time.perf_counter()
        one(s)
        wall.append((time.perf_counter() - t0) * 1e3)
    permutes = collectives.permutes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one(2)
        prof_wall = (time.perf_counter() - t0) * 1e3
    permutes = collectives.permutes - permutes
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
    ported = [r for r in on_dev if any(k in r.key for k in PORTED_KERNELS)]
    # gathers and indexed writes: the permutes' index_select / index_copy_
    # and the schedules' per-peer row reads and writes (also embedding and
    # loss gathers, which every path has)
    indexed = [r for r in on_dev if "index" in r.key.lower()]
    emit({"phase": "profile", **label,
          "step_ms_unprofiled": wall[-1], "step_ms_profiled": prof_wall,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          # busy over the profiled step's wall time; the second share
          # divides the same busy time by the unprofiled step before it,
          # which runs the same kernels without the profiler's host cost
          "device_idle_share_of_profiled_step": (1 - busy_ms / prof_wall)
          if busy_ms > 0 else "not measured",
          "device_idle_share_of_unprofiled_step": (1 - busy_ms / wall[-1])
          if busy_ms > 0 else "not measured",
          "kernel_launches": launches,
          "permutes": permutes,
          "index_kernels_ms": sum(dev_us(r) for r in indexed) / 1e3,
          "index_kernels_launches": sum(r.count for r in indexed),
          "top_device": [{"name": r.key[:90], "ms": dev_us(r) / 1e3,
                          "count": r.count} for r in top_dev],
          "ported_kernels": [{"name": r.key[:90], "ms": dev_us(r) / 1e3,
                              "count": r.count} for r in ported],
          "top_host": [{"name": r.key[:90],
                        "ms": r.self_cpu_time_total / 1e3,
                        "count": r.count} for r in top_cpu]})


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
