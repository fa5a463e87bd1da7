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
    ms of the index kernels (the permutes' gathers and indexed writes);
18. ``adaptive_codec``: the launcher with the §3.2 control plane in the loop,
    ``--strategy optireduce --adaptive --drop-rate 0.002 --steps 5 --trace
    --report`` at 6.'s full width: per step the policy the step ran under,
    B1 and B2 launches, loss_frac, step ms, the trace's ``step`` span's
    host ms beyond the step (logging, control plane, any rebuild) and the
    device busy ms of the first and last step (under ``torch.profiler``),
    then the control plane's host us a step, replayed on the run's own
    telemetry; B1 must be 48 a step while
    ``use_hadamard`` is on and 0 while it is off, B2 24; the rebuilds must
    equal the ``(step rebuilt)`` lines and each policy switch an
    ``adaptive:`` line; the trace must validate with one ``step`` span a
    step, ``python -m repro_torch.obs.report`` on it exit 0, and the report
    hold one row a step;
19. ``adaptive_rounds``: the same for ``--strategy optireduce_rounds
    --incast 2 --adaptive --drop-rate 0.01 --steps 6``: every step 48 B1, 24
    B2 and 144 permutes, and 24 x 2 x ceil(3 / I) incast groups at the
    step's incast I, none of B3-B7;
20. ``netsim``: the calibrated network simulator on the host at the sizes
    of ``benchmarks/bench_tta.py`` (8 nodes, 25 MB buckets of GPT-2 base's
    497 MB of fp32 gradients, 150 steps x 19 buckets) for gloo_ring, bcube,
    nccl_ring, nccl_tree, tar_tcp and optireduce in local_1.5, local_3.0
    and cloudlab: the simulated mean, p50 and p99 gradient-aggregation ms
    and mean drop, and the host seconds each took; every value finite, Gloo
    ring's mean over OptiReduce's above 1 in local_1.5 and larger in
    local_3.0, OptiReduce's mean drop in (0, 0.01), the reliable ones 0.

21. ``recovery_main``: the launcher with ``--recovery ef --drop-pattern
    burst`` (drop rate 0.01) as in 6., 4 steps: per step loss, loss_frac,
    the entries the stale cache filled (> 0), step ms and peak memory;
    exactly 120 B1 launches a step (the data's encode and decode, the
    cache's one-row encode, the residuals' encode and decode, 24 buckets)
    and none of B2 (the plain mean follows the fill); then one more step of
    it profiled as in 9., with its elementwise kernels listed;
22. ``recovery_stale`` (``--recovery stale``, 3 steps: 72 B1, 0 B2 a step)
    and ``recovery_rounds`` (``optireduce_rounds --incast 2 --recovery ef``,
    2 steps: 120 B1, 0 B2, 144 permutes a step);
23. ``recovery_budget``: ``--recovery ef+budget --report``, 3 steps, the
    loss budget's phase, loss EMA, budget and deadline factor a step from
    the report, every one finite;
24. ``recovery_check``: 3 gpt2-smoke steps of ``--recovery ef`` under burst
    drops at 0.05, card against CPU as in 8.: metrics, parameters, both
    AdamW moments, the stale cache and the residuals within ``STEP_TOL``,
    the filled counts equal;
25. ``checkpoint``: ``--recovery ef`` at full width, ``--steps 2 --ckpt-dir
    T`` (a temporary directory): the parts of the final save (bf16
    parameters, AdamW moments, cache, residuals) with the bytes on disk,
    the host-copy, write and restore seconds; the restored leaves equal to
    the saved state bit for bit; then ``--resume --steps 4`` (steps 2 and
    3), whose loss and loss_frac must agree with two uninterrupted 4-step
    runs within the spread between those two.

26. ``a15_shapes``: B1-B5 at the new shapes of the FSDP
    reduce-scatter and the pod grid, against their plain versions as in
    3.-5.: B1 encodes of ``wq``, ``w_gate`` and ``embed`` (4 peers x 576,
    2,304 and 37,696 blocks of 1024) and the embedding's decode (4 x
    9,424), B2 on the reduce-scatter's all_to_all view (4, 4, 9,650,176)
    and on the pod grid's (8, 4, 1,638,400) (both pods in one launch), B3,
    B4 and B5 at the embedding's length;
27. ``fsdp_main``: the launcher with ``--dp-mode fsdp`` as in 6., 4 steps:
    86 gather sites a step (12 layers x 7 weights, the embedding twice),
    each one reduce-scatter of 2 B1 and 1 B2 over all 4 peers, and the
    norms' bucket (19,200 entries, 2 B1 and 1 B2): exactly 174 B1 and 87
    B2 a step; ``loss_frac`` counts the norms' bucket only (as the
    reference's), so it may be 0;
28. ``fsdp_q``: ``build_train_step`` with ``sync.rs_wire_bits=8``, 2
    steps: 86 B3, B4 and B5 and 88 B1 (each site's decode, the bucket's
    two), 1 B2 a step;
29. ``pod_main``: ``build_train_step`` with ``pure_dp`` on
    ``make_host_mesh(dp=4, tp=2)`` (2 pods x 4 data = 8 peers),
    ``optireduce_2d``, tail drops 0.01, 3 steps: 48 B1 and 24 B2 a step
    (one launch a bucket for both pods), every one of the 8 peers holding
    the same synced arena (held after every sync);
30. ``pod_q``: ``optireduce_q`` on the same grid, 2 steps: 24 B1, B3, B4,
    B5 and B6 a step;
31. ``fsdp_check`` and ``pod_check``: gpt2-smoke on the card against the
    CPU, 2 steps each with the same draws (FSDP on 4 peers; ``pure_dp``
    ``optireduce_2d`` on 2 x 4), and one FSDP step with 2 micro-batches:
    metrics, parameters and both AdamW moments within ``STEP_TOL``, the
    card's launches exact;
32. ``profile`` of one ``--dp-mode fsdp`` step as in 9., with its peak
    memory.

33. ``tp_shapes``: B1-B6 at the shapes of the ``(data 4, model 2)`` grid
    (one bucket of the ``(8, 12, 6,553,600)`` arena, both tp groups in one
    launch) against their plain versions, as 3.-5. (B3, B4, B6 bitwise; B4
    with one set of grids a tp group), timed with their bounds;
34. ``tp_main``, ``tp_q``, ``tp_fsdp``: the launcher with ``--tp 2`` beside
    the 4 data peers at 6.'s full width, 4 steps each: each tp rank's local
    leaves (75,941,376 entries) in 12 buckets, so 24 B1 and 12 B2 a step;
    ``optireduce_q`` 12 each of B1 and B3-B6; FSDP x TP 174 B1 and 87 B2
    (86 gather sites and the norms' bucket, each over both tp groups at
    once);
35. ``tp_prod``: ``--production-mesh --smoke --global-batch 16``, 2 steps:
    256 peers (16 x 16) on gpt2-smoke, heads padded 4 -> 16, one KV head a
    shard, vocab 512 / 16; one bucket, 2 B1 and 1 B2 a step;
36. ``tp_check``: gpt2-smoke at ``(data 2, model 2)`` on the card against
    the CPU as 31., replicated, FSDP x TP and ``seq_parallel``, 2 steps
    each;
37. ``profile`` of one ``--tp 2`` step as in 9.

38. ``wire_ring``: one full-width bucket, (4, 6,553,600) fp32, through
    ``HostRing.allreduce`` over the inproc wire backend, each peer's stage
    functions on the card, the wire scripted to lose the packets of the
    engine's tail masks at 0.01: bitwise ``sync_packed`` under ``Lossy`` on
    the same draws, for optireduce (8 B1 + 4 B2 launches: each peer's
    encode, decode and compensated mean) and optireduce_q (4 each of B1,
    B3-B6); the datagrams and bytes of each kind and the host seconds;
39. ``wire_main``, ``wire_q``: the launcher at 6.'s full width, gpt2-paper
    cut to 4 of its 12 layers (12 buckets of 6,553,600), with
    ``--transport inproc`` (2 and 1 steps): 24 B1 + 12 B2, and 12 each of
    B1, B3-B6 a step, as on the lossy path; no bridge miss or error; one
    ``wire[inproc]`` line a step with 4 peers; the wire's loss_frac within
    0.0075 +- 0.002 (0.01 x 3/4: a receiver's own row never crosses the
    wire); per step the datagrams and bytes of each kind, the bridge's
    device-to-host and host-to-device bytes, the host seconds the bridge
    held the training thread and the flush at the step's end;
40. ``wire_udp``: the same with ``--transport udp --rendezvous auto
    --wire-deadline 0.02``, 1 step (its loss is the same every step: what
    the receive buffers hold of a bucket): the rendezvous line, no miss, one
    ``wire[udp]`` line a step, the kernel's ``rmem_max``, the socket's
    effective ``SO_RCVBUF``, the observed loss and the steps the 0.10
    guard skipped (recorded, not failed);
41. ``wire_check``: gpt2-smoke over the inproc wire (loss 0.05), 2 steps on
    the card against the CPU, same parameters and draws: metrics and
    parameters within ``STEP_TOL``, every bridge mask equal; then 2 steps
    over UDP on the card: loss at most 0.07, no step skipped;
42. ``profile`` of ``wire_main``'s last step as in 9.;
43. ``multiproc_inproc``: ``repro_torch.launch.multiproc --backend
    inproc`` on the card, 4 rank-threads each exchanging one gpt2-paper
    bucket (``--elems 6553600 --hadamard-block 1024 --packet-elems 256``)
    at wire loss 0.01, 2 steps each of optireduce and optireduce_q: every
    rank's output checksums equal a ``HostRing``'s on the card (same data,
    keys and header-hashed drops); launches exact, 8 B1 + 4 B2 (4 each of
    B1, B3-B6) a step and as many again for the warm-up before the first
    fence; host s a step, start s, loss_frac within 0.0075 +- 0.002;
44. ``multiproc_udp``: 4 worker processes on the card, one UDP socket and
    CUDA context each, ranks from the TCP rendezvous: at 4096 elements (loss
    0.05, deadline 1 s) bitwise the ``HostRing``; at full width one step:
    every report written, the loss, the start-up s (import, CUDA context,
    kernel libraries, warm-up) and the step s of each rank;
45. ``multiproc_kill``: UDP, ``--kill-rank 1 --kill-step 1 --restart
    --step-sleep 3``, 8 steps of 1024 elements: the rank SIGKILLs itself,
    the survivors complete the step degraded and eject it, the respawned
    process resumes from step 0's checkpoint and is readmitted through
    PROBATION;
46. ``elastic``: gpt2-paper's 151,862,784 parameters on the card through
    ``train/elastic.py``, 4 shards -> gather -> 2 shards -> gather, both
    gathers bitwise the parameters, ms of each call three times;
47. ``seconds``: the script's wall clock, whole and by group of phases.

Then the ``{"kernels": [...]}`` line, and last the device line. Any error,
disagreement past the stated tolerance or missing launch exits non-zero.
Without CUDA, or without the repository around it, it prints no result and
exits 1.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
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
    marks = [time.perf_counter()]
    laps = {}

    def lap(name):
        marks.append(time.perf_counter())
        laps[name] = marks[-1] - marks[-2]

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
    lap("build_and_kernels")

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
        launches[strategy], _ = train_main_path(strategy, steps[strategy],
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
    lap("main_paths")

    # 26.-31. the pod axis and FSDP (ROADMAP A15)
    check_a15_shapes(dev, gen)
    a15_paths(dev, counters)
    check_a15_against_cpu(dev)
    lap("pod_fsdp")

    # 33.-36. tensor parallelism (ROADMAP A15b)
    check_tp_shapes(dev, gen)
    tp_paths(counters)
    check_tp_against_cpu(dev)
    lap("tp")

    # 38.-41. the host wire (ROADMAP A18, first half)
    wire_ring_phase(dev, counters)
    lap("wire_ring")
    wire_paths(counters)
    lap("wire_main_q_udp")
    check_wire_against_cpu(dev)
    lap("wire_check")

    # 43.-46. the multi-process peer runtime (A18, second half) and
    # elastic resharding
    multiproc_paths(dev, counters)
    elastic_phase(dev)
    lap("multiproc")

    # 21.-23. loss recovery through the launcher at full width; 24. the
    # budget's report; 25. card against CPU; 26. checkpoints and resume
    recovery_paths(counters)
    check_recovery_against_cpu(dev)
    checkpoint_phase(dev)
    lap("recovery_checkpoint")

    # 18., 19. the launcher with the control plane in the loop; 20. the
    # network simulator
    adaptive_runs(counters)
    run_netsim()
    lap("adaptive_netsim")

    # 15., 16. every ported strategy, and the participation policies, on one
    # full-width arena
    sync_strategies(dev, counters)
    lap("strategies")

    # 8., 17. the same trainer on the card and on the CPU, same params and
    # draws
    for strategy in ("optireduce", "optireduce_q", "optireduce_rounds",
                     "tar_rounds_q"):
        check_step_against_cpu(dev, strategy)
    lap("card_vs_cpu")

    # 9. where one step of each main path's time goes (21.: and with
    # error feedback under burst drops)
    for strategy in ("optireduce", "optireduce_q", "optireduce_rounds"):
        profile_step(dev, strategy)
    profile_step(dev, "optireduce", recovery="ef", pattern="burst")
    profile_step(dev, "optireduce", dp_mode="fsdp")
    profile_step(dev, "optireduce", tp=TP)
    lap("profiles")

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
    lap("thc_tta")
    emit({"phase": "seconds", "total": marks[-1] - marks[0],
          "by_group": laps})

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
                     hq_ref.ht_quant_bytes(rows, n, per_peer, per_peer),
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
           hq_ref.ht_quant_bytes(rows, BLOCK, PEER_BLOCKS, PEER_BLOCKS),
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


def train_argv(strategy: str, pattern: str = "tail",
               recovery: str = "none") -> list[str]:
    """The launcher's flags of a main path at full width."""
    return ["--arch", "gpt2-paper", "--dp", str(PEERS), "--strategy",
            strategy, "--drop-rate", "0.01", "--drop-pattern", pattern,
            "--recovery", recovery, "--seq-len", "128", "--global-batch",
            "8", "--optimizer", "adamw", "--device", "cuda", "--kernel-mode",
            "kernel", "--incast", str(ROUNDS_INCAST), "--log-every", "1"]


def train_main_path(strategy: str, steps: int, counters: dict, *,
                    pattern: str = "tail", recovery: str = "none",
                    phase: str = "train", extra=(),
                    loss_seen: bool = True) -> tuple[dict, list]:
    """One main path through the launcher at full width; returns each
    kernel's launches in this run alone, and the step records. Each step's
    loss_frac must be positive unless ``loss_seen`` is off (under FSDP it
    counts the small replicated bucket alone)."""
    import torch
    from repro_torch.launch import train as launch_train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    records = launch_train.run([*train_argv(strategy, pattern, recovery),
                                "--steps", str(steps), *extra])
    torch.cuda.synchronize()
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, rec in enumerate(records):
        row = {"phase": f"{phase}_step", "strategy": strategy, "step": i,
               "loss": rec["loss"], "loss_frac": rec["loss_frac"],
               "grad_norm": rec["grad_norm"], "step_ms": rec["step_s"] * 1e3}
        if recovery != "none":
            row.update(recovery=recovery, filled=rec["filled"],
                       peak_mem_bytes=peak)
        emit(row)
        if not (math.isfinite(rec["loss"]) and rec["loss_frac"] >= 0
                and (rec["loss_frac"] > 0 or not loss_seen)):
            fail(f"{strategy} step {i}: loss {rec['loss']} loss_frac "
                 f"{rec['loss_frac']}")
        if recovery != "none" and not rec["filled"] > 0:
            fail(f"{phase} step {i}: the stale cache filled "
                 f"{rec['filled']} entries")
    emit({"phase": phase, "strategy": strategy, "recovery": recovery,
          "drop_pattern": pattern, "arch": "gpt2-paper",
          "peers": PEERS, "flags": list(extra), "steps": steps,
          "peak_mem_bytes": peak,
          "launches": counts,
          "per_step": {k: v / steps for k, v in counts.items()}})
    return counts, records


class _Tee(io.TextIOBase):
    """Writes to every stream it holds (the console and a capture)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


class _StepWatch:
    """Wraps the launcher's ``build_train_step`` to see each step: the sync
    config its step function was built with, each counter's increase in
    that step alone, and, for the steps named, a ``torch.profiler`` record
    (read after the run, so its analysis is not in the step's time)."""

    def __init__(self, counters: dict, profile_steps=()):
        from repro_torch.core import tar
        self.counters = {**counters, "round_groups": (tar, "round_groups")}
        self.profile_steps = set(profile_steps)
        self.builds = []
        self.steps = []

    def _snapshot(self):
        return {k: getattr(mod, attr)
                for k, (mod, attr) in self.counters.items()}

    def wrap(self, build_train_step):
        import torch
        from torch.profiler import ProfilerActivity, profile

        def build(cfg, tc, *args, **kw):
            step_fn, opt = build_train_step(cfg, tc, *args, **kw)
            self.builds.append(tc.sync)

            def watched(*args, **kwargs):
                before = self._snapshot()
                prof = None
                if len(self.steps) in self.profile_steps:
                    torch.cuda.synchronize()
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                out = step_fn(*args, **kwargs)
                if prof is not None:
                    torch.cuda.synchronize()
                    prof.__exit__(None, None, None)
                after = self._snapshot()
                self.steps.append({
                    "sync": tc.sync, "prof": prof,
                    "counts": {k: after[k] - before[k] for k in after}})
                return out
            return watched, opt
        return build


ADAPTIVE_LINE = re.compile(r"^adaptive: use_hadamard=(True|False) "
                           r"incast=(\d+) .*\((step rebuilt|cached step "
                           r"reused)\)$")


def adaptive_run(phase: str, strategy: str, rate: float, steps: int,
                 counters: dict, extra=()) -> None:
    """Phases ``adaptive_codec`` and ``adaptive_rounds``: the launcher with
    ``--adaptive --trace --report`` at full width, every step held to the
    policy it ran under."""
    import torch
    from repro_torch import obs
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import ControlPlane, StepTelemetry

    out_dir = ROOT / "build" / "chip_smoke" / phase
    out_dir.mkdir(parents=True, exist_ok=True)
    report_path = out_dir / "report.json"
    trace_dir = out_dir / "trace"
    watch = _StepWatch(counters, profile_steps=(0, steps - 1))
    real = launch_train.build_train_step
    launch_train.build_train_step = watch.wrap(real)
    captured = io.StringIO()
    torch.cuda.synchronize()
    for mod, attr in watch.counters.values():
        setattr(mod, attr, 0)
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            records = launch_train.run([
                "--arch", "gpt2-paper", "--steps", str(steps), "--dp",
                str(PEERS), "--strategy", strategy, "--drop-rate", str(rate),
                "--drop-pattern", "tail", "--seq-len", "128",
                "--global-batch", "8", "--optimizer", "adamw", "--device",
                "cuda", "--kernel-mode", "kernel", "--log-every", "1",
                "--adaptive", "--trace", str(trace_dir), "--report",
                str(report_path), *extra])
    finally:
        launch_train.build_train_step = real
    torch.cuda.synchronize()

    with open(trace_dir / "trace_rank00.json") as f:
        payload = obs.validate_trace(json.load(f))
    step_spans = [e for e in payload["traceEvents"]
                  if e["ph"] == "X" and e["name"] == "step"]
    spans = {e["args"]["step"]: e["dur"] / 1e3 for e in step_spans}
    rotates_always = strategy != "optireduce"
    rounds = "rounds" in strategy
    policies = []
    for i, (rec, st) in enumerate(zip(records, watch.steps)):
        sync, c = st["sync"], st["counts"]
        busy = device_busy_ms(st["prof"]) if st["prof"] else None
        policies.append((sync.use_hadamard, sync.incast))
        want = {k: 0 for k in c}
        want.update(fwht=48 if (rotates_always or sync.use_hadamard) else 0,
                    masked_mean=24)
        if rounds:
            want.update(permutes=24 * 2 * (PEERS - 1),
                        round_groups=24 * 2 * math.ceil(
                            (PEERS - 1) / sync.incast))
        row = {"phase": f"{phase}_step", "step": i,
               "use_hadamard": sync.use_hadamard, "incast": sync.incast,
               "launches": c, "loss": rec["loss"],
               "loss_frac": rec["loss_frac"], "step_ms": rec["step_s"] * 1e3,
               # the step span's host ms beyond the step: logging, the
               # control plane, the report row and any rebuild
               "loop_host_ms_beyond_step": spans.get(i, math.nan)
               - rec["step_s"] * 1e3,
               "profiled": busy is not None, "device_busy_ms": busy}
        emit(row)
        if c != want:
            fail(f"{phase} step {i}: launches {c} under use_hadamard="
                 f"{sync.use_hadamard} incast={sync.incast}, expected {want}")
        # at drop 0.002 a step of 288 (peer, receiver) pairs may lose none
        if not (math.isfinite(rec["loss"]) and 0 <= rec["loss_frac"] < 0.1):
            fail(f"{phase} step {i}: loss {rec['loss']} loss_frac "
                 f"{rec['loss_frac']}")
    if len(watch.steps) != steps or len(records) != steps:
        fail(f"{phase}: {len(watch.steps)} steps seen, {len(records)} "
             f"records, expected {steps}")

    # every policy switch is one adaptive: line, every rebuild one
    # "(step rebuilt)", in order
    lines = [ADAPTIVE_LINE.match(ln)
             for ln in captured.getvalue().splitlines()
             if ln.startswith("adaptive:")]
    if not all(lines):
        fail(f"{phase}: malformed adaptive line in {captured.getvalue()!r}")
    printed = [(m.group(1) == "True", int(m.group(2))) for m in lines]
    switches = [b for a, b in zip(policies, policies[1:]) if a != b]
    rebuilt = sum(m.group(3) == "step rebuilt" for m in lines)
    if switches != printed[:len(switches)] or \
            len(printed) - len(switches) > 1:
        # the last line may switch after the last step
        fail(f"{phase}: policies by step {policies} against the adaptive "
             f"lines {printed}")
    if len(watch.builds) - 1 != rebuilt:
        fail(f"{phase}: {len(watch.builds) - 1} rebuilds, {rebuilt} "
             "'(step rebuilt)' lines")

    # the control plane alone, on the host: this run's telemetry replayed
    telemetry = [StepTelemetry(step=i, loss_frac=r["loss_frac"],
                               step_time=r["step_s"])
                 for i, r in enumerate(records)]
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        control = ControlPlane.create(n_nodes=PEERS)
        for t in telemetry:
            control.observe(t)
            control.apply(watch.builds[0])
    control_us = (time.perf_counter() - t0) / (reps * steps) * 1e6
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(trace_dir)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    with open(report_path) as f:
        report = json.load(f)
    summary = {"phase": phase, "strategy": strategy, "drop_rate": rate,
               "steps": steps, "policies": policies, "adaptive_lines":
               len(printed), "rebuilds": rebuilt,
               "cached_reuses": len(printed) - rebuilt,
               "trace_step_spans": len(step_spans),
               "control_plane_host_us_per_step": control_us,
               "trace_records": len(payload["traceEvents"]),
               "policy_events": sum(e.get("cat") == "policy"
                                    for e in payload["traceEvents"]),
               "obs_report_rc": proc.returncode,
               "report_rows": len(report["steps"])}
    emit(summary)
    print(proc.stdout, flush=True)
    if sorted(spans) != list(range(steps)) or len(step_spans) != steps \
            or proc.returncode != 0 or \
            len(report["steps"]) != steps:
        fail(f"{phase}: {summary}\n{proc.stderr}")


def adaptive_runs(counters: dict) -> None:
    adaptive_run("adaptive_codec", "optireduce", 0.002, 5, counters)
    adaptive_run("adaptive_rounds", "optireduce_rounds", 0.01, 6, counters,
                 extra=("--incast", str(ROUNDS_INCAST)))


# phase -> (strategy, recovery, steps, B1 launches a step, permutes a step)
RECOVERY_PATHS = {
    "recovery_main": ("optireduce", "ef", 4, 120, 0),
    "recovery_stale": ("optireduce", "stale", 3, 72, 0),
    "recovery_rounds": ("optireduce_rounds", "ef", 2, 120,
                        24 * 2 * (PEERS - 1)),
    "recovery_budget": ("optireduce", "ef+budget", 3, 120, 0),
}


def recovery_paths(counters: dict) -> None:
    """Phases ``recovery_main``, ``recovery_stale``, ``recovery_rounds`` and
    ``recovery_budget``: the launcher with ``--recovery`` under burst drops
    at 0.01, full width. Each step's launches are exact: the fill encodes
    the cache once a bucket (a (1, 6,553,600) row) besides the data's
    encode and decode, error feedback adds one encode and one decode of
    the (4, 6,553,600) stack, and the plain mean after the fill leaves B2
    unlaunched."""
    out_dir = ROOT / "build" / "chip_smoke" / "recovery_budget"
    out_dir.mkdir(parents=True, exist_ok=True)
    report_path = out_dir / "report.json"
    for phase, (strategy, mode, steps, b1, permutes) in \
            RECOVERY_PATHS.items():
        extra = ("--report", str(report_path)) if "budget" in mode else ()
        counts, _ = train_main_path(strategy, steps, counters,
                                    pattern="burst", recovery=mode,
                                    phase=phase, extra=extra)
        want = {k: 0 for k in counters}
        want.update(fwht=b1 * steps, permutes=permutes * steps)
        if counts != want:
            fail(f"{phase}: launch counts {counts} over {steps} steps, "
                 f"expected {want}")
        if "budget" not in mode:
            continue
        with open(report_path) as f:
            rows = json.load(f)["steps"]
        for row in rows:
            budget = row["budget"]
            emit({"phase": "recovery_budget_report", "step": row["step"],
                  "budget_phase": budget["phase"],
                  "loss_ema": budget["loss_ema"], "budget": budget["budget"],
                  "deadline_factor": budget["deadline_factor"]})
            if not all(math.isfinite(v) for v in budget.values()):
                fail(f"recovery_budget step {row['step']}: {budget}")
        if len(rows) != steps:
            fail(f"recovery_budget: {len(rows)} report rows, expected "
                 f"{steps}")


def check_recovery_against_cpu(dev) -> None:
    """Phase ``recovery_check``: 3 gpt2-smoke steps of ``--recovery ef``
    under burst drops at 0.05 on the card against the plain versions on
    the CPU, same parameters and draws. Metrics, parameters, both AdamW
    moments, the stale cache and the residuals within ``STEP_TOL`` (phase
    8's card-vs-CPU bound); the filled count exactly (the same masks)."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import recovery as recovery_lib
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.bucket_plan import BucketPlan
    from repro_torch.core.keys import fold_in, generator, key
    from repro_torch.core.pipeline import GeneratorDraws
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_leaves, tree_map

    runtime.set_kernel_mode(None)       # by device: card kernels, CPU plain
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(strategy="optireduce", drop_rate=0.05,
                            drop_pattern="burst", hadamard_block=256,
                            recovery="ef")
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=1e-2),
                     bucket_elems=16_384, seq_chunk=32)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    base = init_params(generator(k), cfg, device="cpu")
    plan = BucketPlan.for_tree(base, tc.bucket_elems)
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    fns, params, states, recs, metrics = {}, {}, {}, {}, {}
    for name, device in devices.items():
        fns[name], opt = build_train_step(cfg, tc, peers=PEERS,
                                          device=device)
        params[name] = tree_map(lambda p: p.clone().to(device), base)
        states[name] = opt.init(params[name])
        recs[name] = recovery_lib.init_state(
            recovery_lib.parse("ef"), plan.num_buckets, plan.bucket_elems,
            peers=PEERS, device=device)
        metrics[name] = []
    launched = fwht_ops.launches
    for step in range(3):
        for name, device in devices.items():
            draws = _HostDraws(GeneratorDraws(
                key=fold_in(fold_in(k, step), 7), cfg=sync,
                device=torch.device("cpu")), device)
            params[name], states[name], recs[name], m = fns[name](
                params[name], states[name], data.host_batch(step, 0, 1),
                step, k, draws=draws, rec_state=recs[name])
            metrics[name].append({n: float(v) for n, v in m.items()})
    launched = fwht_ops.launches - launched

    def worst(a, b):
        return max(float((x.detach().float() - y.detach().float().cpu())
                         .abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    diffs = {"metrics": max(abs(a[n] - b[n]) for a, b in zip(
        metrics["cpu"], metrics["cuda"]) for n in a if n != "filled"),
        "params": worst(params["cpu"], params["cuda"]),
        "adam_m": worst(states["cpu"].m, states["cuda"].m),
        "adam_v": worst(states["cpu"].v, states["cuda"].v),
        "stale": worst(recs["cpu"]["stale"], recs["cuda"]["stale"]),
        "ef": worst(recs["cpu"]["ef"], recs["cuda"]["ef"])}
    filled_equal = [a["filled"] == b["filled"] > 0
                    for a, b in zip(metrics["cpu"], metrics["cuda"])]
    emit({"phase": "recovery_check", "arch": cfg.name, "steps": 3,
          "recovery": "ef", "drop_pattern": "burst", "drop_rate": 0.05,
          "max_abs_diff": diffs, "tolerance": STEP_TOL,
          "filled_equal": filled_equal, "fwht_launches_on_card": launched,
          "cpu": metrics["cpu"], "gpu": metrics["cuda"]})
    # 8 buckets: 5 B1 launches a bucket a step on the card
    if not (all(v <= STEP_TOL for v in diffs.values()) and all(filled_equal)
            and launched == 3 * 8 * 5):
        fail(f"recovery card vs CPU: {diffs}, filled {filled_equal}, "
             f"{launched} B1 launches")


def checkpoint_phase(dev) -> None:
    """Phase ``checkpoint``: ``--recovery ef`` at full width under burst
    drops. ``--steps 2 --ckpt-dir T`` (its final save, labelled 2, holds
    bf16 parameters, AdamW's fp32 moments, the stale cache and the
    residuals); the files restored onto the card equal the state saved bit
    for bit; ``--resume --steps 4`` runs steps 2 and 3, whose loss and
    loss_frac must agree with two uninterrupted 4-step runs within the
    spread between those two."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.tree import tree_leaves, tree_map

    class Watched(ckpt_lib.AsyncCheckpointer):
        """Keeps a copy on the card of every tree it is asked to save."""
        made = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.saved = {}
            Watched.made.append(self)

        def save(self, step, tree, meta=None):
            self.saved[step] = tree_map(lambda t: t.detach().clone(), tree)
            super().save(step, tree, meta)

    argv = train_argv("optireduce", "burst", "ef")
    uninterrupted = [launch_train.run([*argv, "--steps", "4"])
                     for _ in range(2)]
    real = ckpt_lib.AsyncCheckpointer
    ckpt_lib.AsyncCheckpointer = Watched
    try:
        with tempfile.TemporaryDirectory() as tmp:
            free = shutil.disk_usage(tmp).free
            first = launch_train.run([*argv, "--steps", "2", "--ckpt-dir",
                                      tmp])
            saver = Watched.made[-1]
            saved = saver.saved.pop(2)
            step_dir = Path(tmp) / "step_00000002"
            on_disk = sum(f.stat().st_size for f in step_dir.iterdir())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, back, _ = ckpt_lib.restore(tmp, saved, device=dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            pairs = list(zip(tree_leaves(back), tree_leaves(saved)))
            bitwise = step == 2 and all(
                a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b) for a, b in pairs)

            def nbytes(tree):
                return sum(t.numel() * t.element_size()
                           for t in tree_leaves(tree))
            parts = {"params_bf16": nbytes(saved[0]),
                     "adamw_m_v_fp32": nbytes(saved[1]),
                     "stale_fp32": nbytes(saved[2]["stale"]),
                     "ef_fp32": nbytes(saved[2]["ef"])}
            del back, saved, pairs
            resumed = launch_train.run([*argv, "--steps", "4", "--resume",
                                        "--ckpt-dir", tmp])
            resume_saver = Watched.made[-1]
            resume_saver.saved.clear()
    finally:
        ckpt_lib.AsyncCheckpointer = real
    spread, off = {}, {}
    for k in ("loss", "loss_frac"):
        spread[k] = max(abs(a[k] - b[k]) for a, b in zip(
            uninterrupted[0][2:], uninterrupted[1][2:]))
        off[k] = max(abs(r[k] - u[k]) for run in uninterrupted
                     for r, u in zip(resumed, run[2:]))
    emit({"phase": "checkpoint", "arch": "gpt2-paper", "recovery": "ef",
          "label": 2, "bytes": parts, "bytes_total": sum(parts.values()),
          "bytes_on_disk": on_disk, "disk_free_bytes": free,
          "host_copy_s": saver.copy_s, "write_s": saver.write_s,
          "restore_s": restore_s, "bitwise": bitwise,
          "resume_host_copy_s": resume_saver.copy_s,
          "resume_write_s": resume_saver.write_s,
          "first": [(r["loss"], r["loss_frac"]) for r in first],
          "resumed": [(r["loss"], r["loss_frac"]) for r in resumed],
          "uninterrupted": [[(r["loss"], r["loss_frac"]) for r in run]
                            for run in uninterrupted],
          "run_to_run_spread": spread, "resumed_off_by": off})
    if not bitwise:
        fail("checkpoint: the restored leaves differ from the saved state")
    if len(first) != 2 or len(resumed) != 2:
        fail(f"checkpoint: {len(first)} steps, then {len(resumed)} resumed "
             "(expected 2 and 2: steps 2 and 3)")
    if any(off[k] > spread[k] for k in off):
        fail(f"checkpoint: the resumed steps are off by {off}, beyond the "
             f"run-to-run spread {spread}")


NETSIM_ENVS = ("local_1.5", "local_3.0", "cloudlab")
NETSIM_STRATEGIES = ("gloo_ring", "bcube", "nccl_ring", "nccl_tree",
                     "tar_tcp", "optireduce")
GRAD_BYTES = 124e6 * 4           # GPT-2 base fp32 gradients (bench_tta.py)
SIM_BUCKET = 25 * 2 ** 20
SIM_STEPS = 150


def run_netsim() -> None:
    """Phase ``netsim``: ``simulate_job`` at ``benchmarks/bench_tta.py``'s
    sizes. The milliseconds are the simulator's, not the card's."""
    from repro_torch.sim import NetworkModel, simulate_job

    buckets = math.ceil(GRAD_BYTES / SIM_BUCKET)
    res = {}
    for env in NETSIM_ENVS:
        for strategy in NETSIM_STRATEGIES:
            t0 = time.perf_counter()
            r = simulate_job(strategy, n_nodes=8, bucket_bytes=SIM_BUCKET,
                             n_steps=SIM_STEPS * buckets,
                             env=NetworkModel.environment(env, seed=11),
                             compute_ms=0.0, overlap=0.0)
            row = {"phase": "netsim", "env": env, "strategy": strategy,
                   "nodes": 8, "bucket_bytes": SIM_BUCKET,
                   "simulated_steps": SIM_STEPS * buckets,
                   "simulated_mean_ga_ms": r["mean_ga_ms"],
                   "simulated_p50_ga_ms": r["p50_ga_ms"],
                   "simulated_p99_ga_ms": r["p99_ga_ms"],
                   "mean_drop": r["mean_drop"],
                   "host_seconds": time.perf_counter() - t0}
            emit(row)
            res[env, strategy] = row
            if not all(math.isfinite(row[k]) for k in (
                    "simulated_mean_ga_ms", "simulated_p50_ga_ms",
                    "simulated_p99_ga_ms", "mean_drop")):
                fail(f"netsim: {row}")
    gap = {env: res[env, "gloo_ring"]["simulated_mean_ga_ms"]
           / res[env, "optireduce"]["simulated_mean_ga_ms"]
           for env in NETSIM_ENVS}
    emit({"phase": "netsim_summary", "gloo_ring_over_optireduce": gap,
          "host_seconds": sum(r["host_seconds"] for r in res.values())})
    if not 1.0 < gap["local_1.5"] < gap["local_3.0"]:
        fail(f"netsim: Gloo ring over OptiReduce {gap}")
    for env in NETSIM_ENVS:
        drop = res[env, "optireduce"]["mean_drop"]
        if not 0.0 < drop < 0.01:
            fail(f"netsim: optireduce mean drop {drop} in {env}")
        for strategy in NETSIM_STRATEGIES[:-1]:
            if res[env, strategy]["mean_drop"] != 0.0:
                fail(f"netsim: {strategy} dropped in {env}")


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


def profile_step(dev, strategy: str, *, recovery: str = "none",
                 pattern: str = "tail", dp_mode: str = "replicated",
                 tp: int = 1) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import recovery as recovery_lib
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.bucket_plan import BucketPlan
    from repro_torch.core.keys import generator, key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train.trainer import TrainConfig, build_train_step

    cfg = get_config("gpt2-paper")
    sync = OptiReduceConfig(strategy=strategy, drop_rate=0.01,
                            drop_pattern=pattern, hadamard_block=BLOCK,
                            incast=ROUNDS_INCAST, recovery=recovery)
    tc = TrainConfig(sync=sync, seq_chunk=128, dp_mode=dp_mode)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    k = key(0)
    params = init_params(generator(k, dev), cfg, device=dev, tp=tp)
    step_fn, opt = build_train_step(cfg, tc, make_host_mesh(PEERS, tp),
                                    device=dev)
    state = opt.init(params)
    plan = BucketPlan.for_tree(params, tc.bucket_elems)
    rec = recovery_lib.init_state(recovery_lib.parse(recovery),
                                  plan.num_buckets, plan.bucket_elems,
                                  peers=PEERS, device=dev) or None
    batches = [data.host_batch(s, 0, 1) for s in range(3)]

    def one(s):
        nonlocal params, state, rec
        if rec is None:
            params, state, m = step_fn(params, state, batches[s], s, k)
        else:
            params, state, rec, m = step_fn(params, state, batches[s], s, k,
                                            rec_state=rec)
        float(m["loss"])
    label = {"strategy": strategy, "arch": cfg.name, "peers": PEERS}
    if dp_mode != "replicated":
        label.update(dp_mode=dp_mode)
    if tp > 1:
        label.update(tp=tp)
    if recovery != "none":
        label.update(recovery=recovery, drop_pattern=pattern)
    profile_third_step(one, label)


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


# ------------------------------------------------- the pod axis and FSDP
# the FSDP reduce-scatter's sites at full width, (name, rows a peer's
# encode takes): blocks of 1024 of each site's (4, 4 * padded row) stack
A15_SITES = (("wq", 4 * 768 * 768 // 4 // BLOCK),
             ("w_gate", 4 * 768 * 3072 // 4 // BLOCK),
             ("embed", 4 * 9_650_176 // BLOCK))
EMBED_ROW = 9_650_176        # 192 x 50,257 = 9,649,344, padded to 1024s


def check_a15_shapes(dev, gen) -> None:
    """Phase ``a15_shapes``: B1-B5 at the shapes the FSDP reduce-scatter
    and the pod grid give them, against their plain versions, timed with
    their bounds (tolerances of 3.-5.)."""
    import torch
    from repro_torch.core import collectives
    from repro_torch.kernels.dequant_reduce import ops as dq_ops
    from repro_torch.kernels.dequant_reduce import ref as dq_ref
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.ht_quant import ops as hq_ops
    from repro_torch.kernels.ht_quant import ref as hq_ref
    from repro_torch.kernels.masked_sum import ops as mm_ops
    from repro_torch.kernels.masked_sum import ref as mm_ref

    def row(kernel, site, shape, err, ms, plain_ms, nbytes, flops, **kw):
        b_ms, b_by = bound(nbytes, flops)
        emit({"phase": "a15_shapes", "kernel": kernel, "site": site,
              "shape": list(shape), "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "share_of_bound": b_ms / ms, **kw})

    sign = torch.where(torch.rand((BLOCK,), generator=gen, device=dev) < 0.5,
                       1.0, -1.0)
    # B1: each site's encode over all 4 peers, the embedding's decode
    for site, rows in A15_SITES:
        x = torch.randn((PEERS, rows, BLOCK), generator=gen, device=dev)
        cases = [("pre", x)]
        if site == "embed":
            cases.append(("post", x[:, :rows // PEERS].contiguous()))
        for mode, xin in cases:
            rmode = "encode" if mode == "pre" else "decode"
            got = fwht_ops.fwht_launch(xin, sign, mode)
            want = fwht_ref.randomized_fwht_ref(xin, sign, mode=rmode)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not math.isfinite(err) or err > FWHT_TOL:
                fail(f"a15 fwht {site} {mode}: max abs err {err}")
            n_rows = xin.shape[0] * xin.shape[1]
            row("fwht", site, xin.shape, err,
                time_ms(lambda: fwht_ops.fwht_launch(xin, sign, mode),
                        reps=10),
                time_ms(lambda: fwht_ref.randomized_fwht_ref(
                    xin, sign, mode=rmode), reps=2, warmup=1),
                fwht_ref.fwht_bytes(n_rows, BLOCK),
                fwht_ref.fwht_flops(n_rows, BLOCK), mode=mode)
            del got, want
        del x, cases

    # B2: the reduce-scatter's all_to_all view of the embedding's rows, and
    # the pod grid's received stack (a copy: both pods in one launch)
    for site, shards in (("embed", torch.randn(
            (PEERS, PEERS * EMBED_ROW), generator=gen, device=dev).view(
                PEERS, PEERS, EMBED_ROW)),
            ("pod_bucket", torch.randn((2 * PEERS, PEERS, SHARD),
                                       generator=gen, device=dev))):
        grid = collectives.Grid(pods=1 if site == "embed" else 2)
        received = collectives.all_to_all(shards, grid)
        mask = (torch.rand(received.shape, generator=gen, device=dev)
                < 0.99).to(torch.float32)
        got = mm_ops.masked_mean_launch(received, mask)
        want = mm_ref.masked_mean_ref(received, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not math.isfinite(err) or err > MEAN_TOL:
            fail(f"a15 masked_mean {site}: max abs err {err}")
        r, n, length = received.shape
        row("masked_mean", site, received.shape, err,
            time_ms(lambda: mm_ops.masked_mean_launch(received, mask),
                    reps=10),
            time_ms(lambda: mm_ref.masked_mean_ref(received, mask), reps=2,
                    warmup=1),
            mm_ref.masked_mean_bytes(r, n, length),
            mm_ref.masked_mean_flops(r, n, length),
            strided=not received.is_contiguous())
        del shards, received, mask, got, want

    # B3, B4, B5: the 8-bit reduce-scatter of the embedding
    rows = A15_SITES[-1][1]
    x = torch.randn((PEERS, rows, BLOCK), generator=gen, device=dev)
    amax = hq_ops.ht_amax_launch(x, sign)
    want = hq_ref.ht_amax_ref(x, sign)
    torch.cuda.synchronize()
    err = float((amax - want).abs().max())
    if err != 0.0:
        fail(f"a15 ht_amax embed: max abs err {err}")
    row("ht_amax", "embed", x.shape, err,
        time_ms(lambda: hq_ops.ht_amax_launch(x, sign), reps=10),
        time_ms(lambda: hq_ref.ht_amax_ref(x, sign), reps=2, warmup=1),
        hq_ref.ht_amax_bytes(PEERS * rows, BLOCK),
        hq_ref.ht_amax_flops(PEERS * rows, BLOCK))
    shared = torch.clamp(amax.amax(0), min=1e-12)
    lo, step = -shared, 2.0 * shared / 255
    noise = torch.rand((rows, BLOCK), generator=gen, device=dev)
    codes = hq_ops.ht_quant_launch(x, sign, noise, lo, step, bits=8)
    want = hq_ref.ht_quant_ref(x, sign, noise, lo, step, bits=8)
    torch.cuda.synchronize()
    mismatched = int((codes != want).sum())
    if mismatched:
        fail(f"a15 ht_quant embed: {mismatched} codes differ")
    row("ht_quant", "embed", x.shape, 0.0,
        time_ms(lambda: hq_ops.ht_quant_launch(x, sign, noise, lo, step,
                                               bits=8), reps=10),
        time_ms(lambda: hq_ref.ht_quant_ref(x, sign, noise, lo, step,
                                            bits=8), reps=2, warmup=1),
        hq_ref.ht_quant_bytes(PEERS * rows, BLOCK, rows, rows),
        hq_ref.ht_quant_flops(PEERS * rows, BLOCK))
    del x, want, noise
    received = codes.view(PEERS, PEERS, EMBED_ROW).transpose(0, 1)
    lo_r, step_r = lo.view(PEERS, -1), step.view(PEERS, -1)
    mask = (torch.rand(received.shape, generator=gen, device=dev)
            < 0.99).to(torch.float32)
    got = dq_ops.dequant_mean_launch(received, lo_r, step_r, mask,
                                     block=BLOCK)
    want = dq_ref.dequant_masked_mean_ref(
        received, lo_r.repeat_interleave(BLOCK, dim=-1),
        step_r.repeat_interleave(BLOCK, dim=-1), mask)
    torch.cuda.synchronize()
    tol = DEQ_ULPS * 2.0 ** -23 * float(shared.max())
    err = float((got - want).abs().max())
    if not math.isfinite(err) or err > tol:
        fail(f"a15 dequant_mean embed: max abs err {err} > {tol}")
    del want
    row("dequant_mean", "embed", received.shape, err,
        time_ms(lambda: dq_ops.dequant_mean_launch(
            received, lo_r, step_r, mask, block=BLOCK), reps=10),
        time_ms(lambda: dq_ref.dequant_masked_mean_ref(
            received, lo_r.repeat_interleave(BLOCK, dim=-1),
            step_r.repeat_interleave(BLOCK, dim=-1), mask), reps=2,
            warmup=1),
        dq_ref.dequant_mean_bytes(PEERS, PEERS, EMBED_ROW, BLOCK,
                                  masked=True),
        dq_ref.dequant_mean_flops(PEERS, PEERS, EMBED_ROW, masked=True),
        tolerance=tol)
    del received, mask, got, codes


# per-step launches of the A15 paths at full width (see the docstring)
A15_PER_STEP = {
    "fsdp_main": {"fwht": 174, "masked_mean": 87},
    "fsdp_q": {"fwht": 88, "masked_mean": 1, "ht_amax": 86, "ht_quant": 86,
               "dequant_mean": 86},
    "pod_main": {"fwht": 48, "masked_mean": 24},
    "pod_q": {"fwht": 24, "ht_amax": 24, "ht_quant": 24, "dequant_mean": 24,
              "grid_quant": 24},
}


def trainer_path(dev, phase: str, tc, mesh, steps: int,
                 counters: dict) -> None:
    """A full-width gpt2-paper run through ``build_train_step`` (the paths
    with no launcher flag): per step loss, loss_frac, step ms; the launch
    counts of the whole run held to ``A15_PER_STEP``; on a pod grid every
    peer's synced arena equal after every sync."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.keys import generator, key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import trainer as trainer_mod

    cfg = get_config("gpt2-paper")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    k = key(0)
    params = init_params(generator(k, dev), cfg, device=dev)
    step_fn, opt = trainer_mod.build_train_step(cfg, tc, mesh, device=dev)
    state = opt.init(params)
    replicas = []
    sync_packed = trainer_mod.sync_packed

    def checked(arena, ctx, **kw):
        out = sync_packed(arena, ctx, **kw)
        replicas.append(all(torch.equal(out[p], out[0])
                            for p in range(1, out.shape[0])))
        return out
    trainer_mod.sync_packed = checked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    try:
        for s in range(steps):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state,
                                       data.host_batch(s, 0, 1), s, k)
            m = {n: float(v) for n, v in m.items()}
            emit({"phase": f"{phase}_step", "step": s, "loss": m["loss"],
                  "loss_frac": m["loss_frac"], "grad_norm": m["grad_norm"],
                  "step_ms": (time.perf_counter() - t0) * 1e3})
            if not (math.isfinite(m["loss"]) and
                    math.isfinite(m["grad_norm"])):
                fail(f"{phase} step {s}: {m}")
    finally:
        trainer_mod.sync_packed = sync_packed
    torch.cuda.synchronize()
    counts = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    want = {n: 0 for n in counters}
    want.update({n: v * steps for n, v in A15_PER_STEP[phase].items()})
    emit({"phase": phase, "arch": cfg.name, "mesh": mesh.shape,
          "dp_mode": tc.dp_mode, "pure_dp": tc.pure_dp,
          "strategy": tc.sync.strategy,
          "rs_wire_bits": tc.sync.rs_wire_bits, "steps": steps,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "syncs_with_equal_replicas": sum(replicas),
          "syncs": len(replicas), "launches": counts,
          "per_step": {n: v / steps for n, v in counts.items()}})
    if counts != want:
        fail(f"{phase}: launch counts {counts} over {steps} steps, "
             f"expected {want}")
    if not all(replicas):
        fail(f"{phase}: peers hold different synced arenas")


def a15_paths(dev, counters: dict) -> None:
    """Phases ``fsdp_main``, ``fsdp_q``, ``pod_main`` and ``pod_q``."""
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import TrainConfig

    counts, _ = train_main_path("optireduce", 4, counters,
                                phase="fsdp_main",
                                extra=("--dp-mode", "fsdp"), loss_seen=False)
    want = {n: 0 for n in counters}
    want.update({n: v * 4 for n, v in A15_PER_STEP["fsdp_main"].items()})
    if counts != want:
        fail(f"fsdp_main: launch counts {counts} over 4 steps, expected "
             f"{want}")

    def tc(strategy, **kw):
        return TrainConfig(sync=OptiReduceConfig(
            strategy=strategy, drop_rate=0.01, drop_pattern="tail",
            hadamard_block=BLOCK, rs_wire_bits=kw.pop("rs_wire_bits", 0)),
            seq_chunk=128, kernel_mode="kernel", **kw)
    trainer_path(dev, "fsdp_q", tc("optireduce", dp_mode="fsdp",
                                   rs_wire_bits=8),
                 make_host_mesh(PEERS), 2, counters)
    grid = make_host_mesh(PEERS, 2)
    trainer_path(dev, "pod_main", tc("optireduce_2d", pure_dp=True), grid,
                 3, counters)
    trainer_path(dev, "pod_q", tc("optireduce_q", pure_dp=True), grid, 2,
                 counters)
    from repro_torch.kernels import runtime
    runtime.set_kernel_mode(None)


def check_a15_against_cpu(dev) -> None:
    """Phases ``fsdp_check`` and ``pod_check``: gpt2-smoke on the card
    against the plain versions on the CPU, same parameters and draws (the
    bucket draws and the gather sites' draws, both made on the CPU):
    metrics, parameters and both AdamW moments within ``STEP_TOL``, the
    card's B1 and B2 launches exact."""
    # 16 gather sites (2 layers x 7, the embedding twice) of 2 B1 + 1 B2,
    # and the norms' bucket; the pod grid's 8 buckets of 2 B1 + 1 B2
    cpu_cases(dev, {
        "fsdp_check": ("optireduce", "fsdp", False, None, (PEERS,), 2,
                       (34, 17)),
        "fsdp_check_micro2": ("optireduce", "fsdp", False, 1, (PEERS,), 1,
                              (2 * 32 + 2, 2 * 16 + 1)),
        "pod_check": ("optireduce_2d", "replicated", True, None, (PEERS, 2),
                      2, (16, 8))})


def cpu_cases(dev, cases: dict, seq_parallel: bool = False) -> None:
    """gpt2-smoke steps on the card against the plain versions on the CPU
    for each case ``phase: (strategy, dp_mode, pure_dp, microbatch, mesh,
    steps, (B1, B2) launches a step)``: same parameters (at the mesh's tp
    degree unless ``pure_dp``) and draws, metrics, parameters and both
    AdamW moments within ``STEP_TOL``, the card's launches exact."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, generator, key
    from repro_torch.core.pipeline import GeneratorDraws
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.masked_sum import ops as mm_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_leaves, tree_map

    runtime.set_kernel_mode(None)       # by device: card kernels, CPU plain
    cfg = get_smoke("gpt2-paper")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    for phase, (strategy, mode, pure, micro, mesh, steps, per_step) in \
            cases.items():
        tp = 1 if pure or len(mesh) == 1 else mesh[1]
        base = init_params(generator(k), cfg, device="cpu", tp=tp)
        sync = OptiReduceConfig(strategy=strategy, drop_rate=0.05,
                                drop_pattern="tail", hadamard_block=256,
                                skip_threshold=0.9,
                                pod_axis="model" if pure else None)
        tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=1e-2),
                         bucket_elems=16_384, seq_chunk=32, dp_mode=mode,
                         pure_dp=pure, microbatch=micro,
                         seq_parallel=seq_parallel)
        devices = {"cpu": torch.device("cpu"), "cuda": dev}
        fns, params, states, metrics = {}, {}, {}, {}
        for name, device in devices.items():
            fns[name], opt = build_train_step(cfg, tc, make_host_mesh(*mesh),
                                              device=device)
            params[name] = tree_map(lambda p: p.clone().to(device), base)
            states[name] = opt.init(params[name])
            metrics[name] = []
        launched = (fwht_ops.launches, mm_ops.launches)
        for step in range(steps):
            for name, device in devices.items():
                cpu = torch.device("cpu")
                skey = fold_in(k, step)
                params[name], states[name], m = fns[name](
                    params[name], states[name], data.host_batch(step, 0, 1),
                    step, k,
                    draws=_HostDraws(GeneratorDraws(
                        key=fold_in(skey, 7), cfg=sync, device=cpu), device),
                    site_draws=_HostDraws(GeneratorDraws(
                        key=skey, cfg=sync, device=cpu), device))
                metrics[name].append({n: float(v) for n, v in m.items()})
        launched = (fwht_ops.launches - launched[0],
                    mm_ops.launches - launched[1])

        def worst(a, b):
            return max(float((x.detach().float() - y.detach().float().cpu())
                             .abs().max())
                       for x, y in zip(tree_leaves(a), tree_leaves(b)))

        diffs = {"metrics": max(abs(a[n] - b[n]) for a, b in zip(
            metrics["cpu"], metrics["cuda"]) for n in a),
            "params": worst(params["cpu"], params["cuda"]),
            "adam_m": worst(states["cpu"].m, states["cuda"].m),
            "adam_v": worst(states["cpu"].v, states["cuda"].v)}
        want = (per_step[0] * steps, per_step[1] * steps)
        emit({"phase": phase, "arch": cfg.name, "steps": steps,
              "strategy": strategy, "dp_mode": mode, "pure_dp": pure,
              "microbatch": micro, "mesh": list(mesh),
              "seq_parallel": seq_parallel,
              "max_abs_diff": diffs, "tolerance": STEP_TOL,
              "card_launches_b1_b2": list(launched),
              "cpu": metrics["cpu"], "gpu": metrics["cuda"]})
        if not (all(v <= STEP_TOL for v in diffs.values())
                and launched == want):
            fail(f"{phase}: card vs CPU {diffs}, launches {launched} "
                 f"(expected {want})")


# ------------------------------------------------ tensor parallelism (A15b)
TP = 2
# gpt2-paper's local leaves a tp rank at tp = 2: half the padded embedding
# (50,258 / 2 x 768), 12 layers x 4,718,592, 19,200 of norms
TP_LOCAL = 19_299_072 + 12 * 4_718_592 + 19_200
TP_BUCKETS = -(-TP_LOCAL // BUCKET)                       # 12
# per-step launches of the tensor-parallel paths (see the docstring)
TP_PER_STEP = {
    "tp_main": {"fwht": 2 * TP_BUCKETS, "masked_mean": TP_BUCKETS},
    "tp_q": {"fwht": TP_BUCKETS, "ht_amax": TP_BUCKETS,
             "ht_quant": TP_BUCKETS, "dequant_mean": TP_BUCKETS,
             "grid_quant": TP_BUCKETS},
    "tp_fsdp": {"fwht": 174, "masked_mean": 87},
    "tp_prod": {"fwht": 2, "masked_mean": 1},
}


def tp_paths(counters: dict) -> None:
    """Phases ``tp_main``, ``tp_q``, ``tp_fsdp`` (the launcher at full width
    with ``--tp 2`` beside the 4 data peers, 4 steps each) and ``tp_prod``
    (``--production-mesh --smoke --global-batch 16``, 2 steps): launches
    held exactly to ``TP_PER_STEP``."""
    runs = (("tp_main", "optireduce", 4, ("--tp", str(TP))),
            ("tp_q", "optireduce_q", 4, ("--tp", str(TP))),
            ("tp_fsdp", "optireduce", 4, ("--tp", str(TP), "--dp-mode",
                                          "fsdp")),
            ("tp_prod", "optireduce", 2, ("--production-mesh", "--smoke",
                                          "--global-batch", "16")))
    for phase, strategy, steps, extra in runs:
        counts, _ = train_main_path(strategy, steps, counters, phase=phase,
                                    extra=extra,
                                    loss_seen=phase != "tp_fsdp")
        want = {n: 0 for n in counters}
        want.update({n: v * steps for n, v in TP_PER_STEP[phase].items()})
        if counts != want:
            fail(f"{phase}: launch counts {counts} over {steps} steps, "
                 f"expected {want}")


def check_tp_against_cpu(dev) -> None:
    """Phase ``tp_check``: gpt2-smoke at ``(data 2, model 2)`` on the card
    against the CPU, replicated, FSDP x TP and under ``seq_parallel``, 2
    steps each, as ``fsdp_check``. gpt2-smoke's local leaves at tp = 2 are
    57,664 entries, 4 buckets of 16,384 (2 B1 + 1 B2 each); FSDP x TP has
    the 16 gather sites and the norms' bucket of ``fsdp_check``."""
    cpu_cases(dev, {
        "tp_check": ("optireduce", "replicated", False, None, (2, TP), 2,
                     (8, 4)),
        "tp_check_fsdp": ("optireduce", "fsdp", False, None, (2, TP), 2,
                          (34, 17))})
    cpu_cases(dev, {"tp_check_sp": ("optireduce", "replicated", False, None,
                                    (2, TP), 2, (8, 4))}, seq_parallel=True)


def check_tp_shapes(dev, gen) -> None:
    """Phase ``tp_shapes``: B1-B6 at the shapes the ``(data 4, model 2)``
    grid gives them, against their plain versions (tolerances of 3.-5.:
    B3, B4, B6 bitwise), timed with their bounds: one bucket of the
    ``(8, 12, 6,553,600)`` arena, its 8 peers (both tp groups) in one
    launch: B1's encode on the strided arena slice and its decode on the
    gathered copy, B2 on the tp grid's all_to_all copy, B3 and B4 (one set
    of grids a tp group), B5 on the codes' all_to_all copy with each
    receiver's group grids, B6 on the reduced shards."""
    import torch
    from repro_torch.core import collectives
    from repro_torch.kernels.dequant_reduce import ops as dq_ops
    from repro_torch.kernels.dequant_reduce import ref as dq_ref
    from repro_torch.kernels.fwht import ops as fwht_ops
    from repro_torch.kernels.fwht import ref as fwht_ref
    from repro_torch.kernels.ht_quant import ops as hq_ops
    from repro_torch.kernels.ht_quant import ref as hq_ref
    from repro_torch.kernels.masked_sum import ops as mm_ops
    from repro_torch.kernels.masked_sum import ref as mm_ref
    from repro_torch.kernels.quant import ops as gq_ops
    from repro_torch.kernels.quant import ref as gq_ref

    p = TP * PEERS

    def row(kernel, what, shape, err, fn, plain, nbytes, flops, **kw):
        ms = time_ms(fn, reps=10)
        plain_ms = time_ms(plain, reps=2, warmup=1)
        b_ms, b_by = bound(nbytes, flops)
        emit({"phase": "tp_shapes", "kernel": kernel, "what": what,
              "shape": list(shape), "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "share_of_bound": b_ms / ms, **kw})

    def check(name, err, tol):
        if not math.isfinite(err) or err > tol:
            fail(f"tp_shapes {name}: max abs err {err} > {tol}")

    sign = torch.where(torch.rand((BLOCK,), generator=gen, device=dev) < 0.5,
                       1.0, -1.0)
    arena = torch.randn((p, 2, BUCKET), generator=gen, device=dev)
    x = arena[:, 1].view(p, PEER_BLOCKS, BLOCK)          # strided slice
    rows = p * PEER_BLOCKS
    # B1 encode, then the stage-2 gather's copy and its decode
    got = fwht_ops.fwht_launch(x, sign, "pre")
    want = fwht_ref.randomized_fwht_ref(x, sign, mode="encode")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check("fwht encode", err, FWHT_TOL)
    row("fwht", "encode", x.shape, err,
        lambda: fwht_ops.fwht_launch(x, sign, "pre"),
        lambda: fwht_ref.randomized_fwht_ref(x, sign, mode="encode"),
        fwht_ref.fwht_bytes(rows, BLOCK), fwht_ref.fwht_flops(rows, BLOCK))
    shards = got.view(p, PEERS, SHARD)
    gathered = collectives.all_gather(shards[:, 0],
                                      collectives.Grid(tp=TP)).view(p, PEER_BLOCKS, BLOCK)
    got = fwht_ops.fwht_launch(gathered, sign, "post")
    want = fwht_ref.randomized_fwht_ref(gathered, sign, mode="decode")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check("fwht decode", err, FWHT_TOL)
    row("fwht", "decode", gathered.shape, err,
        lambda: fwht_ops.fwht_launch(gathered, sign, "post"),
        lambda: fwht_ref.randomized_fwht_ref(gathered, sign, mode="decode"),
        fwht_ref.fwht_bytes(rows, BLOCK), fwht_ref.fwht_flops(rows, BLOCK))
    del got, want, gathered
    # B2 on the tp grid's received stack
    received = collectives.all_to_all(shards, collectives.Grid(tp=TP))
    mask = (torch.rand(received.shape, generator=gen, device=dev)
            < 0.99).to(torch.float32)
    got = mm_ops.masked_mean_launch(received, mask)
    want = mm_ref.masked_mean_ref(received, mask)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check("masked_mean", err, MEAN_TOL)
    row("masked_mean", "stage-1 reduce", received.shape, err,
        lambda: mm_ops.masked_mean_launch(received, mask),
        lambda: mm_ref.masked_mean_ref(received, mask),
        mm_ref.masked_mean_bytes(p, PEERS, SHARD),
        mm_ref.masked_mean_flops(p, PEERS, SHARD))
    del shards, received, got, want
    # B3, then B4 on each tp group's grids
    amax = hq_ops.ht_amax_launch(x, sign)
    want = hq_ref.ht_amax_ref(x, sign)
    torch.cuda.synchronize()
    err = float((amax - want).abs().max())
    check("ht_amax", err, 0.0)
    row("ht_amax", "encode amax", x.shape, err,
        lambda: hq_ops.ht_amax_launch(x, sign),
        lambda: hq_ref.ht_amax_ref(x, sign),
        hq_ref.ht_amax_bytes(rows, BLOCK), hq_ref.ht_amax_flops(rows, BLOCK))
    shared = torch.clamp(amax.view(TP, PEERS, PEER_BLOCKS).amax(1),
                         min=1e-12)                       # (T, blocks)
    lo = -shared
    step = 2.0 * shared / torch.full_like(shared, 255.0)
    noise = torch.rand((PEER_BLOCKS, BLOCK), generator=gen, device=dev)
    codes = hq_ops.ht_quant_launch(x, sign, noise, lo, step, bits=8)
    want = hq_ref.ht_quant_ref(x, sign, noise, lo, step, bits=8)
    torch.cuda.synchronize()
    mismatched = int((codes != want).sum())
    if mismatched:
        fail(f"tp_shapes ht_quant: {mismatched} codes differ")
    row("ht_quant", "encode codes, grids a tp group", x.shape, 0.0,
        lambda: hq_ops.ht_quant_launch(x, sign, noise, lo, step, bits=8),
        lambda: hq_ref.ht_quant_ref(x, sign, noise, lo, step, bits=8),
        hq_ref.ht_quant_bytes(rows, BLOCK, PEER_BLOCKS,
                              TP * PEER_BLOCKS),
        hq_ref.ht_quant_flops(rows, BLOCK))
    del want, amax, arena, x
    # B5: each receiver reads its tp group's grids for its shard
    received = collectives.all_to_all(codes.view(p, PEERS, SHARD),
                                      collectives.Grid(tp=TP))
    nblk = SHARD // BLOCK
    shard_of = torch.arange(p, device=dev) % PEERS
    group_of = torch.arange(p, device=dev) // PEERS
    lo_r = lo.view(TP, PEERS, nblk)[group_of, shard_of]     # (P, nblk)
    step_r = step.view(TP, PEERS, nblk)[group_of, shard_of]
    mask = (torch.rand(received.shape, generator=gen, device=dev)
            < 0.99).to(torch.float32)
    got = dq_ops.dequant_mean_launch(received, lo_r, step_r, mask,
                                     block=BLOCK)
    want = dq_ref.dequant_masked_mean_ref(
        received, lo_r.repeat_interleave(BLOCK, dim=-1),
        step_r.repeat_interleave(BLOCK, dim=-1), mask)
    torch.cuda.synchronize()
    tol = DEQ_ULPS * 2.0 ** -23 * float(shared.max())
    err = float((got - want).abs().max())
    check("dequant_mean", err, tol)
    row("dequant_mean", "stage-1 dequant + reduce", received.shape, err,
        lambda: dq_ops.dequant_mean_launch(received, lo_r, step_r, mask,
                                           block=BLOCK),
        lambda: dq_ref.dequant_masked_mean_ref(
            received, lo_r.repeat_interleave(BLOCK, dim=-1),
            step_r.repeat_interleave(BLOCK, dim=-1), mask),
        dq_ref.dequant_mean_bytes(p, PEERS, SHARD, BLOCK, masked=True),
        dq_ref.dequant_mean_flops(p, PEERS, SHARD, masked=True),
        tolerance=tol)
    del received, mask, want, codes
    # B6: the reduced shards onto their receivers' grids
    own = got.reshape(-1, BLOCK)
    noise2 = torch.rand((nblk, BLOCK), generator=gen, device=dev)
    codes2 = gq_ops.grid_quant_launch(own, noise2, lo_r.reshape(-1),
                                      step_r.reshape(-1), bits=8)
    want = gq_ref.grid_quant_ref(own, noise2, lo_r.reshape(-1),
                                 step_r.reshape(-1), bits=8)
    torch.cuda.synchronize()
    mismatched = int((codes2 != want).sum())
    if mismatched:
        fail(f"tp_shapes grid_quant: {mismatched} codes differ")
    n_rows = own.shape[0]
    row("grid_quant", "stage-2 codes", own.shape, 0.0,
        lambda: gq_ops.grid_quant_launch(own, noise2, lo_r.reshape(-1),
                                         step_r.reshape(-1), bits=8),
        lambda: gq_ref.grid_quant_ref(own, noise2, lo_r.reshape(-1),
                                      step_r.reshape(-1), bits=8),
        gq_ref.grid_quant_bytes(n_rows, BLOCK, nblk, n_rows),
        gq_ref.grid_quant_flops(n_rows, BLOCK))
    del own, noise2, codes2, want, got


# the port's kernel functions, as the profiler names them
# ------------------------------------------------- the host wire (A18)
WIRE_PER_BUCKET = {
    # the lossy path's launches: the wire's mask is never None, so every
    # bucket's compensated mean is a B2 (or B5) launch
    "wire_main": ("optireduce", 2, {"fwht": 2, "masked_mean": 1}),
    "wire_q": ("optireduce_q", 1, {"fwht": 1, "ht_amax": 1, "ht_quant": 1,
                                   "dequant_mean": 1, "grid_quant": 1}),
    "wire_udp": ("optireduce", 1, {"fwht": 2, "masked_mean": 1}),
}
# the launcher's wire phases run gpt2-paper at full width with its depth
# cut to 4 of 12 layers: 12 buckets of 6,553,600 a step instead of 24 (a
# wire step is host Python, ~2.2 s a bucket)
WIRE_LAYERS = 4
WIRE_UDP_DEADLINE = "0.02"     # s a round: bounds the wait on lost packets
KIND_NAMES = {1: "data1", 2: "data2", 3: "ctrl", 4: "relay"}


class _WireStats:
    """Counts what crosses a HostRing: datagrams and bytes of each kind
    (wrapping its backend's ``send``), the bridge's device-to-host and
    host-to-device bytes and the host seconds its calls held the training
    thread; and the UDP receive buffer a socket really got."""

    def __init__(self):
        import threading
        self.lock = threading.Lock()
        self.rings = []
        self.rcvbuf = None
        self.reset()

    def reset(self):
        self.datagrams = {k: 0 for k in KIND_NAMES.values()}
        self.bytes = {k: 0 for k in KIND_NAMES.values()}
        self.d2h = self.h2d = self.calls = 0
        self.bridge_s = 0.0

    def snapshot(self) -> dict:
        return {"datagrams": dict(self.datagrams), "bytes": dict(self.bytes),
                "bridge_calls": self.calls, "d2h_bytes": self.d2h,
                "h2d_bytes": self.h2d, "bridge_host_s": self.bridge_s}

    def watch(self, ring):
        import socket
        from repro_torch.net import UdpBackend
        self.rings.append(ring)
        be = ring.backend
        send = be.send

        def counted(src, dst, dgram):
            kind = KIND_NAMES.get(dgram[1], "relay")
            with self.lock:
                self.datagrams[kind] += 1
                self.bytes[kind] += len(dgram)
            send(src, dst, dgram)
        be.send = counted
        if isinstance(be, UdpBackend):
            self.rcvbuf = be._socks[0].getsockopt(socket.SOL_SOCKET,
                                                  socket.SO_RCVBUF)
        exchange = ring.bridge_exchange

        def bridged(shards):
            t0 = time.perf_counter()
            out = exchange(shards)
            self.bridge_s += time.perf_counter() - t0
            self.calls += 1
            self.d2h += shards.numel() * shards.element_size()
            self.h2d += out.numel() * out.element_size()
            return out
        ring.bridge_exchange = bridged
        return ring


def rmem_max():
    try:
        with open("/proc/sys/net/core/rmem_max") as f:
            return int(f.read())
    except OSError:
        return "not readable"


def wire_ring_phase(dev, counters: dict) -> None:
    """Phase ``wire_ring``: one full-width bucket, (4, 6,553,600) fp32,
    through ``HostRing.allreduce`` over inproc, each peer's stage functions
    on the card, the wire scripted to lose exactly the packets of the
    engine's tail masks at 0.01. Bitwise ``sync_packed`` under ``Lossy``
    on the same draws; launches 8 B1 + 4 B2 (optireduce), 4 each of B1,
    B3-B6 (optireduce_q): one a peer, each on a one-row stack."""
    import torch
    from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
    from repro_torch.core.keys import key
    from repro_torch.core.pipeline import GeneratorDraws, SyncContext
    from repro_torch.net import HostRing, InprocBackend, mask_scripted_drops

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    x = torch.randn((PEERS, BUCKET), generator=gen, device=dev)
    none = {k: 0 for k in counters}
    want_counts = {
        "optireduce": {**none, "fwht": 8, "masked_mean": 4},
        "optireduce_q": {**none, "fwht": 4, "ht_amax": 4, "ht_quant": 4,
                         "dequant_mean": 4, "grid_quant": 4}}
    for strategy, want_c in want_counts.items():
        cfg = OptiReduceConfig(strategy=strategy, drop_rate=0.01,
                               hadamard_block=BLOCK)
        draws = GeneratorDraws(key(0), cfg, dev)
        ctx = SyncContext(cfg=cfg, draws=draws)
        want = sync_packed(x[:, None], ctx)[:, 0]
        lossy_frac = float(ctx.loss_fraction())
        masks = {r: draws.mask(0, r, PEERS, SHARD).cpu().numpy()
                 for r in range(PEERS)}
        stats = _WireStats()
        ring = stats.watch(HostRing(PEERS, cfg, backend=InprocBackend(
            PEERS, drop_fn=mask_scripted_drops(masks, cfg.packet_elems)),
            device=dev))
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out, tel = ring.allreduce(x, draws)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        counts = {n: getattr(mod, attr) for n, (mod, attr) in
                  counters.items()}
        ring.close()
        bitwise = bool(torch.equal(out, want))
        emit({"phase": "wire_ring", "strategy": strategy,
              "shape": [PEERS, BUCKET], "backend": "inproc",
              "bitwise_equal_sync_packed": bitwise,
              "loss_frac": tel.loss_frac, "lossy_loss_frac": lossy_frac,
              "host_s": host_s, "launches": counts,
              "sent": ring.backend.sent, "dropped": ring.backend.dropped,
              **stats.snapshot(),
              "peer_stage_times": list(tel.peer_stage_times)})
        if not bitwise:
            err = float((out - want).abs().max())
            fail(f"wire_ring {strategy}: not bitwise sync_packed (max abs "
                 f"diff {err})")
        if abs(tel.loss_frac - lossy_frac) > 1e-7:
            fail(f"wire_ring {strategy}: loss_frac {tel.loss_frac} vs "
                 f"{lossy_frac}")
        if counts != want_c:
            fail(f"wire_ring {strategy}: launches {counts}, expected "
                 f"{want_c}")
        del out, want, masks


@contextlib.contextmanager
def _watched_launcher(stats: _WireStats):
    """The launcher with its HostRing counted and a snapshot of the counts
    taken at every step's end (after the step's exchanges landed)."""
    from repro_torch.launch import train as launch_train
    ring_cls, step_end = launch_train.HostRing, launch_train._wire_step_end
    steps = []

    def make_ring(*args, **kw):
        return stats.watch(ring_cls(*args, **kw))

    def end(ring, transport, step, m):
        wire_t = step_end(ring, transport, step, m)
        steps.append({**stats.snapshot(), "wire_t": wire_t})
        stats.reset()
        return wire_t
    launch_train.HostRing, launch_train._wire_step_end = make_ring, end
    try:
        yield steps
    finally:
        launch_train.HostRing = ring_cls
        launch_train._wire_step_end = step_end


def wire_paths(counters: dict) -> None:
    """Phases ``wire_main``, ``wire_q`` and ``wire_udp``: the launcher on
    gpt2-paper at full width with ``--transport inproc`` (``--drop-rate
    0.01`` becomes i.i.d. wire loss of stage-1 packets) and ``--transport
    udp --rendezvous auto`` (real localhost sockets; a short
    ``--wire-deadline`` bounds the wait on what the receive buffers lost).
    Launches exact, as on the lossy path; no bridge miss or worker error;
    one ``wire[...]`` line a step with 4 peers. The inproc wire's
    ``loss_frac`` must sit at 0.0075 +- 0.002 (0.01 x 3/4: a receiver's own
    row never crosses the wire); UDP's is recorded with the kernel's
    ``rmem_max``, the socket's effective ``SO_RCVBUF`` and the steps the
    0.10 guard skipped. ``wire_main``'s last step runs under
    ``torch.profiler`` (phase ``profile``, ``"transport": "inproc"``): a
    wire step is ~50 s of host time, so it is profiled in this run rather
    than in three more steps of its own. The model is gpt2-paper cut to
    ``WIRE_LAYERS`` layers (width, buckets and per-bucket work unchanged);
    launches are exact for its bucket count."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import count_params

    cfg = dataclasses.replace(get_config("gpt2-paper"), n_layers=WIRE_LAYERS)
    buckets = -(-count_params(cfg) // BUCKET)
    for phase, (strategy, steps, per_bucket) in WIRE_PER_BUCKET.items():
        udp = phase == "wire_udp"
        extra = (("--transport", "udp", "--rendezvous", "auto",
                  "--wire-deadline", WIRE_UDP_DEADLINE) if udp
                 else ("--transport", "inproc"))
        stats = _WireStats()
        out = io.StringIO()
        watch = _StepWatch(counters, profile_steps=(
            (steps - 1,) if phase == "wire_main" else ()))
        build = launch_train.build_train_step
        launch_train.build_train_step = watch.wrap(build)
        full_config = launch_train.get_config
        launch_train.get_config = lambda name: cfg
        try:
            with _watched_launcher(stats) as step_stats, \
                    contextlib.redirect_stdout(_Tee(sys.stdout, out)):
                counts, records = train_main_path(strategy, steps, counters,
                                                  phase=phase, extra=extra)
        finally:
            launch_train.build_train_step = build
            launch_train.get_config = full_config
        prof = watch.steps[-1]["prof"]
        if prof is not None:
            emit_profile(prof, {"strategy": strategy, "arch": "gpt2-paper",
                                "layers": WIRE_LAYERS, "buckets": buckets,
                                "peers": PEERS, "transport": "inproc"},
                         records[-2]["step_s"] * 1e3,
                         records[-1]["step_s"] * 1e3,
                         torch.cuda.max_memory_allocated(), 0)
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("wire[")]
        ring = stats.rings[0]
        want = {k: 0 for k in counters}
        want.update({k: v * buckets * steps for k, v in per_bucket.items()})
        for i, (rec, st) in enumerate(zip(records, step_stats)):
            tel = st.pop("wire_t")
            emit({"phase": f"{phase}_wire_step", "step": i,
                  "step_ms": rec["step_s"] * 1e3,
                  "flush_ms": rec["wire_flush_s"] * 1e3,
                  "engine_loss_frac": rec["loss_frac"],
                  "wire_loss_frac": rec["wire_loss_frac"],
                  "skipped": rec["skipped"],
                  "peer_stage_times": list(tel.peer_stage_times or ()),
                  "rounds_timed_out": sum(tel.round_timed_out),
                  "rounds": len(tel.round_timed_out), **st})
        summary = {"phase": phase, "strategy": strategy, "steps": steps,
                   "layers": WIRE_LAYERS, "buckets": buckets,
                   "transport": "udp" if udp else "inproc",
                   "bridge_misses": ring.bridge_misses,
                   "bridge_timeout_s": ring.bridge_timeout,
                   "wire_lines": len(lines), "launches": counts,
                   "skipped_steps": sum(r["skipped"] > 0 for r in records),
                   "wire_loss_frac": [r["wire_loss_frac"] for r in records]}
        if udp:
            summary.update(rmem_max=rmem_max(), so_rcvbuf=stats.rcvbuf,
                           so_rcvbuf_requested=1 << 22,
                           rendezvous=any(ln.startswith("rendezvous:")
                                          for ln in out.getvalue()
                                          .splitlines()))
        emit(summary)
        if counts != want:
            fail(f"{phase}: launch counts {counts} over {steps} steps, "
                 f"expected {want}")
        if ring.bridge_misses or any(r["wire_error"] for r in records):
            fail(f"{phase}: {ring.bridge_misses} bridge misses, errors "
                 f"{[r['wire_error'] for r in records]}")
        if len(lines) != steps or not all("peers=4 " in ln for ln in lines):
            fail(f"{phase}: wire lines {lines}")
        if udp and not summary["rendezvous"]:
            fail("wire_udp: no rendezvous line")
        if not udp and not all(abs(r["wire_loss_frac"] - 0.0075) <= 0.002
                               for r in records):
            fail(f"{phase}: wire loss_frac {summary['wire_loss_frac']} "
                 "outside 0.0075 +- 0.002")


def check_wire_against_cpu(dev) -> None:
    """Phase ``wire_check``: 2 gpt2-smoke steps of ``optireduce`` over the
    inproc wire (i.i.d. wire loss 0.05) on the card against the CPU, same
    parameters and draws: metrics and parameters within ``STEP_TOL``, and
    every mask the bridge handed the engine equal on both (the wire's
    drops hash the packet headers, not the values); then 2 steps of the
    launcher over UDP on gpt2-smoke on the card: observed loss at most
    0.05 + 0.02 and no step skipped."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, generator, key
    from repro_torch.core.pipeline import GeneratorDraws, WireTransport
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import runtime
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.net import HostRing, bernoulli_drops
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_leaves, tree_map

    runtime.set_kernel_mode(None)       # by device: card kernels, CPU plain
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(strategy="optireduce", hadamard_block=256)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    base = init_params(generator(k), cfg, device="cpu")
    runs = {}
    for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        ring = HostRing(PEERS, sync, drop_fn=bernoulli_drops(0.05, seed=0),
                        device=device)
        masks = []
        exchange = ring.bridge_exchange

        def recorded(shards, exchange=exchange, masks=masks):
            out = exchange(shards)
            masks.append(out.cpu())
            return out
        tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=1e-2),
                         bucket_elems=16_384, seq_chunk=32,
                         transport_override=WireTransport(recorded))
        fn, opt = build_train_step(cfg, tc, peers=PEERS, device=device)
        params = tree_map(lambda p: p.clone().to(device), base)
        state = opt.init(params)
        metrics = []
        for step in range(2):
            draws = _HostDraws(GeneratorDraws(
                key=fold_in(fold_in(k, step), 7), cfg=sync,
                device=torch.device("cpu")), device)
            params, state, m = fn(params, state, data.host_batch(step, 0, 1),
                                  step, k, draws=draws)
            metrics.append({n: float(v) for n, v in m.items()})
            ring.flush()
        runs[name] = (metrics, params, masks, ring.bridge_misses)
        ring.close()
    (mc, pc, kc, _), (mg, pg, kg, misses) = runs["cpu"], runs["cuda"]
    worst = max(abs(a[n] - b[n]) for a, b in zip(mc, mg) for n in a)
    p_err = max(float((a.detach() - b.detach().cpu()).abs().max())
                for a, b in zip(tree_leaves(pc), tree_leaves(pg)))
    same_masks = len(kc) == len(kg) and all(torch.equal(a, b)
                                            for a, b in zip(kc, kg))
    emit({"phase": "wire_check", "transport": "inproc", "arch": cfg.name,
          "steps": 2, "bucket_exchanges": len(kg),
          "metrics_max_abs_diff": worst, "params_max_abs_diff": p_err,
          "tolerance": STEP_TOL, "masks_equal": same_masks,
          "bridge_misses": misses, "cpu": mc, "gpu": mg})
    if not (worst <= STEP_TOL and p_err <= STEP_TOL and same_masks
            and misses == 0 and mc[1]["loss_frac"] > 0):
        fail(f"wire_check: metrics {worst}, params {p_err}, masks equal "
             f"{same_masks}, misses {misses}, {mc} vs {mg}")
    records = launch_train.run(["--smoke", "--device", "cuda", "--steps",
                                "2", "--seq-len", "32", "--transport", "udp",
                                "--drop-rate", "0.05", "--wire-deadline",
                                "0.05", "--log-every", "1"])
    emit({"phase": "wire_check", "transport": "udp", "arch": cfg.name,
          "wire_loss_frac": [r["wire_loss_frac"] for r in records],
          "skipped": [r["skipped"] for r in records],
          "bridge_misses": [r["wire_misses"] for r in records]})
    if not all(r["wire_loss_frac"] <= 0.07 and r["skipped"] == 0
               and r["wire_misses"] == 0 and r["wire_error"] == 0
               for r in records):
        fail(f"wire_check udp: {records}")


# ---------------------------------- the multi-process peer runtime (A18)
# one gpt2-paper bucket a rank, as the launcher packs it
MP_FULL = ("--nprocs", str(PEERS), "--elems", str(BUCKET),
           "--hadamard-block", str(BLOCK), "--packet-elems", "256")
MP_STEPS = 2
MP_RATE = 0.01                 # i.i.d. wire loss of every datagram
MP_DROP = ("--drop-rate", str(MP_RATE), "--drop-seed", "3")
# a step's launches over the 4 ranks (one row each); the warm-up before
# the first fence runs every stage function once more
MP_PER_STEP = {
    "optireduce": {"fwht": 8, "masked_mean": 4},
    "optireduce_q": {"fwht": 4, "ht_amax": 4, "ht_quant": 4,
                     "dequant_mean": 4, "grid_quant": 4}}
MP_UDP_CHECK = ("--elems", "4096", "--drop-rate", "0.05", "--drop-seed",
                "3", "--deadline", "1.0")
MP_KILL_STEPS = 8
# s before each step's fence: a respawned worker takes ~7 s to start on the
# card (interpreter, torch, CUDA context, warm-up), and the parent respawns
# it at the third step's fence; at 2 s it rejoined only at the last step
MP_KILL_SLEEP = "3"


def _mp_digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


def _hostring_digests(dev, strategy: str, elems: int, block: int,
                      steps: int, rate: float) -> tuple[dict, float]:
    """Each rank's output digest per step from one ``HostRing`` on the
    card under the launcher's scripted wire (``bernoulli_drops(rate,
    seed=3)``), data and keys (``fold_in(key(0), step)``); and its host
    seconds."""
    import numpy as np
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, key
    from repro_torch.net import HostRing, bernoulli_drops

    cfg = OptiReduceConfig(strategy=strategy, drop_rate=0.0,
                           hadamard_block=block, packet_elems=256)
    ring = HostRing(PEERS, cfg, backend="inproc", device=dev,
                    drop_fn=bernoulli_drops(rate, seed=3))
    out = {}
    t0 = time.perf_counter()
    try:
        for step in range(steps):
            data = np.random.default_rng(step).standard_normal(
                (PEERS, elems)).astype(np.float32)
            res, _ = ring.allreduce(data, fold_in(key(0), step), step=step,
                                    bucket=0)
            out[step] = [_mp_digest(res[r]) for r in range(PEERS)]
    finally:
        ring.close()
    return out, time.perf_counter() - t0


def _mp_ranks(report) -> dict:
    return {w["rank"]: w for w in report["workers"] if "steps" in w}


def _mp_digests_equal(report, want: dict) -> bool:
    ranks = _mp_ranks(report)
    return sorted(ranks) == list(range(PEERS)) and all(
        [ranks[r]["steps"][s]["checksum"] for r in range(PEERS)] == want[s]
        for s in want)


def _mp_udp(argv: list, timeout: float = 400.0) -> dict:
    """``python -m repro_torch.launch.multiproc --backend udp --device cuda
    ...`` as its own process, as a user runs it: the parent (and its
    rendezvous server) shares nothing with this script's heap and threads.
    Returns the merged report; a non-zero exit fails with its stderr."""
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                               .split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "report.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.multiproc", "--backend",
             "udp", "--device", "cuda", "--report", path, *argv],
            env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            fail(f"multiproc {argv}: exit {proc.returncode}\n"
                 f"{proc.stderr[-4000:]}")
        with open(path) as f:
            return json.load(f)


def multiproc_paths(dev, counters: dict) -> None:
    """Phases ``multiproc_inproc``, ``multiproc_udp`` and ``multiproc_kill``:
    ``repro_torch.launch.multiproc`` on the card (the module docstring's
    items 43-45). Each counter is set to 0 just before an inproc launch and
    read just after; the ``HostRing`` it is held against runs after."""
    import tempfile

    import torch
    from repro_torch.launch import multiproc as mp

    for strategy, per_step in MP_PER_STEP.items():
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        report = mp.main(["--backend", "inproc", "--device", "cuda",
                          "--steps", str(MP_STEPS), "--strategy", strategy,
                          *MP_DROP, *MP_FULL])
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        counts = {n: getattr(mod, attr) for n, (mod, attr) in
                  counters.items()}
        want_c = {k: per_step.get(k, 0) * (MP_STEPS + 1) for k in counters}
        want, ring_s = _hostring_digests(dev, strategy, BUCKET, BLOCK,
                                         MP_STEPS, MP_RATE)
        ranks = _mp_ranks(report)
        bitwise = _mp_digests_equal(report, want)
        loss = [[ranks[r]["steps"][s]["loss_frac"] for r in sorted(ranks)]
                for s in range(MP_STEPS)]
        emit({"phase": "multiproc_inproc", "strategy": strategy,
              "ranks": PEERS, "elems": BUCKET, "steps": MP_STEPS,
              "host_s": host_s,
              "step_s": [max(w["steps"][s]["step_s"] for w in ranks.values())
                         for s in range(MP_STEPS)],
              "start_s": max(w["start_s"] for w in ranks.values()),
              "launches": counts,
              "launches_per_step": {k: (v - want_c[k] // (MP_STEPS + 1))
                                    / MP_STEPS for k, v in counts.items()},
              "loss_frac": loss,
              "stage2_dropped": [[ranks[r]["steps"][s]["stage2_dropped"]
                                  for r in sorted(ranks)]
                                 for s in range(MP_STEPS)],
              "bitwise_equal_hostring": bitwise, "hostring_host_s": ring_s})
        if counts != want_c:
            fail(f"multiproc_inproc {strategy}: launches {counts}, expected "
                 f"{want_c} ({MP_STEPS} steps and the warm-up)")
        if not bitwise:
            fail(f"multiproc_inproc {strategy}: checksums differ from "
                 "HostRing's on the card")
        # a receiver's own row never crosses the wire: 3/4 of the rate
        if not all(abs(x - 0.75 * MP_RATE) <= 0.002 for row in loss
                   for x in row):
            fail(f"multiproc_inproc {strategy}: loss_frac {loss} outside "
                 f"{0.75 * MP_RATE} +- 0.002")

    # 4 processes on the card: bitwise at 4096 elements, then full width
    want, _ = _hostring_digests(dev, "optireduce", 4096, 256, 2, 0.05)
    t0 = time.perf_counter()
    report = _mp_udp(["--steps", "2", "--timeout", "300", *MP_UDP_CHECK])
    check_s = time.perf_counter() - t0
    ranks = _mp_ranks(report)
    bitwise = _mp_digests_equal(report, want)
    emit({"phase": "multiproc_udp", "elems": 4096, "steps": 2,
          "host_s": check_s, "bitwise_equal_hostring": bitwise,
          "start_s": [ranks[r]["start_s"] for r in sorted(ranks)],
          "loss_frac": [[s["loss_frac"] for s in ranks[r]["steps"]]
                        for r in sorted(ranks)]})
    if not bitwise:
        fail("multiproc_udp: 4096 elements not bitwise HostRing's")
    t0 = time.perf_counter()
    report = _mp_udp(["--steps", "1", "--timeout", "300", *MP_DROP,
                      *MP_FULL])
    host_s = time.perf_counter() - t0
    ranks = _mp_ranks(report)
    emit({"phase": "multiproc_udp", "elems": BUCKET, "steps": 1,
          "host_s": host_s, "reports": len(ranks),
          "start_s": [ranks[r]["start_s"] for r in sorted(ranks)],
          "step_s": [ranks[r]["steps"][0]["step_s"] for r in sorted(ranks)],
          "loss_frac": [ranks[r]["steps"][0]["loss_frac"]
                        for r in sorted(ranks)],
          "stage2_dropped_frac": [ranks[r]["steps"][0]["stage2_dropped"]
                                  / (PEERS * SHARD) for r in sorted(ranks)],
          "timed_out": [ranks[r]["steps"][0]["timed_out"]
                        for r in sorted(ranks)],
          "rmem_max": rmem_max()})
    if sorted(ranks) != list(range(PEERS)) or not all(
            len(w["steps"]) == 1 and w["exit"] == "ok"
            for w in ranks.values()):
        fail(f"multiproc_udp: reports {report['workers']}")

    # a real SIGKILL, ejection, and the respawned rank's readmission
    kill_rank, kill_step = 1, 1
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        report = _mp_udp(["--steps", str(MP_KILL_STEPS), "--elems", "1024",
                          "--deadline", "1.0", "--step-sleep", MP_KILL_SLEEP,
                          "--kill-rank", str(kill_rank), "--kill-step",
                          str(kill_step), "--restart", "--ckpt-dir", ckpt,
                          "--timeout", "300"])
        host_s = time.perf_counter() - t0
    ranks = _mp_ranks(report)
    killed = [w for w in report["workers"] if w.get("exit") == "killed"]
    rejoiner = ranks.get(kill_rank, {})
    trails = {r: [s["statuses"][kill_rank] for s in w["steps"]]
              for r, w in ranks.items() if r != kill_rank}
    emit({"phase": "multiproc_kill", "steps": MP_KILL_STEPS,
          "host_s": host_s, "killed": len(killed),
          "rejoiner": {k: rejoiner.get(k) for k in
                       ("resumed_from", "start_step", "start_s")},
          "rejoiner_steps": [s["step"] for s in rejoiner.get("steps", [])],
          "survivor_trails": trails,
          "skipped_after_kill": {r: ranks[r]["steps"][kill_step + 1]
                                 ["skipped"] for r in trails}})
    ok = (len(killed) == 1 and sorted(ranks) == list(range(PEERS))
          and rejoiner.get("resumed_from") == kill_step - 1
          and rejoiner["start_step"] > kill_step
          and rejoiner["steps"]
          and rejoiner["steps"][-1]["step"] == MP_KILL_STEPS - 1
          and all("ejected" in t[kill_step:] for t in trails.values())
          and any("probation" in t[t.index("ejected"):]
                  for t in trails.values() if "ejected" in t))
    if not ok:
        fail(f"multiproc_kill: {report}")


def elastic_phase(dev) -> None:
    """Phase ``elastic``: gpt2-paper's parameters on the card, resharded
    over 4 workers, gathered, resharded over 2 and gathered again; both
    gathers bitwise the original, every shard a quarter (half) of its
    leaf's fsdp dim; host ms of each call (synchronised), three times."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.keys import generator, key
    from repro_torch.models import init_params
    from repro_torch.train.elastic import _fsdp_dims, gather_shards, reshard
    from repro_torch.tree import tree_leaves

    cfg = get_config("gpt2-paper")
    params = init_params(generator(key(0), dev), cfg, device=dev)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    dims = _fsdp_dims(cfg, 1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    rounds = []
    ok = True
    for _ in range(3):
        shards4, r4 = timed(lambda: reshard(params, cfg, 4))
        full4, g4 = timed(lambda: gather_shards(shards4, cfg))
        shards2, r2 = timed(lambda: reshard(full4, cfg, 2))
        full2, g2 = timed(lambda: gather_shards(shards2, cfg))
        for n, shards in ((4, shards4), (2, shards2)):
            for leaf, dim, *parts in zip(leaves, dims,
                                         *map(tree_leaves, shards)):
                ok &= all(p.shape[dim] * n == leaf.shape[dim]
                          if dim is not None else p is leaf for p in parts)
        ok &= all(torch.equal(a, b) for full in (full4, full2)
                  for a, b in zip(tree_leaves(full), leaves))
        rounds.append({"reshard4_ms": r4, "gather4_ms": g4,
                       "reshard2_ms": r2, "gather2_ms": g2})
        del shards4, full4, shards2, full2
    sharded = sum(t.numel() * t.element_size()
                  for t, d in zip(leaves, dims) if d is not None)
    emit({"phase": "elastic", "arch": cfg.name, "params": n_params,
          "bytes": nbytes, "sharded_bytes": sharded,
          "gather_bound_ms": 2 * sharded / HBM_BYTES_PER_S * 1e3,
          "rounds": rounds, "bitwise": ok})
    if n_params != 151_862_784 or not ok:
        fail(f"elastic: {n_params} params, round trip bitwise {ok}")


PORTED_KERNELS = ("fwht_rows_kernel", "masked_mean_vec4", "ht_kernel",
                  "dequant_mean_kernel", "grid_quant_kernel",
                  "uniform_quant_kernel")


def _dev_us(r):
    return getattr(r, "self_device_time_total",
                   getattr(r, "self_cuda_time_total", 0.0))


def _device_rows(rows):
    """Device-side rows only (kernels, copies, sets): the host op rows
    above them report the same device time again."""
    return [r for r in rows if str(r.device_type).endswith("CUDA")]


def device_busy_ms(prof) -> float:
    return sum(_dev_us(r) for r in _device_rows(prof.key_averages())) / 1e3


def profile_third_step(one, label: dict) -> None:
    """Run ``one(0)``, ``one(1)`` (each a step ending in a synchronisation)
    on the host clock, then ``one(2)`` under ``torch.profiler``: wall time,
    device busy time and idle share, the largest device and host entries,
    and the device time of each of the port's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import collectives

    wall = []
    for s in range(2):
        t0 = time.perf_counter()
        one(s)
        wall.append((time.perf_counter() - t0) * 1e3)
    permutes = collectives.permutes
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one(2)
        prof_wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    permutes = collectives.permutes - permutes
    emit_profile(prof, label, wall[-1], prof_wall, peak, permutes)


def emit_profile(prof, label: dict, wall_ms: float, prof_wall_ms: float,
                 peak: int, permutes: int) -> None:
    """The ``profile`` row of one profiled step: ``wall_ms`` is the
    unprofiled step before it, ``prof_wall_ms`` the profiled step's host
    time."""
    rows = prof.key_averages()
    on_dev = _device_rows(rows)
    busy_ms = sum(_dev_us(r) for r in on_dev) / 1e3
    top_dev = sorted(on_dev, key=_dev_us, reverse=True)[:12]
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
    # elementwise kernels: with recovery, the fill's and the residuals'
    # passes over the (P, N, S) stacks and the arena sit among them
    elementwise = sorted((r for r in on_dev
                          if "elementwise" in r.key.lower()),
                         key=_dev_us, reverse=True)
    emit({"phase": "profile", **label,
          "step_ms_unprofiled": wall_ms, "step_ms_profiled": prof_wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          # busy over the profiled step's wall time; the second share
          # divides the same busy time by the unprofiled step before it,
          # which runs the same kernels without the profiler's host cost
          "device_idle_share_of_profiled_step": (1 - busy_ms / prof_wall_ms)
          if busy_ms > 0 else "not measured",
          "device_idle_share_of_unprofiled_step": (1 - busy_ms / wall_ms)
          if busy_ms > 0 else "not measured",
          "kernel_launches": launches,
          "peak_mem_bytes": peak,
          "permutes": permutes,
          "index_kernels_ms": sum(_dev_us(r) for r in indexed) / 1e3,
          "index_kernels_launches": sum(r.count for r in indexed),
          "elementwise_ms": sum(_dev_us(r) for r in elementwise) / 1e3,
          "elementwise_launches": sum(r.count for r in elementwise),
          "top_elementwise": [{"name": r.key[:90], "ms": _dev_us(r) / 1e3,
                               "count": r.count} for r in elementwise[:8]],
          "top_device": [{"name": r.key[:90], "ms": _dev_us(r) / 1e3,
                          "count": r.count} for r in top_dev],
          "ported_kernels": [{"name": r.key[:90], "ms": _dev_us(r) / 1e3,
                              "count": r.count} for r in ported],
          "top_host": [{"name": r.key[:90],
                        "ms": r.self_cpu_time_total / 1e3,
                        "count": r.count} for r in top_cpu]})


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
