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
9. one more step of optireduce under ``torch.profiler``: wall time,
   device busy time and idle share, the largest device and host entries,
   and each of the port's kernels' device time (the profiles of
   optireduce_q, optireduce_rounds, ``--recovery ef``, ``--dp-mode fsdp``
   and ``--tp 2`` were cut to pay for later phases; PERF.md section 4);
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
17. ``rounds_cpu``: 8.'s comparison for optireduce_rounds and
    tar_rounds_q;
18. ``adaptive_codec``: the launcher with the §3.2 control plane in the loop,
    ``--strategy optireduce --adaptive --drop-rate 0.002 --steps 5 --trace
    --report`` at 6.'s full width: per step the policy the step ran under,
    B1 and B2 launches, loss_frac, step ms, the trace's ``step`` span's
    host ms beyond the step (logging, control plane, any rebuild) and the
    device busy ms of the last step (under ``torch.profiler``),
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
20. ``netsim`` (in a process of its own, ``chip_smoke.py --netsim``,
    started after the build beside the card's phases, its lines printed
    before ``seconds``): the calibrated network simulator on the host at the sizes
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
    and none of B2 (the plain mean follows the fill);
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
32. (cut: the profile of one ``--dp-mode fsdp`` step.)

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
37. (cut: the profile of one ``--tp 2`` step.)

38. ``wire_ring``: one full-width bucket, (4, 6,553,600) fp32, through
    ``HostRing.allreduce`` over the inproc wire backend, each peer's stage
    functions on the card, the wire scripted to lose the packets of the
    engine's tail masks at 0.01: bitwise ``sync_packed`` under ``Lossy`` on
    the same draws, for optireduce (8 B1 + 4 B2 launches: each peer's
    encode, decode and compensated mean) and optireduce_q (4 each of B1,
    B3-B6); the datagrams and bytes of each kind and the host seconds;
39. ``wire_main``, ``wire_q``: the launcher at 6.'s full width, gpt2-paper
    cut to 1 of its 12 layers (8 buckets of 6,553,600), with
    ``--transport inproc`` (1 step each; ``wire_main``'s second was cut
    to pay for 79.-81.): 16 B1 + 8 B2, and 8 each of
    B1, B3-B6 a step, as on the lossy path; no bridge miss (a call waits
    up to ``WIRE_BRIDGE_TIMEOUT_S``) or error; one ``wire[inproc]`` line a step with 4 peers; the wire's loss_frac within
    0.0075 +- 0.002 (0.01 x 3/4: a receiver's own row never crosses the
    wire); per step the datagrams and bytes of each kind, the bridge's
    device-to-host and host-to-device bytes, the host seconds the bridge
    held the training thread (and its longest call) and the flush at the
    step's end;
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
42. ``profile`` of ``wire_main``'s one step as in 9. (no unprofiled
    step beside it);
43. ``multiproc_inproc``: ``repro_torch.launch.multiproc --backend
    inproc`` on the card, 4 rank-threads each exchanging one gpt2-paper
    bucket (``--elems 6553600 --hadamard-block 1024 --packet-elems 256``)
    at wire loss 0.01, 1 step each of optireduce and optireduce_q: every
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
47. ``families_main``: the launcher (``--arch``) at full width, 4 peers,
    optireduce, tail drops 0.01, seq 128, global batch 8, AdamW, 2 steps
    each, on smollm-360m (32 layers, 361,821,120 params, 56 buckets),
    qwen2-moe-a2.7b (60 experts top-4 and 4 shared, cut to 1 of 24 layers:
    881,719,296 params, 135 buckets) and mamba2-1.3b (cut to 24 of 48
    layers to pay for 79.-81.: 723,130,880 params, 111 buckets): loss,
    loss_frac, step ms, peak bytes; launches exactly 2 B1 and 1 B2 a
    bucket a step;
48. ``hybrid_fwd``: jamba-v0.1-52b at full width, one period (8 of 32
    layers, 12,997,268,800 params), a bf16 ``lm_loss`` under
    ``torch.no_grad`` on (8, 128): the loss (finite), ms, peak;
49. ``families_check``: every architecture's smoke config, 2 steps on the
    card against 2 on the CPU (as ``fsdp_check``, replicated), launches
    exact; ``prefix_check``: llava-smoke's and musicgen-smoke's loss and
    gradients with a prefix, card vs CPU;
50. ``profile`` of one step of qwen2-moe-a2.7b (1 layer), as in 9.; the
    MoE dispatch's scatter and gathers are among the index kernels
    (mamba2-1.3b's profile was cut to pay for the restarted steps of the
    card-vs-CPU cases);
51. ``serve_main``: ``repro_torch.launch.serve`` (its ``main``) on the
    card, gpt2-paper at full width, ``--batch 128 --prompt-len 64
    --max-new 128`` (191 decode steps, a 0.91 GB bf16 KV cache; the
    896-token prompt was cut to 128 to pay for 72.-74. and to 64 for
    76.): its two lines, tok/s, ms a decode step (CUDA events, median
    after 4), the cache's and the peak bytes; the output (128, 192) in
    vocab; no kernel of the repo launched (serving reaches none);
52. ``serve_families``: ``serve.generate`` at full width and depth on
    glm4-9b (B 32, prompt 32, 32 new: its 256-token prompt was cut to pay
    for 75. and 77., its 64 new for 76.), qwen2-moe-a2.7b (B 32, prompt
    32, 32 new: its 64-token prompt cut for 77.) and mamba2-1.3b (B 32,
    prompt 64, 32 new: its 128-token prompt was cut to pay for 76., its
    64 new for 77.), bf16: the same numbers, tokens in vocab;
53. ``serve_prefill``: ``prefill_step`` on gpt2-paper at B 32 and a
    1024-token prompt against the teacher-forced loop: the share of first
    tokens that agree, the fp32 logit margins, the caches within 0.05 of
    their largest magnitude; then 32 greedy steps from the prefill's state;
54. ``serve_grid``: ``build_serve_step`` on the peer grid, each case
    against the same model run another way: gpt2-paper on 4 data peers at
    B 128 (batch-sharded; bitwise the plain step), at B 1 over a 32,768-
    token random cache (sequence-sharded; one step each side of every
    shard boundary), at dp 1 x tp 2 (B 32; against tp 1); qwen2-moe-a2.7b
    (24 layers) on 4 data peers, ``weight_fsdp`` + ``moe_stationary`` at
    B 1 (against the gathered experts); written rows within 0.05 of their
    largest magnitude, token agreement and ms a step recorded;
55. ``profile`` of one gpt2-paper decode step at B 128 (a 1,024-token
    cache), as in 9.;
56. ``serve_check``: every smoke config (11 archs and gpt2-smoke) through
    ``generate`` and each grid plan (batch- and sequence-sharded,
    stationary for the MoE archs, dp 2 x tp 2 for the dense ones) on the
    card against the CPU, same parameters: tokens equal, states within
    1e-5 of each leaf's largest magnitude;
57. ``tp_families_main``: the launcher at full width with ``--dp 2 --tp
    2`` (experts, SSM heads and the prefix over the tp ranks), optireduce,
    tail drops 0.01, seq 128, global batch 8, AdamW, 2 steps, on
    qwen2-moe-a2.7b (1 of 24 layers), mamba2-1.3b (12 of 48) and
    llava-next-mistral-7b (2 of 32, ``--seq-parallel --prefix``: 2,048
    patches before the 128 tokens): loss, loss_frac, step ms, peak bytes;
    launches exactly 2 B1 and 1 B2 a bucket of one tp rank's local leaves a
    step (llava's run is ``dist_frontend_main``'s stacked side, 83.); then
    one step each at ``--tp 2`` and ``--tp 1`` without drops in fp32
    (mamba2's in fp64): losses within ``TP_LOSS_TOL``, gradient norms
    within ``TP_GRAD_TOL`` (a bf16 ``--tp 1`` step, its loss alone held,
    was cut to pay for 82.-83.);
58. ``tp_serve_families``: ``generate`` over tp at full width:
    qwen2-moe-a2.7b (24 layers, tp 8: 60 experts padded to 64; B 32,
    prompt 64, 32 new), mamba2-1.3b (48 layers, tp 2; B 32, 128, 64) and
    jamba-v0.1-52b (8 of 32 layers, tp 2; B 8, 128, 32: its 256-token
    prompt cut to pay for 77.): tok/s, ms a step,
    state and peak bytes; then, in fp32, 16 teacher-forced
    ``build_serve_step`` steps at dp 1 x tp T against tp 1 on the same
    weights: tokens agreed, layer 1's written rows or SSM states within
    ``TP_LAYER1_TOL``, every layer's within its arch's ``TP_SERVE_TOL``
    mamba2's steps again in fp64, every layer's within
    ``TP_SERVE_FP64_TOL``;
59. ``tp_families_check``: every non-dense smoke config at (data 2, model
    2), qwen2-moe-smoke at (data 2, model 4) and llava-smoke under
    ``seq_parallel``, 2 steps card against CPU within ``STEP_TOL``, chained
    (qwen2-moe-smoke at (2, 4) recorded, ``CHAIN_UNHELD``) and each card
    step again from the CPU's state, launches exact;
60. ``dryrun``: ``python -m repro_torch.launch.dryrun --all`` on the 16 x
    16 mesh, on the ``meta`` device in a process of its own started before
    the kernels' build (host only, beside the card's phases): 40 cells, 8
    skipped (long_500k of the full-attention archs), each other one's state
    bytes a device and ``matmul_flops``; its own seconds;
61. ``threefry``: kernel T1 (threefry draws, ``kernels/threefry``) against
    its plain version, bitwise, at the paths' shapes: a bucket's tail
    timeouts and Bernoulli masks, 24 signs in one (24, 2) key batch, the
    stage-1 and 24 stage-2 noises, an init normal and THC's (148,304 x
    1024) noise, timed there against its bound (integer operations);
62. ``draws_main``: ``optireduce`` and ``optireduce_q`` through the
    launcher with the default (threefry) draws, 2 steps: T1 launches
    exactly one a normal leaf at init and ``T1_PER_STEP`` a step beside
    the other kernels'; ``draws_check``: step 0's signs, masks and noises
    on the card bitwise the CPU's;
63. ``vmap_strategies``: every strategy on the (4, 24, 6,553,600) arena in
    ``vmap`` and ``scan``, bitwise bucket for bucket, device ms and peak
    bytes; ``vmap_main``: the launcher with ``--sync-mode vmap``, 2 steps:
    exactly 2 B1 + 1 B2 a step (``optireduce``) and one each of B1, B3–B6
    (``optireduce_q``), 2 and 4 T1;
64. ``adafactor_main``: the launcher with ``--optimizer adafactor``, 2
    steps: loss, ms, peak; 48 B1 + 24 B2 a step;
65. ``chunked_train``: ``--seq-len 8192 --global-batch 4`` (two query
    blocks of 4,096 a layer), 2 steps: ms, peak; 48 B1 + 24 B2 a step;
66. ``chunked_prefill``: ``prefill_step`` on gpt2-paper at 32,768 tokens,
    batch 2 (the reference's ``prefill_32k``, its batch cut from 32): ms,
    peak, state bytes; one attention layer at 8,192 chunked against dense
    in fp32 within ``CHUNK_DENSE_TOL``;
67. ``dist_sync``: 4 ranks on the card, one peer a rank over a gloo
    process group (``tools/distcheck.py``, one process a rank; the stacked
    side runs meanwhile, during the ranks' start-up and cold first step,
    and their second step waits for its end), each syncing its row of a
    seeded (4, 3, 65,536) arena through every strategy in ``scan`` and
    ``pipelined`` (tail drops 0.01 on the lossy ones) and the policies,
    ``pmax`` over a NaN and a ``ppermute`` naming some destinations, then
    ``optireduce`` and ``optireduce_q`` on the full (4, 24, 6,553,600)
    arena: each rank's result bitwise its row of the stacked form's on the
    same arena and draws, the same loss fraction, and the rank's own
    launches (B1-B6, T1, permutes) equal to the stacked sync's; per rank
    the bytes it sent through the group and the host s in its calls;
68. ``dist_main``: the launcher on those ranks (``--dist-backend gloo``),
    gpt2-paper at full width, ``optireduce``, tail drops 0.01,
    ``pipelined``, 2 steps, against the stacked launcher's 2 steps at
    ``--dp 4``: the ranks' parameters bitwise equal after every step, rank
    0's parameters and metrics within ``STEP_TOL`` of the stacked run's,
    each rank's launches (48 B1, 24 B2, 48 T1 a step, 8 T1 at init) the
    stacked run's; per rank and step host ms, peak bytes, bytes sent and
    host s in the group's calls (gloo only: an NCCL call returns once
    queued); every rank's second step starts after the stacked sides
    and nccl's first step ended;
69., 70. ``dist_nccl_sync``, ``dist_nccl_main``: 67. and 68. over nccl at
    a world of ``torch.cuda.device_count()`` (one rank a card; the small
    arena only), started with the gloo ranks, its steps after the first
    once they have ended;
71. ``dist_fsdp_main``: the launcher with ``--dp-mode fsdp`` on 67.'s
    ranks after 68. (ZeRO-3: each rank holds its shard of every sharded
    leaf and of its AdamW moments), 2 steps of gpt2-paper at full width,
    against 27.'s first 2 steps (the same flags, kept from that run):
    after every step each rank's parameters and moments bitwise its slice
    of the stacked ones, the replicated leaves bitwise equal, every rank's
    loss, loss_frac, grad norm and skipped the stacked run's, launches a
    rank a step the stacked step's (174 B1, 87 B2, T1), state bytes a rank
    its shard's count; per rank and step host ms, peak bytes, state bytes,
    bytes sent and host s in gloo's calls. 67. also reduce-scatters a
    (4, 50,257, 768) bf16 gradient (the embedding's shape) along dim 1,
    plain and with the 8-bit wire (``rs_wire_bits=8``): each rank's shard
    bitwise its stacked row, its launches (B1, B2, B3-B5, T1) the stacked
    reduce-scatter's;
72. ``dist_pod_sync``: 67.'s gloo ranks as a ``(pod 2, data 2)`` grid
    of process groups (``collectives.rank_grid(pods=2)``: each pod's data
    group, each data index's pod group), after 71.: the (4, 3, 65,536)
    arena through every strategy in ``scan`` and ``pipelined`` and the
    policies that run on 2 data peers, at tail drops 0.05 (at 0.01 that
    arena's 2-peer data axis loses nothing), ``pmax`` over a NaN and
    ``pmean`` over the pod axis and over both, ``optireduce_q`` on the
    full (4, 24, 6,553,600) arena, and the embedding's (4, 50,257, 768)
    FSDP reduce-scatter over both hops (pod first, reliable; then data),
    plain and 8-bit, at 0.01: each rank's result bitwise its row of the
    stacked 2 x 2 grid's on the same arenas and draws, with the same loss
    fraction and launches; per rank and full-size case the bytes sent and
    host s in gloo's calls;
73. ``dist_pod_main``: ``build_train_step`` with ``pure_dp`` on a ``(data
    2, model 2)`` mesh over those ranks (``tools/distcheck.py
    --pod-train``; no launcher has a pod flag), gpt2-paper at full width,
    ``optireduce_2d`` (the hierarchical 2D TAR: data exchange, TAR over
    the pods, data broadcast), tail drops 0.01, ``pipelined``, AdamW, seq
    128, global batch 8 split pod-major, 2 steps, against the same run on
    the stacked 2 x 2 grid (in the parent while the ranks start): after
    every step each rank's parameters and AdamW moments bitwise the
    stacked ones, its loss, loss_frac, grad norm and skipped the stacked
    run's, its launches a step the stacked step's (48 B1, 24 B2, T1) and
    at init; per rank and step host ms, peak bytes, state bytes, bytes
    sent by axis (data, pod, both) and host s in gloo's calls;
74. ``dist_pod_fsdp_main``: the same under FSDP: each rank holds its
    pod-major quarter of every sharded leaf and of its moments, the
    gather over the whole grid, each site's reduce-scatter the pod hop
    (reliable, unrotated) then the data hop; after every step each rank's
    state bitwise its slice of the stacked state, 174 B1 and 87 B2 a
    step, the state bytes its quarter's count;
75. ``dist_tp_main``: the launcher under torchrun with ``--dp 2 --tp 2``
    on gloo's 4 ranks, last in their world (tensor parallelism over ranks:
    rank ``i * 2 + t`` holds only its tp shard of every tp-sharded leaf
    and of its AdamW moments, the model's tp sums run in its tp group, its
    arena syncs in its data group), gpt2-paper at full width,
    ``optireduce``, tail drops 0.01, ``pipelined``, 2 steps, against the
    stacked launcher's same flags (``--dp 2 --tp 2`` as one process, in
    the parent while the ranks start): each rank's launches a step exactly
    ``2 x TP_BUCKETS`` B1, ``TP_BUCKETS`` B2 and ``2 x TP_BUCKETS`` T1
    (one normal leaf each of T1 at init) and none else; after each step
    the leaves replicated over tp (and their moments) bitwise equal on
    every rank, each rank's state (a strided sample of its shards, the
    replicated leaves whole) bitwise its data replica's; every rank's loss
    and grad norm within ``DIST_TP_REL`` relative of the stacked run's
    (bf16 partial sums in another order); each rank's parameter shards
    after the 2 steps within ``DIST_TP_PARAM_TOL`` (4 x lr) of the stacked
    ones' tp slices, beyond a bf16 step of the stacked entry a step (each
    form rounds it each step); state bytes a rank its shard's count; per
    rank and
    step host ms, peak bytes, state bytes, bytes sent by axis (data,
    model) and host s in gloo's calls;
76. ``dist_tp_fsdp_main``: the same launcher flags with ``--dp-mode fsdp``
    (FSDP x TP over ranks: rank ``i * 2 + t`` holds only data shard i of
    tp chunk t of every leaf sharded over both, and of its AdamW moments;
    the gather builds its tp chunk over its data group, each site's
    reduce-scatter runs in its data group), after ``dist_tp_main`` in
    gloo's world, against the stacked ``--dp 2 --tp 2 --dp-mode fsdp``
    run beside it: each rank's launches a step exactly 174 B1 and 87 B2
    (``TP_PER_STEP["tp_fsdp"]``, the stacked step's too) and the stacked
    step's T1, none else, one T1 a normal leaf at init; after each step
    the leaves no rank shards (the norms, and their moments) bitwise equal
    on every rank; loss and grad norm within ``DIST_TP_REL``; each rank's
    blocks within ``DIST_TP_PARAM_TOL`` beyond a bf16 step a step of the
    stacked blocks; state bytes a rank :func:`tp_rank_state_bytes`; the
    same rows per rank and step as ``dist_tp_main``;
77. ``dist_moe_main``: the MoE family over the ranks, after
    ``dist_tp_fsdp_main`` in gloo's world: the launcher with ``--dp 2 --tp
    2`` (:func:`dist_moe_argv`) on qwen2-moe-a2.7b at full width (d 2048,
    60 experts top-4, 4 shared, vocab 151,936, bf16), cut to 1 of 24
    layers (``DIST_MOE_LAYERS``), ``optireduce``, tail drops 0.01,
    ``pipelined``, AdamW, seq 128, global batch 8, 2 steps, each tp rank
    holding and computing only its 30 experts, the whole router. Held as
    ``dist_tp_main`` is (launches a rank a step exactly 2 B1, 1 B2 and 2
    T1 a bucket of its local leaves, the stacked step's too, one T1 a
    normal leaf at init; the leaves replicated over tp bitwise on every
    rank; records within ``DIST_TP_REL``; shards within
    ``DIST_TP_PARAM_TOL`` beyond a bf16 step a step; state bytes
    :func:`tp_rank_state_bytes`), and beside it ``dist_moe_main_router``:
    each rank's router and its first moment against the stacked run's
    (:func:`_dist_moe_router_held`). The stacked runs of both MoE phases
    go first in the parent, while the ranks wait at their first step of
    ``dist_main`` for the release (their card memory then a few GB of
    gpt2-paper's): the stacked side's peak and the ranks' (about 7 GB a
    rank here) never meet on the card;
78. ``dist_moe_fsdp_main``: the same with ``--dp-mode fsdp`` (each rank
    holding data shard i of tp chunk t of every leaf, its experts' among
    them), held as ``dist_tp_fsdp_main`` is, and ``dist_moe_fsdp_main_router``;
79. ``dist_ssm_main``: the SSM family over the ranks, after
    ``dist_moe_fsdp_main`` in gloo's world: the launcher with ``--dp 2
    --tp 2`` (:func:`dist_family_argv`) on mamba2-1.3b at full width (d
    2048, d_inner 4096, 64 heads of 64, state 128, conv 4, vocab 50,280,
    tied, bf16), cut to 12 of 48 layers (``DIST_SSM_LAYERS``),
    ``optireduce``, tail drops 0.01, ``pipelined``, AdamW, seq 128, global
    batch 8, 2 steps, each tp rank holding and running only its 32 heads
    (its 2,048 channels of ``wx``, ``wz``, ``conv_w`` and ``out_proj``),
    ``wB``, ``wC`` and the norms whole. Held as ``dist_moe_main`` is (the
    grad norm recorded beside ``DIST_TP_REL`` where it falls outside:
    81. holds it), and beside it ``dist_ssm_main_bc``: each rank's ``wB``
    and ``wC`` and their first moments against the stacked run's
    (:func:`_dist_summed_held`, ``DIST_SSM_BC_REL``). Its stacked runs go
    first in the parent with the MoE family's, while the ranks wait at
    their first step of ``dist_main`` for the release, so the stacked
    side's peak (about 14 GB) and the ranks' never meet on the card;
80. ``dist_ssm_fsdp_main``: the same with ``--dp-mode fsdp``, held as
    ``dist_tp_fsdp_main`` is, and ``dist_ssm_fsdp_main_bc``; each rank
    keeps its own chunk of ``conv_w``, ``a_log``, ``dt_bias`` and
    ``d_skip`` (tp-sharded, no FSDP dim: the small bucket's);
81. ``dist_ssm_float64``: last in gloo's world, one replicated step of the
    same model at ``--dp 2 --tp 2`` in float64 without drops on the ranks
    (:func:`dist_ssm_float64_job`), held after 57. against its float64
    ``--tp 1`` step on the same flags (its records, not run again): loss
    and grad norm within ``TP_GRAD_TOL``; the stacked ``--tp 2`` float64
    step's recorded beside them;
82. ``dist_frontend_fsdp_main``: the frontend-prefix family over the
    ranks with sequence parallelism, after ``dist_ssm_fsdp_main`` in
    gloo's world: the launcher with ``--dp 2 --tp 2 --seq-parallel
    --prefix --dp-mode fsdp`` (:func:`dist_family_argv`) on
    llava-next-mistral-7b at full width (d 4096, 32 heads and 8 KV heads
    of 128, d_ff 14,336, vocab 32,000, a 2,048-patch prefix of width
    1,024, bf16), cut to 2 of 32 layers (``DIST_FRONTEND_LAYERS``),
    ``optireduce``, tail drops 0.01, ``pipelined``, AdamW, seq 128, global
    batch 8, 2 steps: a rank's residual stream its 1,088 of the 2,176
    positions, gathered and reduce-scattered in its tp group, its data
    shard of its tp chunk of every leaf. Held as ``dist_tp_fsdp_main`` is,
    against the stacked run of the same flags (in the parent with the
    other families' stacked runs), and beside it
    ``dist_frontend_fsdp_main_summed``: ``frontend_proj`` and the norms
    and their first moments against the stacked run's
    (:func:`_dist_summed_held`, ``DIST_FRONTEND_REL``);
83. ``dist_frontend_main``: the same replicated (``--dp 2 --tp 2
    --seq-parallel --prefix``), its ranks run last but one in gloo's
    world, held after 57. against ``tp_families_main``'s llava run of the
    same flags (its records, last parameters and launches kept, not run
    again; :func:`dist_reused_held` checks the flags match): launches a
    rank a step exactly 2 B1, 1 B2 and 2 T1 a bucket of its local leaves
    (44 buckets), the stacked step's the same; the leaves replicated over
    tp bitwise on every rank; records within ``DIST_TP_REL``; blocks
    within ``DIST_TP_PARAM_TOL`` beyond a bf16 step a step; state bytes
    :func:`tp_rank_state_bytes`; and ``dist_frontend_main_summed``;
84. ``seconds``: the script's wall clock, whole and by group of phases,
    with the tp, MoE, SSM and frontend phases' seconds inside the
    ``dist`` group (their ranks' run and their stacked side).

The ranks' per-step digests of their state in the ``dist_*`` phases, and
the stacked sides', cover each leaf's ``distcheck.sample`` at
``DIST_STRIDE``: every 997th entry's bytes and a checksum of every entry,
taken on the card (a change of any one entry changes the checksum); the
leaves replicated under FSDP or tp are digested whole.

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
import tempfile
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
                     # sums in other orders through an AdamW step
PEERS = 4
BLOCK = 1024                     # hadamard_block as the launcher sets it
BUCKET = 6_553_600
PEER_BLOCKS = BUCKET // BLOCK    # 6,400 blocks a peer
SHARD = BUCKET // PEERS          # 1,638,400 = 1,600 blocks a shard
ROUNDS_INCAST = 2                # the round schedule's I (a2a ignores it)


def _seeded(seed: int, device="cpu"):
    """A ``torch.Generator`` for a phase's own data (prompts, noise)."""
    import torch
    return torch.Generator(device=device).manual_seed(seed)


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

    # 60. the dry run of every arch x shape cell, on the host beside the
    # card's phases
    dryrun_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dryrun_out = dryrun_dir / "dryrun.json"
    dryrun = start_dryrun(dryrun_out)

    # 2. build every kernel, in parallel
    t0 = time.perf_counter()
    logs = build.build_all()
    # 20. the network simulator, host only, beside the card's phases
    netsim = start_netsim()
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

    # 61.-66. the reference's last modules (A2, A7, A9, A10): T1 against
    # its plain version, the default draws through the launcher (T1
    # counted), the batched sync, Adafactor, chunked attention in training
    # and in a 32k prefill
    t1 = check_threefry(dev)
    launches["draws"] = draws_main(dev, counters)
    launches["vmap"] = vmap_main(dev, counters)
    adafactor_and_chunked(counters)
    chunked_prefill(dev)
    lap("draws_vmap_chunked")

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

    # 18., 19. the launcher with the control plane in the loop (20., the
    # network simulator, runs in a process of its own beside the card's
    # phases)
    adaptive_runs(counters)
    lap("adaptive")

    # 15., 16. every ported strategy, and the participation policies, on one
    # full-width arena
    sync_strategies(dev, counters)
    lap("strategies")

    # 67.-82. one rank a peer over a process group (ROADMAP A18c): 4 gloo
    # ranks on the card, flat, as a 2 x 2 pod grid and as a (data 2, model
    # 2) tp grid, replicated and FSDP x TP, the dense, MoE, SSM and
    # frontend-prefix families (the last with sequence parallelism), then
    # nccl at the card count
    dist_tp, dist_f64, dist_deferred = dist_paths(dev)
    lap("dist")

    # 8., 17. the same trainer on the card and on the CPU, same params and
    # draws
    for strategy in ("optireduce", "optireduce_q", "optireduce_rounds",
                     "tar_rounds_q"):
        check_step_against_cpu(dev, strategy)
    lap("card_vs_cpu")

    # 9. where one step of the main path's time goes (the profiles of
    # optireduce_q and --tp 2 were cut to pay for phases 61.-66.)
    profile_step(dev, "optireduce")
    lap("profiles")

    # 47.-50. the model families (A21): the launcher on a dense, an MoE
    # and an SSM model at full width, the hybrid's forward, every smoke
    # config card vs CPU, a profiled step of the MoE model
    families_paths(counters)
    hybrid_forward(dev)
    check_families_against_cpu(dev)
    profile_step(dev, "optireduce", arch="qwen2-moe-a2.7b", layers=1)
    free_card()
    lap("families")

    # 51.-56. serving (A21, serving half): the launcher, the families
    # through generate, prefill, the peer-grid plans, a profiled decode
    # step, every smoke config card vs CPU
    serve_main(counters)
    serve_families(dev)
    serve_prefill_and_grid(dev)
    check_serving_against_cpu(dev)
    lap("serving")

    # 57.-60. the non-dense families over tensor parallelism (A21c):
    # training, serving, card vs CPU; the dry run runs beside them all
    tp_families = tp_families_paths(counters)
    # 81. the ranks' float64 step against tp_families_main's float64 tp 1
    # step (its records reused)
    wide = tp_families[DIST_SSM_ARCH]
    dist_ssm_float64_held(dist_f64, {"records": wide["wide_tp1"],
                                     "replicated": wide["replicated"]},
                          wide["wide_tp2"])
    # 83. the ranks' frontend run against tp_families_main's llava run of
    # the same flags (reused, not run again)
    dist_tp[DIST_REUSED] = dist_reused_held(
        dist_deferred, tp_families[DIST_FRONTEND_ARCH]["dist_stacked"])
    lap("tp_families_main")
    tp_serve_families(dev)
    lap("tp_serve_families")
    check_tp_families_against_cpu(dev)
    lap("tp_families_check")

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
    dryrun_s = finish_dryrun(dryrun, dryrun_out)
    lap("dryrun_wait")
    finish_netsim(netsim)
    lap("netsim_wait")
    emit({"phase": "seconds", "total": marks[-1] - marks[0],
          "by_group": laps, "dryrun_own_s": dryrun_s,
          "in_dist": {f"dist_{run}_{k}": v for run, held in dist_tp.items()
                      for k, v in held.items() if k != "launches"}})

    def dist_launches(kernel: str) -> dict:
        """A kernel's launches a rank a step in each tp grid run of gloo's
        world (rank 0's last step)."""
        return {f"dist_{run}_launches": held["launches"][kernel]
                for run, held in dist_tp.items()}

    kernels.append({
        "name": "fwht", "route": "cuda",
        "source": "src/repro_torch/kernels/fwht/csrc/fwht.cu",
        "replaces": "src/repro/kernels/fwht/fwht.py:130",
        "launches": launches["optireduce"]["fwht"],
        **dist_launches("fwht"),
        "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"]})
    kernels.append({
        "name": "masked_mean", "route": "cuda",
        "source": "src/repro_torch/kernels/masked_sum/csrc/masked_mean.cu",
        "replaces": "src/repro/kernels/masked_sum/masked_sum.py:68",
        "launches": launches["optireduce"]["masked_mean"],
        **dist_launches("masked_mean"),
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
    # T1 replaces no Pallas kernel: it is the card's jax.random (the
    # reference's draws, which XLA compiles into the step); its launches
    # are the draws_main optireduce run's, init included
    kernels.append({
        "name": "threefry", "route": "cuda",
        "source": "src/repro_torch/kernels/threefry/csrc/threefry.cu",
        "replaces": "none (jax.random threefry2x32 draws: "
                    "src/repro/core/hadamard.py:23, core/drops.py:38)",
        "launches": launches["draws"]["optireduce"]["threefry"],
        **dist_launches("threefry"),
        "max_abs_err": t1["max_abs_err"], "ms": t1["ms"],
        "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"], "library_ms": None})
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
    from repro_torch.core.keys import key
    from repro_torch.models import init_params
    from repro_torch.sim.tta import (KeyDraws, ReplicaRun, TrainRunConfig,
                                     _flatten)
    from repro_torch.tree import tree_map

    cpu = torch.device("cpu")
    rc = TrainRunConfig(compressor="thc", n_workers=4, per_worker_batch=4,
                        seq_len=32, steps=2, eval_every=1, lr=0.1)
    cfg = get_smoke("gpt2-paper")
    base = init_params(key(0), cfg, device="cpu")
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
               recovery: str = "none", arch: str = "gpt2-paper") -> list[str]:
    """The launcher's flags of a main path at full width."""
    return ["--arch", arch, "--dp", str(PEERS), "--strategy",
            strategy, "--drop-rate", "0.01", "--drop-pattern", pattern,
            "--recovery", recovery, "--seq-len", "128", "--global-batch",
            "8", "--optimizer", "adamw", "--device", "cuda", "--kernel-mode",
            "kernel", "--incast", str(ROUNDS_INCAST), "--log-every", "1"]


def train_main_path(strategy: str, steps: int, counters: dict, *,
                    pattern: str = "tail", recovery: str = "none",
                    phase: str = "train", extra=(),
                    loss_seen: bool = True, arch: str = "gpt2-paper",
                    label: dict | None = None) -> tuple[dict, list]:
    """One main path through the launcher at full width; returns each
    kernel's launches in this run alone, and the step records. Each step's
    loss_frac must be positive unless ``loss_seen`` is off (under FSDP it
    counts the small replicated bucket alone). ``label`` joins the run's
    summary row."""
    import torch
    from repro_torch.launch import train as launch_train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    records = launch_train.run([*train_argv(strategy, pattern, recovery,
                                            arch),
                                "--steps", str(steps), *extra])
    torch.cuda.synchronize()
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, rec in enumerate(records):
        row = {"phase": f"{phase}_step", "strategy": strategy, "step": i,
               **({"arch": arch} if arch != "gpt2-paper" else {}),
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
          "drop_pattern": pattern, "arch": arch, **(label or {}),
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
    watch = _StepWatch(counters, profile_steps=(steps - 1,))
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
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws
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
    base = init_params(k, cfg, device="cpu")
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
            draws = _HostDraws(ThreefryDraws(
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
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws, SyncContext
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
        draws = ThreefryDraws(key=fold_in(key(0), 7), cfg=cfg, device=dev)
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

        def on_device(*args, **kw):
            out = draw(*args, **kw)
            return out.to(self.device) if hasattr(out, "to") else out
        return on_device


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
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws
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
    base = init_params(k, cfg, device="cpu")
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
            draws = _HostDraws(ThreefryDraws(
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
                 tp: int = 1, arch: str = "gpt2-paper",
                 layers: int | None = None) -> None:
    from repro_torch.core import recovery as recovery_lib
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.bucket_plan import BucketPlan
    from repro_torch.core.keys import key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train.trainer import TrainConfig, build_train_step

    cfg = full_width(arch, layers)
    sync = OptiReduceConfig(strategy=strategy, drop_rate=0.01,
                            drop_pattern=pattern, hadamard_block=BLOCK,
                            incast=ROUNDS_INCAST, recovery=recovery)
    tc = TrainConfig(sync=sync, seq_chunk=128, dp_mode=dp_mode)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    k = key(0)
    params = init_params(k, cfg, device=dev, tp=tp)
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
    if arch != "gpt2-paper":
        label.update(layers=cfg.n_layers, buckets=plan.num_buckets)
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
    from repro_torch.core.keys import key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.train import trainer as trainer_mod

    cfg = get_config("gpt2-paper")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    k = key(0)
    params = init_params(k, cfg, device=dev)
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


# the stacked side of ``dist_fsdp_main``, kept from ``fsdp_main``'s first
# ``DIST_STEPS`` steps (the same flags): per step each rank's slice digest
# of the parameters and AdamW moments, the replicated leaves' digest, the
# launches and the records
FSDP_STACKED: dict = {}


def a15_paths(dev, counters: dict) -> None:
    """Phases ``fsdp_main``, ``fsdp_q``, ``pod_main`` and ``pod_q``.
    ``fsdp_main``'s first ``DIST_STEPS`` steps also give ``dist_fsdp_main``
    its stacked side (``FSDP_STACKED``): a copy of the parameters and
    moments after each (on the card, so its peak counts them), digested
    as each of ``DIST_RANKS`` ranks must hold its slice."""
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import TrainConfig

    distcheck = _distcheck()
    with distcheck.watch_steps(state=True, shards=DIST_RANKS,
                               steps=DIST_STEPS, stride=DIST_STRIDE) as seen:
        counts, records = train_main_path(
            "optireduce", 4, counters, phase="fsdp_main",
            extra=("--dp-mode", "fsdp"), loss_seen=False)
    FSDP_STACKED.update(records=records[:DIST_STEPS],
                        digests=seen["digests"],
                        replicated=seen["replicated"],
                        launches=seen["launches"][:DIST_STEPS],
                        state_bytes=seen["state_bytes"][0])
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


# card-vs-CPU trainer cases (``cpu_cases``) whose chained steps are recorded
# but not held to STEP_TOL, each with the reason; their restarted steps are
# held like every other case's
CHAIN_UNHELD = {
    # qwen2-moe-smoke at (2, 4) on the reference's init draw: the card's
    # step 0 leaves it 9.8e-5 from the CPU, within STEP_TOL; from there
    # one token's top-k near-tie (margin 2.2e-5) picks another expert in
    # step 1 (tools/chained_routes.py), and AdamW turns the experts'
    # changed small gradient entries into lr-sized steps: 1.58e-2 apart,
    # every entry over STEP_TOL in we_gate/we_up/we_down (PERF.md §6).
    # The same step from the CPU's state routes alike and holds
    "tp_families_check_tp4": "step 0's rounding flips a near-tied route in "
                             "step 1",
}


def _leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix or "/"]


def _leaf_readings(cpu_params, card_params, cpu_state, card_state) -> dict:
    """Per leaf: the largest |card - CPU| of the parameters, and at that
    entry each side's AdamW moments (``m``, ``sqrt(v)``) beside the leaf's
    largest |m|: a first moment far below that scale whose two sides
    differ in sign marks a near-zero gradient whose rounding AdamW turns
    into an lr-sized step; a first moment near it, a real gradient
    difference."""
    from repro_torch.tree import tree_leaves

    out = {}
    for name, pc, pg, mc, mg, vc, vg in zip(
            _leaf_names(cpu_params), *(tree_leaves(t) for t in (
                cpu_params, card_params, cpu_state.m, card_state.m,
                cpu_state.v, card_state.v))):
        d = (pc.detach().float() - pg.detach().float().cpu()).abs()
        i = int(d.argmax())
        mcf, mgf = mc.float().flatten(), mg.float().cpu().flatten()
        out[name] = {"params": float(d.flatten()[i]),
                     "over_tol": int((d > STEP_TOL).sum()),
                     "m_cpu": float(mcf[i]), "m_card": float(mgf[i]),
                     "sqrt_v_cpu": float(vc.float().flatten()[i].sqrt()),
                     "sqrt_v_card": float(vg.float().cpu().flatten()[i]
                                          .sqrt()),
                     "leaf_max_abs_m": float(mcf.abs().max())}
    return out


def cpu_cases(dev, cases: dict, seq_parallel: bool = False,
              arch: str = "gpt2-paper") -> None:
    """``arch``'s smoke steps on the card against the plain versions on the
    CPU for each case ``phase: (strategy, dp_mode, pure_dp, microbatch,
    mesh, steps, (B1, B2) launches a step)``: same parameters (at the mesh's
    tp degree unless ``pure_dp``) and draws. Chained, the card's steps run
    from its own state: metrics, parameters and both AdamW moments within
    ``STEP_TOL`` (for a case in ``CHAIN_UNHELD`` recorded, with per-leaf
    readings, not held). Restarted, each card step after the first runs
    again from the CPU's state before it: the same within ``STEP_TOL``.
    The card's launches (both runs) exact."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws
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
    cfg = get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    cpu = torch.device("cpu")

    def worst(a, b):
        return max(float((x.detach().float() - y.detach().float().cpu())
                         .abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    def to(tree, device):
        return tree_map(lambda p: p.detach().clone().to(device), tree)

    def worst_state(a, b):
        return {"params": worst(a[0], b[0]), "adam_m": worst(a[1].m, b[1].m),
                "adam_v": worst(a[1].v, b[1].v)}

    def metrics_gap(a, b):
        return max(abs(x[n] - y[n]) for x, y in zip(a, b) for n in x)

    for phase, (strategy, mode, pure, micro, mesh, steps, per_step) in \
            cases.items():
        tp = 1 if pure or len(mesh) == 1 else mesh[1]
        base = init_params(k, cfg, device="cpu", tp=tp)
        sync = OptiReduceConfig(strategy=strategy, drop_rate=0.05,
                                drop_pattern="tail", hadamard_block=256,
                                skip_threshold=0.9,
                                pod_axis="model" if pure else None)
        tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=1e-2),
                         bucket_elems=16_384, seq_chunk=32, dp_mode=mode,
                         pure_dp=pure, microbatch=micro,
                         seq_parallel=seq_parallel)
        fns, state = {}, {}
        for name, device in (("cpu", cpu), ("cuda", dev)):
            fns[name], opt = build_train_step(cfg, tc, make_host_mesh(*mesh),
                                              device=device)
            params = to(base, device)
            state[name] = (params, opt.init(params))
        metrics = {"cpu": [], "cuda": [], "restart_cpu": [],
                   "restart_cuda": []}

        def run(name, device, st, step):
            skey = fold_in(k, step)
            params, opt_state, m = fns[name](
                st[0], st[1], data.host_batch(step, 0, 1), step, k,
                draws=_HostDraws(ThreefryDraws(
                    key=fold_in(skey, 7), cfg=sync, device=cpu), device),
                site_draws=_HostDraws(ThreefryDraws(
                    key=skey, cfg=sync, device=cpu), device))
            return (params, opt_state), {n: float(v) for n, v in m.items()}

        launched = (fwht_ops.launches, mm_ops.launches)
        restart = {"params": 0.0, "adam_m": 0.0, "adam_v": 0.0}
        for step in range(steps):
            # the CPU's state before the step, copied to the card before
            # the step updates it in place
            before = step and tuple(to(t, dev) for t in state["cpu"])
            state["cpu"], m_cpu = run("cpu", cpu, state["cpu"], step)
            state["cuda"], m_card = run("cuda", dev, state["cuda"], step)
            metrics["cpu"].append(m_cpu)
            metrics["cuda"].append(m_card)
            if step:
                # the same step on the card from the CPU's state before it
                again, m_again = run("cuda", dev, before, step)
                metrics["restart_cpu"].append(m_cpu)
                metrics["restart_cuda"].append(m_again)
                gaps = worst_state(state["cpu"], again)
                restart = {n: max(restart[n], v) for n, v in gaps.items()}
                del again
        launched = (fwht_ops.launches - launched[0],
                    mm_ops.launches - launched[1])
        chained = {"metrics": metrics_gap(metrics["cpu"], metrics["cuda"]),
                   **worst_state(state["cpu"], state["cuda"])}
        if steps > 1:
            restart["metrics"] = metrics_gap(metrics["restart_cpu"],
                                             metrics["restart_cuda"])
        held = phase not in CHAIN_UNHELD
        over = [n for n, v in chained.items() if v > STEP_TOL]
        leaves = (None if held and not over else _leaf_readings(
            state["cpu"][0], state["cuda"][0], state["cpu"][1],
            state["cuda"][1]))
        want = (per_step[0] * (2 * steps - 1), per_step[1] * (2 * steps - 1))
        emit({"phase": phase, "arch": cfg.name, "steps": steps,
              "strategy": strategy, "dp_mode": mode, "pure_dp": pure,
              "microbatch": micro, "mesh": list(mesh),
              "seq_parallel": seq_parallel,
              "max_abs_diff": chained, "chain_held": held,
              "chain_unheld_because": CHAIN_UNHELD.get(phase),
              "restart_max_abs_diff": restart if steps > 1 else None,
              "tolerance": STEP_TOL,
              "card_launches_b1_b2": list(launched),
              "cpu": metrics["cpu"], "gpu": metrics["cuda"],
              "gpu_restarted": metrics["restart_cuda"],
              "chained_leaf_readings": leaves})
        if not (all(v <= STEP_TOL for v in restart.values())
                and (not held or not over) and launched == want):
            fail(f"{phase}: card vs CPU chained {chained} (held: {held}), "
                 f"restarted {restart}, launches {launched} (expected "
                 f"{want})")
        del state
        free_card()


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
    # one step: its second was cut to pay for the SSM family over ranks
    "wire_main": ("optireduce", 1, {"fwht": 2, "masked_mean": 1}),
    "wire_q": ("optireduce_q", 1, {"fwht": 1, "ht_amax": 1, "ht_quant": 1,
                                   "dequant_mean": 1, "grid_quant": 1}),
    "wire_udp": ("optireduce", 1, {"fwht": 2, "masked_mean": 1}),
}
# the launcher's wire phases run gpt2-paper at full width with its depth
# cut to 1 of 12 layers: 8 buckets of 6,553,600 a step instead of 24 (a
# wire step is host Python, ~2.2 s a bucket)
WIRE_LAYERS = 1
WIRE_UDP_DEADLINE = "0.02"     # s a round: bounds the wait on lost packets
# s a bridge call may wait for the previous exchange before its mask
# degrades to all-ones (a miss): the launcher's own bound on a step's
# exchanges (``HostRing.flush``), not HostRing's default 10 s.  A
# full-width bridge call waits ~2.4 s over inproc and ~4.4 s over UDP on
# the H100's host (``bridge_host_s`` over ``bridge_calls``), and that host
# stalls for seconds at times, so at 10 s one stall became a miss; the
# check stays no miss at all
WIRE_BRIDGE_TIMEOUT_S = 30.0
KIND_NAMES = {1: "data1", 2: "data2", 3: "ctrl", 4: "relay"}


class _WireStats:
    """Counts what crosses a HostRing: datagrams and bytes of each kind
    (wrapping its backend's ``send``), the bridge's device-to-host and
    host-to-device bytes and the host seconds its calls held the training
    thread (in all, and the longest call); and the UDP receive buffer a
    socket really got.  Each ring it watches waits up to
    ``WIRE_BRIDGE_TIMEOUT_S`` for an exchange."""

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
        self.bridge_s = self.bridge_max_s = 0.0

    def snapshot(self) -> dict:
        return {"datagrams": dict(self.datagrams), "bytes": dict(self.bytes),
                "bridge_calls": self.calls, "d2h_bytes": self.d2h,
                "h2d_bytes": self.h2d, "bridge_host_s": self.bridge_s,
                "bridge_max_wait_s": self.bridge_max_s}

    def watch(self, ring):
        import socket
        from repro_torch.net import UdpBackend
        self.rings.append(ring)
        ring.bridge_timeout = WIRE_BRIDGE_TIMEOUT_S
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
            waited = time.perf_counter() - t0
            self.bridge_s += waited
            self.bridge_max_s = max(self.bridge_max_s, waited)
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
    from repro_torch.core.pipeline import ThreefryDraws, SyncContext
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
        draws = ThreefryDraws(key(0), cfg, dev)
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
    Launches exact, as on the lossy path; no bridge miss (within
    ``WIRE_BRIDGE_TIMEOUT_S``) or worker error; one ``wire[...]`` line a step with 4 peers. The inproc wire's
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
                         # one step, profiled: none ran without the profiler
                         None, records[-1]["step_s"] * 1e3,
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
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws, WireTransport
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
    base = init_params(k, cfg, device="cpu")
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
            draws = _HostDraws(ThreefryDraws(
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
MP_STEPS = 1
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
# s before each step's fence: the parent starts the respawned worker at the
# death (interpreter, torch, CUDA context) and releases it to join at the
# third step's fence; its restore and warm-up then hold the next fence
MP_KILL_SLEEP = "3"


def _mp_digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


def _hostring_digests(dev, strategy: str, elems: int, block: int,
                      steps: int, rate: float) -> tuple[dict, float]:
    """Each rank's output digest per step from one ``HostRing`` on the
    card under the launcher's scripted wire (``bernoulli_drops(rate,
    seed=3)``), data and draws (``KeyedDraws(fold_in(key(0), step))``, as
    the workers draw them); and its host seconds."""
    import numpy as np
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import KeyedDraws
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
            res, _ = ring.allreduce(
                data, KeyedDraws(fold_in(key(0), step), cfg, ring.device),
                step=step, bucket=0)
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
                                 ["skipped"] for r in trails
                                 if len(trails[r]) > kill_step + 1}})
    ok = (len(killed) == 1 and sorted(ranks) == list(range(PEERS))
          and all(len(t) == MP_KILL_STEPS for t in trails.values())
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
    from repro_torch.core.keys import key
    from repro_torch.models import init_params
    from repro_torch.train.elastic import fsdp_dims, gather_shards, reshard
    from repro_torch.tree import tree_leaves

    cfg = get_config("gpt2-paper")
    params = init_params(key(0), cfg, device=dev)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    dims = fsdp_dims(cfg, 1)

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


# ------------------------------------------- the model families (A21)
# families_main: (arch, layers) through the launcher at full width; the
# depth is cut where 4 peers' training state would not fit the card
# (PERF.md section 4): qwen2-moe-a2.7b to 1 of 24 layers (60 experts of
# 3 x 2048 x 1408 a layer); and mamba2-1.3b to 24 of 48 layers, as its
# profile ran it, to pay for the SSM family over ranks (dist_ssm_*)
FAMILIES_MAIN = (("smollm-360m", None), ("qwen2-moe-a2.7b", 1),
                 ("mamba2-1.3b", 24))
FAMILIES_STEPS = 2
HYBRID_LAYERS = 8          # one period of jamba-v0.1-52b (32 layers)
PREFIX_TOL = 1e-5          # card vs CPU lm_loss with a prefix, relative
PREFIX_GRAD_TOL = 1e-4     # ... its gradients, of each leaf's largest


def full_width(arch: str, layers: int | None = None):
    """``arch``'s published config, its depth cut to ``layers``."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def free_card() -> None:
    """Return what the last phase left to the allocator's cache."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def families_paths(counters: dict) -> None:
    """Phase ``families_main``: the launcher (``--arch``) on each
    ``FAMILIES_MAIN`` model at full width, 4 peers, ``optireduce``, tail
    drops 0.01, seq 128, global batch 8, AdamW, ``FAMILIES_STEPS`` steps:
    loss, loss_frac, step ms and peak bytes; B1 and B2 launches exactly 2
    and 1 a bucket a step, none of the others."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import count_params

    for arch, layers in FAMILIES_MAIN:
        cfg = full_width(arch, layers)
        n = count_params(cfg)
        buckets = -(-n // BUCKET)
        free_card()
        full_config = launch_train.get_config
        launch_train.get_config = lambda name: cfg
        try:
            counts, _ = train_main_path(
                "optireduce", FAMILIES_STEPS, counters,
                phase="families_main", arch=arch,
                label={"family": cfg.family, "layers": cfg.n_layers,
                       "params": n, "buckets": buckets})
        finally:
            launch_train.get_config = full_config
        want = {k: 0 for k in counters}
        want.update(fwht=2 * buckets * FAMILIES_STEPS,
                    masked_mean=buckets * FAMILIES_STEPS)
        if counts != want:
            fail(f"families_main {arch}: launch counts {counts} over "
                 f"{FAMILIES_STEPS} steps, expected {want}")
    free_card()


def hybrid_forward(dev) -> None:
    """Phase ``hybrid_fwd``: jamba-v0.1-52b at full width, one period
    (``HYBRID_LAYERS`` of 32 layers: Mamba-2 and attention 7:1, MoE every
    other layer), bf16 parameters from seed 0, ``lm_loss`` under
    ``torch.no_grad`` on a (8, 128) batch: the loss (finite, beside ln V),
    the first call's and the mean of 3 more calls' device ms, the peak."""
    import torch
    from repro_torch.core.keys import key
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import count_params

    free_card()
    torch.cuda.reset_peak_memory_stats()
    cfg = full_width("jamba-v0.1-52b", HYBRID_LAYERS)
    params = init_params(key(0), cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in data.host_batch(0, 0, 1).items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    with torch.no_grad():
        for _ in range(4):
            start.record()
            loss = lm_loss(params, batch, cfg, seq_chunk=128, remat=False)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    loss = float(loss)
    emit({"phase": "hybrid_fwd", "arch": cfg.name, "layers": cfg.n_layers,
          "params": count_params(cfg), "dtype": str(cfg.param_dtype),
          "batch": [8, 128], "loss": loss,
          "ln_vocab": math.log(cfg.vocab_size), "first_ms": ms[0],
          "ms": sum(ms[1:]) / 3,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if not (math.isfinite(loss) and loss > 0):
        fail(f"hybrid_fwd: loss {loss}")
    del params, batch
    free_card()


def check_families_against_cpu(dev) -> None:
    """Phase ``families_check``: every architecture's smoke config, 2
    steps on the card against 2 on the CPU, same parameters and draws, as
    ``fsdp_check`` (replicated, tail drops 0.05, buckets of 16,384: 2 B1 +
    1 B2 a bucket on the card); then ``prefix_check``: llava-smoke's and
    musicgen-smoke's ``lm_loss`` with an 8-position ``prefix_embeds`` on
    the card against the CPU, loss within ``PREFIX_TOL`` relative,
    gradients within ``PREFIX_GRAD_TOL`` of each leaf's largest."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.core.keys import key
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import count_params
    from repro_torch.tree import tree_leaves, tree_map

    for arch in (*ARCHS, "gpt2-paper"):
        b = -(-count_params(get_smoke(arch)) // 16_384)
        cpu_cases(dev, {"families_check": (
            "optireduce", "replicated", False, None, (PEERS,), 2,
            (2 * b, b))}, arch=arch)
    for arch in ("llava-next-mistral-7b", "musicgen-medium"):
        cfg = get_smoke(arch)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, size=(2, 17))
        batch = {"tokens": torch.as_tensor(toks[:, :-1]),
                 "labels": torch.as_tensor(toks[:, 1:]),
                 "prefix_embeds": torch.as_tensor(rng.standard_normal(
                     (2, 8, cfg.frontend_dim)).astype(np.float32))}
        base = init_params(key(0), cfg, device="cpu")
        res = {}
        for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            params = tree_map(lambda p: p.clone().to(device), base)
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = lm_loss(params, {k: v.to(device) for k, v in
                                    batch.items()}, cfg, seq_chunk=8)
            grads = torch.autograd.grad(loss, leaves)
            res[name] = (float(loss.detach()),
                         [g.detach().cpu() for g in grads])
        rel = abs(res["cpu"][0] - res["cuda"][0]) / abs(res["cpu"][0])
        g_rel = max(float((a - b).abs().max()) / max(float(a.abs().max()),
                                                     1e-30)
                    for a, b in zip(res["cpu"][1], res["cuda"][1]))
        emit({"phase": "prefix_check", "arch": cfg.name, "prefix": 8,
              "loss_cpu": res["cpu"][0], "loss_gpu": res["cuda"][0],
              "loss_rel_diff": rel, "grad_rel_diff": g_rel,
              "tolerance": [PREFIX_TOL, PREFIX_GRAD_TOL]})
        if not (rel <= PREFIX_TOL and g_rel <= PREFIX_GRAD_TOL):
            fail(f"prefix_check {arch}: loss {rel}, grads {g_rel}")


# ------------------------------------------------------ serving (A21)
# a 64-token prompt and 128 new: 191 decode steps (a 896-token prompt, to
# GPT-2's 1024-token context, was cut to 128 to pay for the pod grid over
# ranks, and to 64 for FSDP x TP over ranks)
SERVE_MAIN = ("--arch", "gpt2-paper", "--batch", "128", "--prompt-len",
              "64", "--max-new", "128")
SERVE_MAIN_STEPS = 191
# arch -> (batch, prompt, new); each at full depth through ``generate``
# (glm4-9b's 64 new and mamba2-1.3b's 128-token prompt were cut to 32 and
# 64 to pay for FSDP x TP over ranks; glm4-9b's and qwen2-moe's 64-token
# prompts to 32 and mamba2-1.3b's 64 new to 32 for the MoE family over
# ranks)
SERVE_FAMILIES = {"glm4-9b": (32, 32, 32), "qwen2-moe-a2.7b": (32, 32, 32),
                  "mamba2-1.3b": (32, 64, 32)}
SERVE_WARMUP = 4           # decode steps left out of the median
PREFILL_BATCH, PREFILL_LEN, PREFILL_NEW = 32, 1024, 32
GRID_STEPS = 16            # teacher-forced steps of a grid plan
LONG_SEQ = 32_768          # the sequence-sharded plan's cache, 4 x 8,192
STATIONARY_SEQ = 4_096     # qwen2-moe's sequence-sharded cache
SERVE_TOL = 1e-5           # card vs CPU, fp32 smoke configs: each state
                           # leaf within this of its largest magnitude
# bf16 at full width, the same model two ways (another summation order):
# the written cache rows within this of their largest magnitude
GRID_TOL = 0.05


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _DecodeClock:
    """Wraps ``decode_step`` where ``generate`` calls it: a CUDA event after
    each call (no synchronisation), so the gaps between events are each
    step's time on the card's clock, host-bound steps included."""

    def __init__(self):
        self.events = []
        self.state_bytes = 0

    @contextlib.contextmanager
    def around(self, module):
        import torch

        from repro_torch.tree import tree_leaves
        real = module.decode_step

        def timed(params, state, *args, **kw):
            if not self.events:
                self.state_bytes = _nbytes(tree_leaves(state))
            out = real(params, state, *args, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return out
        module.decode_step = timed
        try:
            yield self
        finally:
            module.decode_step = real

    def step_ms(self) -> list:
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                  self.events[1:])]


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _serve_row(clock: _DecodeClock, tokens: int, seconds: float,
               params_bytes: int) -> dict:
    """tok/s, ms a decode step (median after ``SERVE_WARMUP``), the
    state's bytes, the peak, and the bytes-bound of a step (the weights and
    the state read once)."""
    import torch
    ms = clock.step_ms()
    return {"tok_per_s": tokens / seconds, "seconds": seconds,
            "decode_steps": len(clock.events),
            "step_ms_median": _median(ms[SERVE_WARMUP:]),
            "step_ms_first": ms[:SERVE_WARMUP],
            "state_bytes": clock.state_bytes,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "step_bound_ms": (params_bytes + clock.state_bytes)
            / HBM_BYTES_PER_S * 1e3}


def _launch_snapshot(counters: dict) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def serve_main(counters: dict) -> None:
    """Phase ``serve_main``: ``repro_torch.launch.serve.main`` on the card,
    gpt2-paper at full width, ``SERVE_MAIN`` (``SERVE_MAIN_STEPS`` decode
    steps, the prompt teacher-forced): the launcher's two lines, tok/s, ms
    a step, the KV cache's and the peak bytes; the output (128, prompt +
    new) in vocab, no kernel of the repo launched (the serving path has
    none)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import count_params
    from repro_torch.serve import engine

    free_card()
    torch.cuda.reset_peak_memory_stats()
    before = _launch_snapshot(counters)
    out = io.StringIO()
    with _DecodeClock().around(engine) as clock, \
            contextlib.redirect_stdout(_Tee(sys.stdout, out)):
        rc = launch_serve.main(list(SERVE_MAIN))
    lines = out.getvalue().splitlines()
    m = re.match(r"generated \((\d+), (\d+)\) in ([0-9.]+)s", lines[0])
    seq = sum(int(SERVE_MAIN[SERVE_MAIN.index(flag) + 1])
              for flag in ("--prompt-len", "--max-new"))
    if rc != 0 or not m or (m.group(1), m.group(2)) != ("128", str(seq)):
        fail(f"serve_main: rc {rc}, lines {lines}")
    sample = json.loads(lines[1].removeprefix("sample: "))
    cfg = get_config("gpt2-paper")
    launches = {k: v - before[k] for k, v in
                _launch_snapshot(counters).items()}
    row = _serve_row(clock, 128 * 128, float(m.group(3)),
                     2 * count_params(cfg))
    emit({"phase": "serve_main", "argv": list(SERVE_MAIN), "lines": lines,
          "launches": launches, **row})
    if len(sample) != 128 or not all(0 <= t < cfg.vocab_size
                                     for t in sample):
        fail(f"serve_main: sample {sample}")
    if len(clock.events) != SERVE_MAIN_STEPS or any(launches.values()):
        fail(f"serve_main: {len(clock.events)} steps, launches {launches}")
    free_card()


def serve_families(dev) -> None:
    """Phase ``serve_families``: ``generate`` at full width and depth on
    each ``SERVE_FAMILIES`` model (bf16, random weights from seed 0): tok/s,
    ms a step, state and peak bytes, tokens in vocab. While qwen2-moe is
    loaded, its ``serve_grid`` plan (``weights_stationary_plan``)."""
    import torch
    from repro_torch.core.keys import key
    from repro_torch.models import init_params
    from repro_torch.models.transformer import count_params
    from repro_torch.serve import engine

    for arch, (b, prompt, new) in SERVE_FAMILIES.items():
        free_card()
        cfg = full_width(arch)
        params = init_params(key(0), cfg, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (b, prompt),
                                generator=_seeded(1, dev),
                                device=dev)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _DecodeClock().around(engine) as clock:
            out = engine.generate(params, cfg, prompts, max_new=new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = count_params(cfg)
        emit({"phase": "serve_families", "arch": arch, "family": cfg.family,
              "layers": cfg.n_layers, "params": n, "batch": b,
              "prompt": prompt, "new": new,
              **_serve_row(clock, b * new, seconds, 2 * n),
              "sample": out[0, -8:].tolist()})
        if (tuple(out.shape) != (b, prompt + new)
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
            fail(f"serve_families {arch}: output {tuple(out.shape)}")
        if arch == "qwen2-moe-a2.7b":
            weights_stationary_plan(dev, cfg, params)
        del params, prompts, out
    free_card()


def _grid_run(fn, params, state, toks, positions):
    """Teacher-forced steps of a serve step: each step's next tokens, and
    the step ms on the card's clock (events, no synchronisation)."""
    import torch
    nxt, events = [], []
    for i, pos in enumerate(positions):
        n, state = fn(params, state, toks[:, i:i + 1], pos)
        nxt.append(n)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return torch.cat(nxt, dim=1), state, ms


def _rows_err(a_state, b_state, positions, layers=None) -> float:
    """Max |a - b| over the K / V rows written at ``positions`` (of every
    layer, or of the repeats ``layers`` selects), over the largest
    magnitude there."""
    import torch

    from repro_torch.models.layers import KVCache
    idx = torch.tensor(positions, device=a_state[0].k.device)
    err = scale = 0.0
    for a, b in zip(a_state, b_state):
        if not isinstance(a, KVCache):
            continue
        for x, y in zip(a, b):
            if layers is not None:
                x, y = x[layers], y[layers]
            xa = x.index_select(-3, idx).float()
            ya = y.index_select(-3, idx).float()
            err = max(err, float((xa - ya).abs().max()))
            scale = max(scale, float(ya.abs().max()))
    return err / max(scale, 1e-30)


def weights_stationary_plan(dev, cfg, params) -> None:
    """``serve_grid`` case ``stationary``: qwen2-moe-a2.7b (all 24 layers)
    on 4 data peers under ``weight_fsdp`` + ``moe_stationary``, B 1, the
    sequence-sharded plan over a ``STATIONARY_SEQ`` cache, ``GRID_STEPS``
    teacher-forced steps, against the same plan with the expert weights
    gathered. Layer 0's attention and routing are the same in both, so the
    rows layer 1 writes differ only by the rounding of the first MoE's
    partial sums: within ``GRID_TOL``; deeper layers may route otherwise
    (recorded with the token agreement)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import build_serve_step, global_state, plan_serving

    mesh = make_host_mesh(dp=PEERS)
    plan = plan_serving(mesh, 1)
    toks = torch.randint(0, cfg.vocab_size, (1, GRID_STEPS),
                         generator=_seeded(2, dev),
                         device=dev)
    positions = list(range(GRID_STEPS))
    runs = {}
    for stationary in (True, False):
        state = global_state(cfg, batch=1, max_seq=STATIONARY_SEQ,
                             dtype=cfg.param_dtype, device=dev)
        fn, _ = build_serve_step(cfg, mesh, plan, weight_fsdp=True,
                                 moe_stationary=stationary)(state)
        torch.cuda.reset_peak_memory_stats()
        runs[stationary] = (*_grid_run(fn, params, state, toks, positions),
                            torch.cuda.max_memory_allocated())
    (got, state, ms, peak), (want, plain, ms_g, _) = runs[True], runs[False]
    err = _rows_err(state, plain, positions, layers=1)
    emit({"phase": "serve_grid", "case": "stationary", "arch": cfg.name,
          "layers": cfg.n_layers, "peers": PEERS, "batch": 1,
          "plan": "seq", "weight_fsdp": True, "moe_stationary": True,
          "cache_len": STATIONARY_SEQ, "steps": GRID_STEPS,
          "step_ms_median": _median(ms[SERVE_WARMUP:]),
          "tok_per_s": 1e3 / _median(ms[SERVE_WARMUP:]),
          "gathered_step_ms_median": _median(ms_g[SERVE_WARMUP:]),
          "state_bytes": _nbytes([t for st in state for t in st]),
          "peak_mem_bytes": peak,
          "token_agreement": float((got == want).float().mean()),
          "layer1_rows_rel_err": err,
          "all_rows_rel_err": _rows_err(state, plain, positions),
          "tolerance": GRID_TOL})
    if not err <= GRID_TOL:
        fail(f"serve_grid stationary: layer-1 rows {err} > {GRID_TOL}")


def serve_prefill_and_grid(dev) -> None:
    """Phases ``serve_prefill``, ``serve_grid`` (gpt2-paper cases) and
    ``profile`` of a decode step, on one set of gpt2-paper parameters (the
    launcher's: seed 0)."""
    from repro_torch.core.keys import key
    from repro_torch.models import init_params
    from repro_torch.models.transformer import count_params

    free_card()
    cfg = full_width("gpt2-paper")
    params = init_params(key(0), cfg, device=dev)
    pbytes = 2 * count_params(cfg)
    serve_prefill(dev, cfg, params)
    free_card()
    grid_batch_plan(dev, cfg, params, pbytes)
    free_card()
    grid_seq_plan(dev, cfg, params)
    free_card()
    grid_tp_plan(dev, cfg)
    free_card()
    profile_decode(dev, cfg, params)
    del params
    free_card()


def serve_prefill(dev, cfg, params) -> None:
    """Phase ``serve_prefill``: ``prefill_step`` on gpt2-paper at B
    ``PREFILL_BATCH`` and a ``PREFILL_LEN``-token prompt, against the
    teacher-forced loop over the same prompt (``decode_step`` from the zero
    state): the share of first tokens that agree, the fp32 logit margins
    (top 1 - top 2) of the rows that do not, the caches' difference; then
    ``PREFILL_NEW`` greedy steps from the prefill's state (padded to the
    longer cache) at ms a step. bf16 at full width may flip near-ties:
    recorded, not failed."""
    import torch
    from repro_torch.models import (decode_step, forward_hidden,
                                    init_decode_state, prefill_step)
    from repro_torch.models.layers import KVCache

    b, n, new = PREFILL_BATCH, PREFILL_LEN, PREFILL_NEW
    prompt = torch.randint(0, cfg.vocab_size, (b, n),
                           generator=_seeded(3, dev),
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    tok_pf, pf = prefill_step(params, {"tokens": prompt}, cfg)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    prefill_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        x = forward_hidden(params, {"tokens": prompt}, cfg, remat=False)
        logits = x[:, -1].float() @ params["embed"].float().T
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    del x, logits
    state = init_decode_state(None, cfg, batch=b, max_seq=n,
                              dtype=cfg.param_dtype, device=dev)
    tok = prompt[:, :1]
    for t in range(n):
        nxt, state = decode_step(params, state, tok, t, cfg)
        tok = prompt[:, t + 1:t + 2] if t + 1 < n else nxt
    agree = (tok_pf == tok)[:, 0]
    err = _rows_err(pf, state, list(range(0, n, 64)))
    del state
    # decode on from the prefill's state, its caches padded to n + new
    cont = init_decode_state(None, cfg, batch=b, max_seq=n + new,
                             dtype=cfg.param_dtype, device=dev)
    for c, p in zip(cont, pf):
        if isinstance(c, KVCache):
            c.k[:, :, :n].copy_(p.k)
            c.v[:, :, :n].copy_(p.v)
    tok = tok_pf
    nxt_ms = []
    for t in range(n, n + new):
        start.record()
        tok, cont = decode_step(params, cont, tok, t, cfg)
        end.record()
        torch.cuda.synchronize()
        nxt_ms.append(start.elapsed_time(end))
    emit({"phase": "serve_prefill", "arch": cfg.name, "batch": b,
          "prompt": n, "prefill_ms": prefill_ms,
          "prefill_tok_per_s": b * n / prefill_ms * 1e3,
          "prefill_peak_mem_bytes": prefill_peak,
          "kv_bytes": _nbytes([t for st in pf for t in st]),
          "first_token_agreement": float(agree.float().mean()),
          "disagreeing_margins": [margin[i] for i in range(b)
                                  if not bool(agree[i])],
          "margin_min": min(margin), "margin_median": _median(margin),
          "cache_rel_err_every_64th": err,
          "decode_after_prefill_steps": new,
          "decode_step_ms_median": _median(nxt_ms[SERVE_WARMUP:]),
          "decode_tok_per_s": b * 1e3 / _median(nxt_ms[SERVE_WARMUP:]),
          "decode_tokens_in_vocab": bool(0 <= int(tok.min())
                                         and int(tok.max())
                                         < cfg.vocab_size)})
    if not (0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size):
        fail(f"serve_prefill: token {tok.flatten().tolist()}")
    if not err <= GRID_TOL:
        fail(f"serve_prefill: prefill vs teacher-forced caches {err}")


def grid_batch_plan(dev, cfg, params, pbytes: int) -> None:
    """``serve_grid`` case ``batch``: gpt2-paper on 4 data peers at B 128,
    the batch-sharded plan over a 1,024-token cache, ``GRID_STEPS``
    teacher-forced steps: on a dense model the peers' rows are the plain
    step's, so tokens and caches must equal ``decode_step`` on one peer
    bitwise."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step
    from repro_torch.serve import build_serve_step, global_state, plan_serving
    from repro_torch.tree import tree_leaves

    b, s = 128, 1024
    mesh = make_host_mesh(dp=PEERS)
    plan = plan_serving(mesh, b)
    state = global_state(cfg, batch=b, max_seq=s,
                         dtype=cfg.param_dtype, device=dev)
    fn, _ = build_serve_step(cfg, mesh, plan)(state)
    toks = torch.randint(0, cfg.vocab_size, (b, GRID_STEPS),
                         generator=_seeded(4, dev),
                         device=dev)
    positions = list(range(GRID_STEPS))
    torch.cuda.reset_peak_memory_stats()
    got, state, ms = _grid_run(fn, params, state, toks, positions)
    peak = torch.cuda.max_memory_allocated()
    plain = global_state(cfg, batch=b, max_seq=s,
                         dtype=cfg.param_dtype, device=dev)
    want, plain, _ = _grid_run(
        lambda p, st, t, pos: decode_step(p, st, t, pos, cfg),
        params, plain, toks, positions)
    equal = bool(torch.equal(got, want)) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(state),
                                          tree_leaves(plain)))
    med = _median(ms[SERVE_WARMUP:])
    emit({"phase": "serve_grid", "case": "batch", "arch": cfg.name,
          "peers": PEERS, "batch": b, "plan": "batch", "cache_len": s,
          "steps": GRID_STEPS, "step_ms_median": med,
          "tok_per_s": b * 1e3 / med, "peak_mem_bytes": peak,
          "state_bytes": _nbytes(tree_leaves(state)),
          "step_bound_ms": (pbytes + _nbytes(tree_leaves(state)))
          / HBM_BYTES_PER_S * 1e3, "bitwise_plain": equal})
    if not equal:
        fail("serve_grid batch: the batch-sharded plan differs from the "
             "plain step")


def grid_seq_plan(dev, cfg, params) -> None:
    """``serve_grid`` case ``seq``: gpt2-paper on 4 data peers at B 1, the
    sequence-sharded plan over a ``LONG_SEQ`` cache filled with random
    values, one step at each side of every shard boundary (and the ends):
    each against the plain (unsharded) step on a copy of the same cache,
    tokens agreed, the written rows within ``GRID_TOL`` (another rounding
    of the softmax: fp32 merge of partial sums, as the reference's)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step
    from repro_torch.serve import build_serve_step, global_state, plan_serving
    from repro_torch.tree import tree_leaves

    mesh = make_host_mesh(dp=PEERS)
    plan = plan_serving(mesh, 1)
    state = global_state(cfg, batch=1, max_seq=LONG_SEQ,
                         dtype=cfg.param_dtype, device=dev)
    gen = _seeded(5, dev)
    for leaf in tree_leaves(state):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev))
    plain = [type(st)(*(t.clone() for t in st)) for st in state]
    fn, _ = build_serve_step(cfg, mesh, plan)(state)
    shard = LONG_SEQ // PEERS
    positions = [0] + [p for i in range(1, PEERS)
                       for p in (i * shard - 1, i * shard)] + [LONG_SEQ - 1]
    toks = torch.randint(0, cfg.vocab_size, (1, len(positions)),
                         generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    got, state, ms = _grid_run(fn, params, state, toks, positions)
    want, plain, _ = _grid_run(
        lambda p, st, t, pos: decode_step(p, st, t, pos, cfg),
        params, plain, toks, positions)
    err = _rows_err(state, plain, positions)
    emit({"phase": "serve_grid", "case": "seq", "arch": cfg.name,
          "peers": PEERS, "batch": 1, "plan": "seq", "cache_len": LONG_SEQ,
          "positions": positions, "step_ms": ms,
          "step_ms_median": _median(ms),
          "state_bytes": _nbytes(tree_leaves(state)),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "token_agreement": float((got == want).float().mean()),
          "rows_rel_err": err, "tolerance": GRID_TOL})
    if not err <= GRID_TOL:
        fail(f"serve_grid seq: written rows {err} > {GRID_TOL}")


def grid_tp_plan(dev, cfg) -> None:
    """``serve_grid`` case ``tp``: gpt2-paper at dp 1 x tp 2 (vocab padded
    to 50,258, ``wo`` and ``w_down`` two rounded partial products), B 32,
    a 1,024-token cache, ``GRID_STEPS`` teacher-forced steps, against the
    same weights at tp 1 (the padding row cut off): tokens agreed, written
    rows within ``GRID_TOL``."""
    import torch
    from repro_torch.core.keys import key
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_params
    from repro_torch.serve import build_serve_step, global_state, plan_serving
    from repro_torch.tree import tree_leaves

    b, s = 32, 1024
    mesh = make_host_mesh(dp=1, tp=2)
    plan = plan_serving(mesh, b)
    params = init_params(key(0), cfg, device=dev, tp=2)
    flat = {**params, "embed": params["embed"][:cfg.vocab_size]}
    state = global_state(cfg, batch=b, max_seq=s, tp=2,
                         dtype=cfg.param_dtype, device=dev)
    plain = global_state(cfg, batch=b, max_seq=s,
                         dtype=cfg.param_dtype, device=dev)
    fn, _ = build_serve_step(cfg, mesh, plan)(state)
    toks = torch.randint(0, cfg.vocab_size, (b, GRID_STEPS),
                         generator=_seeded(6, dev),
                         device=dev)
    positions = list(range(GRID_STEPS))
    torch.cuda.reset_peak_memory_stats()
    got, state, ms = _grid_run(fn, params, state, toks, positions)
    want, plain, _ = _grid_run(
        lambda p, st, t, pos: decode_step(p, st, t, pos, cfg),
        flat, plain, toks, positions)
    err = _rows_err(state, plain, positions)
    med = _median(ms[SERVE_WARMUP:])
    emit({"phase": "serve_grid", "case": "tp", "arch": cfg.name, "dp": 1,
          "tp": 2, "batch": b, "plan": "batch", "cache_len": s,
          "steps": GRID_STEPS, "step_ms_median": med,
          "tok_per_s": b * 1e3 / med,
          "state_bytes": _nbytes(tree_leaves(state)),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "token_agreement": float((got == want).float().mean()),
          "rows_rel_err": err, "tolerance": GRID_TOL})
    if not err <= GRID_TOL:
        fail(f"serve_grid tp: written rows {err} > {GRID_TOL}")


def profile_decode(dev, cfg, params) -> None:
    """Phase ``profile`` of one gpt2-paper decode step at B 128 against a
    1,024-token cache (position 960), as in 9.: device busy ms, idle share,
    launches a step, peak memory."""
    import torch
    from repro_torch.models import decode_step, init_decode_state

    b, s = 128, 1024
    state = init_decode_state(None, cfg, batch=b, max_seq=s,
                              dtype=cfg.param_dtype, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (b, 1),
                        generator=_seeded(7, dev), device=dev)

    def one(i):
        nonlocal state
        nxt, state = decode_step(params, state, tok, 960 + i, cfg)
        torch.cuda.synchronize()
    profile_third_step(one, {"path": "serve", "arch": cfg.name, "batch": b,
                             "cache_len": s, "position": 962})


def check_serving_against_cpu(dev) -> None:
    """Phase ``serve_check``: every smoke config (11 archs and
    gpt2-smoke) on the card against the CPU, same parameters: ``generate``
    ((2, 4) prompt, 4 new) tokens equal; then each grid plan teacher-forced
    (fp32 state): batch-sharded (dp 4, B 4), sequence-sharded (dp 4, B 1),
    ``weight_fsdp`` + ``moe_stationary`` sequence-sharded (MoE archs), dp 2
    x tp 2 (dense archs): tokens equal, every state leaf within
    ``SERVE_TOL`` of its largest magnitude."""
    import torch
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.core.keys import key
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import (build_serve_step, generate, global_state,
                                   plan_serving)
    from repro_torch.tree import tree_leaves, tree_map

    cpu = torch.device("cpu")
    worst = {}
    for arch in (*ARCHS, "gpt2-paper"):
        cfg = get_smoke(arch)
        plans = [("batch", 4, 1, 4, False), ("seq", 4, 1, 1, False)]
        if cfg.n_experts:
            plans.append(("stationary", 4, 1, 1, True))
        if cfg.family == "dense":
            plans.append(("tp", 2, 2, 2, False))
        prompts = torch.randint(0, cfg.vocab_size, (2, 4),
                                generator=_seeded(8))
        res = {}
        for name, device in (("cpu", cpu), ("cuda", dev)):
            params = init_params(key(0), cfg, device="cpu")
            params = tree_map(lambda p: p.to(device), params)
            res[name] = [("generate", generate(params, cfg,
                                                prompts.to(device),
                                                max_new=4), [])]
            for plan_name, dp, tp, b, stat in plans:
                p = params if tp == 1 else tree_map(
                    lambda t: t.to(device),
                    init_params(key(0), cfg, device="cpu", tp=tp))
                mesh = make_host_mesh(dp=dp, tp=tp)
                state = global_state(cfg, batch=b, max_seq=8, tp=tp,
                                     dtype=torch.float32, device=device)
                fn, _ = build_serve_step(cfg, mesh, plan_serving(mesh, b),
                                         weight_fsdp=stat,
                                         moe_stationary=stat)(state)
                toks = torch.randint(0, cfg.vocab_size, (b, 6),
                                     generator=_seeded(9)).to(device)
                nxt = []
                for t in range(6):
                    n, state = fn(p, state, toks[:, t:t + 1], t)
                    nxt.append(n)
                res[name].append((plan_name, torch.cat(nxt, dim=1),
                                  tree_leaves(state)))
        for (plan_name, a_tok, a_st), (_, g_tok, g_st) in zip(res["cpu"],
                                                              res["cuda"]):
            err = max((float((g.cpu() - a).abs().max())
                       / max(float(a.abs().max()), 1e-30)
                       for a, g in zip(a_st, g_st)), default=0.0)
            worst[f"{arch}/{plan_name}"] = err
            if not torch.equal(a_tok, g_tok.cpu()) or not err <= SERVE_TOL:
                fail(f"serve_check {arch} {plan_name}: tokens "
                     f"{a_tok.tolist()} vs {g_tok.tolist()}, state {err}")
    emit({"phase": "serve_check", "cases": len(worst),
          "max_state_rel_err": max(worst.values()),
          "worst_case": max(worst, key=worst.get), "tolerance": SERVE_TOL})


# ------------------- the families over tensor parallelism (A21c), dry run
# tp_families_main: (arch, layers, extra launcher flags) through the
# launcher at full width, --dp 2 --tp 2 (PERF.md section 4 lists the cuts)
TP_FAMILIES_MAIN = (("qwen2-moe-a2.7b", 1, ()),
                    ("mamba2-1.3b", 12, ()),
                    ("llava-next-mistral-7b", 2, ("--seq-parallel",
                                                  "--prefix")))
TP_FAMILIES_STEPS = 2
# the first step at tp 2 against tp 1, same parameters and batch, no
# drops, in fp32: the loss and the gradient norm after the sync. bf16
# cannot hold the norm, nor can fp32 for mamba2-1.3b: its random-init gradient is ill-conditioned
# (ROADMAP C; tools/mamba2_conditioning.py), and 12 layers at full width
# left 3.1e-3 between tp 2 and tp 1 in fp32 on an H100. So its pair runs
# in fp64 (TP_GRAD_DTYPE), where rounding's share shrinks to the fp32
# arena's and norm's own (~1e-7)
TP_LOSS_TOL = 1e-4
TP_GRAD_TOL = 1e-4
TP_GRAD_DTYPE = {"mamba2-1.3b": "float64"}
# fp32 at full width, tp T against tp 1 on the same weights (the T
# rounded partial products summed in another order): layer 1's state (the
# first behind a sum over tp) within TP_LAYER1_TOL of its largest
# magnitude, every layer's within its arch's TP_SERVE_TOL. Random-init
# mamba2-1.3b has no gated norm (ROADMAP C): its 48 layers grow the gap
# 1.2-1.3x a layer, so the same comparison in fp64 (TP_SERVE_FP64_ARCHS)
# must fall within TP_SERVE_FP64_TOL: a rounding gap shrinks with the unit
# roundoff (~2e-9 of fp32's), a wrong head or partial would not
TP_LAYER1_TOL = 1e-5
# mamba2-1.3b's bound is set from its readings: random-init Mamba-2
# amplifies fp32 rounding 1.2-1.3x a layer, to 2.64e-3 on one weight draw
# and 4.568e-2 (layer 45) on the reference's threefry draw, the same to
# every digit in two runs on an H100; its fp64 run reads 7.2e-12 there
TP_SERVE_TOL = {"qwen2-moe-a2.7b": 1e-5, "mamba2-1.3b": 1e-1,
                "jamba-v0.1-52b": 1e-4}
TP_SERVE_FP64_ARCHS = ("mamba2-1.3b",)
TP_SERVE_FP64_TOL = 1e-8
# arch -> (layers, tp, batch, prompt, new): generate over tp at full width
# (jamba's 256-token prompt cut to 128 for the MoE family over ranks)
TP_SERVE_FAMILIES = {"qwen2-moe-a2.7b": (None, 8, 32, 64, 32),
                     "mamba2-1.3b": (None, 2, 32, 128, 64),
                     "jamba-v0.1-52b": (8, 2, 8, 128, 32)}
NON_DENSE = ("qwen2-moe-a2.7b", "arctic-480b", "mamba2-1.3b",
             "jamba-v0.1-52b", "llava-next-mistral-7b", "musicgen-medium")
DRYRUN_TIMEOUT_S = 600


def local_buckets(cfg, tp: int, bucket: int) -> tuple[int, int]:
    """One tp rank's local parameter count at ``tp`` and its buckets: the
    arena one tp group packs (``trainer.to_tp``'s chunks)."""
    from repro_torch.models import param_table
    from repro_torch.models.transformer import _map_table

    n = 0

    def add(leaf):
        nonlocal n
        n += math.prod(leaf.shape) // (tp if leaf.tp_dim is not None else 1)
    _map_table(add, param_table(cfg, tp=tp))
    return max(1, -(-n // bucket)), n


def tp_families_paths(counters: dict) -> dict:
    """Phase ``tp_families_main``: the launcher (``--arch``) on each
    ``TP_FAMILIES_MAIN`` model at full width with ``--dp 2 --tp 2``,
    optireduce, tail drops 0.01, seq 128, global batch 8, AdamW,
    ``TP_FAMILIES_STEPS`` steps (llava with ``--seq-parallel`` and its
    2,048-patch prefix): loss, loss_frac, step ms and peak bytes; B1 and B2
    launches exactly 2 and 1 a bucket of one tp rank's local leaves a step
    (both tp groups in one launch), none of the others. Then one step each
    at ``--tp 2`` and ``--tp 1`` without drops on the parameters in fp32
    (``TP_GRAD_DTYPE`` where fp32 is too narrow): losses within
    ``TP_LOSS_TOL``, gradient norms within ``TP_GRAD_TOL``. Returns each
    arch's one-step records of those runs (``wide_tp2``, ``wide_tp1``), and
    for ``DIST_SSM_ARCH`` the ``wide_tp1`` step's leaves replicated over tp
    and their moments (``replicated``; ``dist_ssm_float64`` holds its
    ranks against them), for ``DIST_FRONTEND_ARCH`` the first run's
    records, last parameters, launches a step, seconds and leaves
    replicated over tp with their moments (``dist_stacked``:
    ``dist_frontend_main``'s stacked side, the same flags)."""
    import dataclasses

    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import count_params
    distcheck = _distcheck()

    def rel(a, b, k):
        return abs(a[0][k] - b[0][k]) / abs(b[0][k])

    full_config = launch_train.get_config
    records = {}
    for arch, layers, extra in TP_FAMILIES_MAIN:
        cfg = full_width(arch, layers)
        buckets, local = local_buckets(cfg, TP, BUCKET)
        exact = ("--drop-rate", "0", *extra)
        try:
            launch_train.get_config = lambda _: cfg
            free_card()
            # DIST_FRONTEND_ARCH's run is dist_frontend_main's stacked side
            reuse = arch == DIST_FRONTEND_ARCH
            t0 = time.perf_counter()
            with (distcheck.watch_steps(keep=True, steps=0) if reuse
                  else contextlib.nullcontext()) as seen:
                counts, recs = train_main_path(
                    "optireduce", TP_FAMILIES_STEPS, counters,
                    phase="tp_families_main", arch=arch, loss_seen=False,
                    extra=("--dp", "2", "--tp", str(TP), *extra),
                    label={"family": cfg.family, "layers": cfg.n_layers,
                           "params": count_params(cfg), "tp_local": local,
                           "buckets": buckets})
            wide = TP_GRAD_DTYPE.get(arch, "float32")
            runs = {}
            if reuse:
                runs["dist_stacked"] = {
                    "records": recs, "params": seen["params"],
                    "launches": seen["launches"],
                    "seconds": time.perf_counter() - t0,
                    "replicated": distcheck.replicated_leaves(
                        seen["cfg"], TP, seen["last"], seen["last_state"])}
                del seen
            launch_train.get_config = lambda _: dataclasses.replace(
                cfg, param_dtype=getattr(torch, wide))
            for name, tp in (("wide_tp2", TP), ("wide_tp1", 1)):
                free_card()
                keep = arch == DIST_SSM_ARCH and name == "wide_tp1"
                with (distcheck.watch_steps(steps=0) if keep
                      else contextlib.nullcontext()) as seen:
                    runs[name] = train_main_path(
                        "optireduce", 1, counters,
                        phase=f"tp_families_{name.replace('wide', wide)}",
                        arch=arch, loss_seen=False,
                        extra=("--dp", "2", "--tp", str(tp), *exact))[1]
                if keep:
                    runs["replicated"] = distcheck.replicated_leaves(
                        seen["cfg"], TP, seen["last"], seen["last_state"])
                    del seen
        finally:
            launch_train.get_config = full_config
        records[arch] = runs
        want = {k: 0 for k in counters}
        want.update(fwht=2 * buckets * TP_FAMILIES_STEPS,
                    masked_mean=buckets * TP_FAMILIES_STEPS)
        gaps = {f"loss_{wide}": rel(runs["wide_tp2"], runs["wide_tp1"],
                                    "loss"),
                f"grad_norm_{wide}": rel(runs["wide_tp2"], runs["wide_tp1"],
                                         "grad_norm")}
        emit({"phase": "tp_families_vs_tp1", "arch": arch,
              "loss_tp2": recs[0]["loss"],
              f"grad_norm_{wide}": [runs["wide_tp2"][0]["grad_norm"],
                                    runs["wide_tp1"][0]["grad_norm"]],
              "rel_diff": gaps,
              "tolerance": {"loss": TP_LOSS_TOL, "grad_norm": TP_GRAD_TOL}})
        if counts != want:
            fail(f"tp_families_main {arch}: launch counts {counts} over "
                 f"{TP_FAMILIES_STEPS} steps, expected {want}")
        if not (gaps[f"loss_{wide}"] <= TP_LOSS_TOL
                and gaps[f"grad_norm_{wide}"] <= TP_GRAD_TOL):
            fail(f"tp_families_main {arch}: tp 2 against tp 1 {gaps}")
    free_card()
    return records


def _layer_errs(a_state, b_state, positions) -> list:
    """Each layer's error, in model order (layer r x period + p): its
    written K / V rows (attention) or its SSM states (conv tail and SSD
    state), max |a - b| over the largest magnitude there, taken in fp64
    (an fp32 cast would round fp64 states before the difference)."""
    import torch

    from repro_torch.models.layers import KVCache
    period = len(a_state)
    idx = torch.tensor(positions, device=a_state[0][0].device)
    errs = {}
    for p, (a, b) in enumerate(zip(a_state, b_state)):
        for r in range(a[0].shape[0]):
            err = scale = 0.0
            for x, y in zip(a, b):
                x, y = x[r].double(), y[r].double()
                if isinstance(a, KVCache):
                    x, y = x.index_select(-3, idx), y.index_select(-3, idx)
                err = max(err, float((x - y).abs().max()))
                scale = max(scale, float(y.abs().max()))
            errs[r * period + p] = err / max(scale, 1e-30)
    return [errs[k] for k in sorted(errs)]


def _cast(tree, dtype) -> None:
    """Cast every tensor of a dict / list tree to ``dtype`` in place, one
    leaf at a time (the old leaf freed as its copy replaces it)."""
    import torch
    for k in list(tree.keys() if isinstance(tree, dict)
                  else range(len(tree))):
        if isinstance(tree[k], torch.Tensor):
            tree[k] = tree[k].to(dtype)
        else:
            _cast(tree[k], dtype)


def tp_serve_families(dev) -> None:
    """Phase ``tp_serve_families``: ``generate`` over tp at full width on
    each ``TP_SERVE_FAMILIES`` model (bf16, random weights from seed 0,
    padded for tp: qwen2-moe's 60 experts to 64 at tp 8): tok/s, ms a
    step, state and peak bytes, tokens in vocab; then, the weights cast to
    fp32 in place, ``GRID_STEPS`` teacher-forced steps of
    ``build_serve_step`` at dp 1 x tp T against the same weights at tp 1:
    tokens agreed; layer 1's written K / V rows or SSM states (the first
    layer behind a sum over tp) within ``TP_LAYER1_TOL`` of their largest
    magnitude, every layer's within its arch's ``TP_SERVE_TOL``; for
    ``TP_SERVE_FP64_ARCHS`` the same steps again in
    fp64, every layer's within ``TP_SERVE_FP64_TOL``."""
    import dataclasses

    import torch
    from repro_torch.core.keys import key
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ParallelCtx, decode_step, init_params
    from repro_torch.models.transformer import count_params
    from repro_torch.serve import (build_serve_step, engine, global_state,
                                   plan_serving)
    from repro_torch.tree import tree_leaves

    for arch, (layers, tp, b, prompt, new) in TP_SERVE_FAMILIES.items():
        free_card()
        cfg = full_width(arch, layers)
        params = init_params(key(0), cfg, device=dev, tp=tp)
        n = sum(p.numel() for p in tree_leaves(params))
        prompts = torch.randint(0, cfg.vocab_size, (b, prompt),
                                generator=_seeded(1, dev),
                                device=dev)
        pctx = ParallelCtx(tp_axis="model", sizes={"model": tp})
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _DecodeClock().around(engine) as clock:
            out = engine.generate(params, cfg, prompts, max_new=new,
                                  pctx=pctx)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        row = _serve_row(clock, b * new, seconds, 2 * n)
        if (tuple(out.shape) != (b, prompt + new)
                or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size):
            fail(f"tp_serve_families {arch}: output {tuple(out.shape)}")
        del out
        free_card()
        # the comparison in fp32: in bf16 the T rounded partial sums flip
        # MoE routes from layer 0 on (qwen2 at tp 8: layer 1's rows 0.17
        # apart, tokens 0.79 agreed on an H100)
        mesh = make_host_mesh(dp=1, tp=tp)
        positions = list(range(GRID_STEPS))
        toks = prompts[:, :GRID_STEPS]
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float64 and arch not in TP_SERVE_FP64_ARCHS:
                break
            _cast(params, dtype)
            cfg = dataclasses.replace(cfg, param_dtype=dtype)
            state = global_state(cfg, batch=b, max_seq=GRID_STEPS, tp=tp,
                                 dtype=dtype, device=dev)
            plain = global_state(cfg, batch=b, max_seq=GRID_STEPS,
                                 dtype=dtype, device=dev)
            fn, _ = build_serve_step(cfg, mesh, plan_serving(mesh, b))(state)
            got, state, ms = _grid_run(fn, params, state, toks, positions)
            want, plain, _ = _grid_run(
                lambda p, st, t, pos: decode_step(p, st, t, pos, cfg),
                params, plain, toks, positions)
            per_layer = _layer_errs(state, plain, positions)
            del state, plain
            if dtype == torch.float64:
                emit({"phase": "tp_serve_families_fp64", "arch": arch,
                      "tp": tp, "grid_steps": GRID_STEPS,
                      "token_agreement": float((got == want).float().mean()),
                      "layer_rel_err": per_layer,
                      "tolerance": TP_SERVE_FP64_TOL})
                if not max(per_layer) <= TP_SERVE_FP64_TOL:
                    fail(f"tp_serve_families {arch}: fp64 layer errors "
                         f"{per_layer}")
                continue
            emit({"phase": "tp_serve_families", "arch": arch,
                  "family": cfg.family, "layers": cfg.n_layers,
                  "params": count_params(cfg), "params_padded": n, "tp": tp,
                  "batch": b, "prompt": prompt, "new": new, **row,
                  "grid_steps": GRID_STEPS,
                  "grid_step_ms_median": _median(ms[SERVE_WARMUP:]),
                  "token_agreement": float((got == want).float().mean()),
                  "layer_rel_err": per_layer,
                  "tolerance": [TP_LAYER1_TOL, TP_SERVE_TOL[arch]]})
            if not (per_layer[1] <= TP_LAYER1_TOL
                    and max(per_layer) <= TP_SERVE_TOL[arch]):
                fail(f"tp_serve_families {arch}: layer errors {per_layer}")
        del params, prompts
    free_card()


def check_tp_families_against_cpu(dev) -> None:
    """Phase ``tp_families_check``: every non-dense smoke config at ``(data
    2, model 2)``, qwen2-moe-smoke at ``(data 2, model 4)`` (its 6 experts
    padded to 8) and llava-smoke under ``seq_parallel``: 2 steps on the
    card against 2 on the CPU as ``tp_check``, buckets of 16,384 of one tp
    rank's local leaves (2 B1 + 1 B2 each)."""
    from repro_torch.configs import get_smoke

    for arch in NON_DENSE:
        b = local_buckets(get_smoke(arch), TP, 16_384)[0]
        cpu_cases(dev, {"tp_families_check": (
            "optireduce", "replicated", False, None, (2, TP), 2,
            (2 * b, b))}, arch=arch)
    b = local_buckets(get_smoke("qwen2-moe-a2.7b"), 4, 16_384)[0]
    cpu_cases(dev, {"tp_families_check_tp4": (
        "optireduce", "replicated", False, None, (2, 4), 2, (2 * b, b))},
        arch="qwen2-moe-a2.7b")
    b = local_buckets(get_smoke("llava-next-mistral-7b"), TP, 16_384)[0]
    cpu_cases(dev, {"tp_families_check_sp": (
        "optireduce", "replicated", False, None, (2, TP), 2, (2 * b, b))},
        seq_parallel=True, arch="llava-next-mistral-7b")


def start_netsim():
    """Phase ``netsim`` in a process of its own: this script with
    ``--netsim`` (host only; it overlaps the card's phases)."""
    import atexit

    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--netsim"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_netsim(proc) -> None:
    """Wait for the netsim process and print its phase lines."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"netsim: not done in {DRYRUN_TIMEOUT_S} s")
    print(out, end="", flush=True)
    if proc.returncode != 0:
        fail(f"netsim: rc {proc.returncode}")


def start_dryrun(out_path: Path):
    """Phase ``dryrun``: ``python -m repro_torch.launch.dryrun --all`` in a
    process of its own (host only, on the ``meta`` device: it overlaps the
    card's phases), writing ``out_path``."""
    import atexit

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_dryrun(proc, out_path: Path) -> float:
    """Wait for the dry run; every one of the 40 cells ok or skipped as
    ``shape_applicable`` gives them (8 long_500k cells of full-attention
    archs), each with its state bytes and ``matmul_flops``. Returns its
    seconds by its own ``done`` line."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dryrun: not done in {DRYRUN_TIMEOUT_S} s")
    done = re.search(r"^done: (\d+) cells, (\d+) errors in ([0-9.]+)s$",
                     out, re.M)
    if proc.returncode != 0 or not done:
        fail(f"dryrun: rc {proc.returncode}: {out[-2000:]}")
    with open(out_path) as f:
        recs = json.load(f)
    cells = [{"arch": r["arch"], "shape": r["shape"], "status": r["status"],
              "state_bytes_per_device": r.get("state_bytes_per_device",
                                              {}).get("total"),
              "matmul_flops": r.get("cost_model", {}).get("matmul_flops"),
              "seconds": r.get("seconds")} for r in recs]
    skipped = sum(r["status"] == "skipped" for r in recs)
    seconds = float(done.group(3))
    emit({"phase": "dryrun", "mesh": "16x16", "cells": len(recs),
          "errors": int(done.group(2)), "skipped": skipped,
          "seconds": seconds, "by_cell": cells})
    ok = (len(recs) == 40 and skipped == 8
          and all(r["status"] in ("ok", "skipped") for r in recs)
          and all(c["matmul_flops"] and c["state_bytes_per_device"]
                  for c in cells if c["status"] == "ok"))
    if not ok:
        fail(f"dryrun: {cells}")
    return seconds


# --------------------------------- the reference's last modules (A2, A7,
# A9, A10): threefry draws on the card (T1), the batched sync, Adafactor,
# chunked attention
INT32_OPS_PER_S = 67e12 / 2   # integer adds, shifts and logic issue on the
#                               INT32 and the FP32 pipes (IMAD): 128 lanes
#                               an SM, the guide's 67 TFLOP/s fp32 / 2 flops
THREEFRY_OPS = 68             # 32-bit integer ops a value: 20 rounds of 3
#                               (add, funnel shift, xor), 5 injections into
#                               x1 (x0's fold into the next round's 3-input
#                               add), the closing xor, shift and or
THC_DRAW = 148_304 * 1024     # THC's shared noise, one draw
DRAWS_STEPS = 2
VMAP_STEPS = 2
# T1 launches a step: a bucket's sign (drawn once, cached for the decode),
# its receivers' masks in one draw, and a quantizer's two noises
T1_PER_STEP = {"optireduce": 2 * ARENA_BUCKETS,
               "optireduce_q": 4 * ARENA_BUCKETS}
T1_PER_STEP_VMAP = {"optireduce": 2, "optireduce_q": 4}
CHUNK_SEQ = 8192              # 2 query blocks of gpt2-paper's attn_chunk
PREFILL_32K = 32_768          # the reference's prefill_32k sequence
PREFILL_32K_BATCH = 2         # cut from the shape's 32 to fit one card
CHUNK_DENSE_TOL = 1e-4        # fp32 chunked vs dense attention, relative to
#                               the output's largest entry: the online
#                               softmax rescales and sums in another order


def threefry_bound(values: int) -> tuple[float, str]:
    """T1's least time: its fp32 output written once against its integer
    work."""
    t_bytes = 4 * values / HBM_BYTES_PER_S * 1e3
    t_ops = THREEFRY_OPS * values / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_threefry(dev) -> dict:
    """Phase ``threefry``: T1 against its plain version (``ref.py``) on the
    card, bit for bit, at the paths' shapes: a bucket's tail-pattern
    timeouts (4 receivers' keys, 4 senders), Bernoulli masks of a shard
    (6,400 packets of 4 senders), the 24 buckets' signs in one (24, 2) key
    batch, a stage-1 noise (6,400 x 1024) and 24 stage-2 ones, an init
    normal (gpt2-paper's embedding) and THC's (148,304 x 1024) shared
    noise; timed at THC's shape, with its bound. Returns the THC row."""
    import torch
    from repro_torch.core import keys
    from repro_torch.kernels.threefry import ops as tf_ops
    from repro_torch.kernels.threefry import ref as tf_ref

    def batch(n):
        return keys.batch_keys([keys.fold_in(keys.key(0), i)
                                for i in range(n)])
    pkts = SHARD // 256
    cases = (("tail_timeouts", batch(4), PEERS, "bernoulli", 0.04),
             ("bernoulli_masks", batch(4), PEERS * pkts, "bernoulli", 0.99),
             ("signs", batch(ARENA_BUCKETS), BLOCK, "bernoulli", 0.5),
             ("noise_stage1", batch(1), PEER_BLOCKS * BLOCK, "uniform", 0.0),
             ("noise_stage2", batch(ARENA_BUCKETS), SHARD, "uniform", 0.0),
             ("init_normal", batch(1), 50_304 * 768, "normal", 0.0),
             ("thc_noise", batch(1), THC_DRAW, "uniform", 0.0))
    thc = None
    for name, ks, n, mode, a in cases:
        kt = torch.from_numpy(ks.astype("int64"))
        got = tf_ops.draw_launch(ks, n, mode, a, 1.0, dev)
        want = tf_ref.draw_ref(kt, n, mode, a, 1.0, dev)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got.view(torch.int32),
                                 want.view(torch.int32)))
        err = float((got - want).abs().max())
        row = {"phase": "threefry", "case": name, "keys": int(ks.shape[0]),
               "n": n, "mode": mode, "bitwise_equal": equal,
               "max_abs_err": err}
        del got, want
        if name == "thc_noise":
            ms = time_ms(lambda: tf_ops.draw_launch(ks, n, mode, a, 1.0, dev),
                         reps=10)
            plain_ms = time_ms(lambda: tf_ref.draw_ref(kt, n, mode, a, 1.0,
                                                       dev), reps=2, warmup=1)
            b_ms, b_by = threefry_bound(n)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
            thc = row
        emit(row)
        free_card()
        if not equal:
            fail(f"threefry {name}: not bitwise its plain version ({err})")
    return thc


def _normal_leaves(cfg) -> int:
    """The leaves ``init_params`` draws (one T1 launch each on the card)."""
    from repro_torch.models.transformer import _walk, param_table
    return sum(leaf.init not in ("zeros", "ones")
               for _, leaf in _walk(param_table(cfg)))


def draws_main(dev, counters: dict) -> dict:
    """Phase ``draws_main``: ``optireduce`` and ``optireduce_q`` through the
    launcher at full width, 2 steps, the default draws (T1 counted with the
    other kernels: one normal a leaf at init, then ``T1_PER_STEP`` a step);
    then step 0's signs, masks and noises drawn on the card against the
    same draws on the CPU, bit for bit (the trainer's sync key
    ``fold_in(fold_in(key(0), 0), 7)``), and the host µs of a step's key
    derivation. Returns each run's launches."""
    import torch
    from repro_torch.core import drops as drops_lib
    from repro_torch.core import keys as keys_lib
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws
    from repro_torch.kernels import runtime
    from repro_torch.kernels.threefry import ops as tf_ops

    with_t1 = {**counters, "threefry": (tf_ops, "launches")}
    init = _normal_leaves(full_width("gpt2-paper"))
    none = {k: 0 for k in with_t1}
    want = {"optireduce": {**none, "fwht": 48, "masked_mean": 24},
            "optireduce_q": {**none, "fwht": 24, "ht_amax": 24,
                             "ht_quant": 24, "dequant_mean": 24,
                             "grid_quant": 24}}
    out = {}
    for strategy, per_step in want.items():
        per_step = {**per_step, "threefry": T1_PER_STEP[strategy]}
        counts, _ = train_main_path(strategy, DRAWS_STEPS, with_t1,
                                    phase="draws_main")
        expect = {k: v * DRAWS_STEPS for k, v in per_step.items()}
        expect["threefry"] += init
        if counts != expect:
            fail(f"draws_main {strategy}: launches {counts}, expected "
                 f"{expect}")
        out[strategy] = counts
        free_card()
    runtime.set_kernel_mode(None)     # the launcher left it at 'kernel'
    cfg = OptiReduceConfig(drop_rate=0.01, drop_pattern="tail",
                           hadamard_block=BLOCK)
    skey = fold_in(fold_in(key(0), 0), 7)
    cpu = torch.device("cpu")
    card, host = (ThreefryDraws(skey, cfg, d) for d in (dev, cpu))
    buckets = list(range(ARENA_BUCKETS))
    rows = [(b, r, r) for b in range(0, ARENA_BUCKETS, 6)
            for r in range(PEERS)]
    checks = {
        "signs": (card.signs(buckets, BLOCK), host.signs(buckets, BLOCK)),
        "masks": (card.masks(rows, PEERS, SHARD),
                  host.masks(rows, PEERS, SHARD)),
        "noise3": (card.noise(0, 3, (PEER_BLOCKS, BLOCK)),
                   host.noise(0, 3, (PEER_BLOCKS, BLOCK))),
        "noise4": (card.noise(23, 4, (SHARD // BLOCK, BLOCK)),
                   host.noise(23, 4, (SHARD // BLOCK, BLOCK)))}
    equal = {k: bool(torch.equal(a.cpu(), b)) for k, (a, b) in checks.items()}
    dropped = float((1.0 - checks["masks"][1]).mean())
    # a step's key derivation on the host, as the sync engine derives it:
    # each bucket's site key, its receivers' mask keys and the tail
    # pattern's splits of them, the quantizer's two noise keys
    t0 = time.perf_counter()
    for b in buckets:
        site = fold_in(skey, b)
        drops_lib._split_keys(keys_lib.batch_keys(
            [fold_in(site, r) for r in range(PEERS)]))
        fold_in(site, 3), fold_in(site, 4)
    derive_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "draws_check", "sync_key": list(skey),
          "bitwise_equal_cpu": equal, "mask_rows": len(rows),
          "mask_drop_fraction": dropped,
          "host_us_key_derivation_a_step": derive_us,
          "launches_per_step": {s: {k: (v - (init if k == "threefry" else 0))
                                    / DRAWS_STEPS for k, v in c.items()}
                                for s, c in out.items()}})
    del checks
    free_card()
    if not all(equal.values()):
        fail(f"draws_check: card draws differ from the CPU's: {equal}")
    return out


def vmap_main(dev, counters: dict) -> dict:
    """Phase ``vmap_main``: the strategies' arena (4, 24, 6,553,600) through
    every strategy in ``vmap`` and in ``scan`` (drops 0.01 tail where the
    strategy has them), bitwise bucket for bucket, with device ms and peak
    bytes; then the launcher with ``--sync-mode vmap`` on ``optireduce``
    and ``optireduce_q``, 2 steps: launches exactly 2 B1 + 1 B2 a step, and
    one each of B1, B3-B6, with ``T1_PER_STEP_VMAP`` T1. Returns the
    launcher runs' launches."""
    import torch
    from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import SyncContext, ThreefryDraws
    from repro_torch.kernels.threefry import ops as tf_ops

    gen = _seeded(5, dev)
    arena = torch.empty((PEERS, ARENA_BUCKETS, BUCKET), device=dev)
    for p in range(PEERS):
        arena[p].normal_(generator=gen).mul_(1.0 + 0.25 * p)
    with_t1 = {**counters, "threefry": (tf_ops, "launches")}
    for strategy in STRATEGIES:
        cfg = OptiReduceConfig(strategy=strategy,
                               drop_rate=0.01 if strategy in LOSSY else 0.0,
                               drop_pattern="tail", hadamard_block=BLOCK,
                               incast=ROUNDS_INCAST)
        res = {}
        for mode in ("scan", "vmap"):
            ctx = SyncContext(cfg=cfg, draws=ThreefryDraws(
                fold_in(key(0), 7), cfg, dev))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for mod, attr in with_t1.values():
                setattr(mod, attr, 0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = sync_packed(arena, ctx, mode=mode)
            end.record()
            torch.cuda.synchronize()
            res[mode] = (out, start.elapsed_time(end),
                         torch.cuda.max_memory_allocated(),
                         {k: getattr(m, a) for k, (m, a) in with_t1.items()},
                         float(ctx.loss_fraction()))
        equal = [bool(torch.equal(res["vmap"][0][:, b], res["scan"][0][:, b]))
                 for b in range(ARENA_BUCKETS)]
        row = {"phase": "vmap_strategies", "strategy": strategy,
               "drop_rate": cfg.drop_rate, "buckets_bitwise_equal":
               sum(equal), "loss_frac": res["vmap"][4],
               "loss_frac_scan": res["scan"][4]}
        for mode in ("scan", "vmap"):
            row[f"{mode}_device_ms"] = res[mode][1]
            row[f"{mode}_peak_mem_bytes"] = res[mode][2]
            row[f"{mode}_launches"] = res[mode][3]
        del res
        free_card()
        emit(row)
        if not (all(equal) and row["loss_frac"] == row["loss_frac_scan"]):
            fail(f"vmap_strategies: {row}")
    del arena
    free_card()
    init = _normal_leaves(full_width("gpt2-paper"))
    none = {k: 0 for k in with_t1}
    want = {"optireduce": {**none, "fwht": 2, "masked_mean": 1},
            "optireduce_q": {**none, "fwht": 1, "ht_amax": 1, "ht_quant": 1,
                             "dequant_mean": 1, "grid_quant": 1}}
    out = {}
    for strategy, per_step in want.items():
        per_step = {**per_step, "threefry": T1_PER_STEP_VMAP[strategy]}
        counts, _ = train_main_path(strategy, VMAP_STEPS, with_t1,
                                    phase="vmap_main",
                                    extra=("--sync-mode", "vmap"))
        expect = {k: v * VMAP_STEPS for k, v in per_step.items()}
        expect["threefry"] += init
        if counts != expect:
            fail(f"vmap_main {strategy}: launches {counts}, expected "
                 f"{expect}")
        out[strategy] = counts
        free_card()
    return out


def adafactor_and_chunked(counters: dict) -> None:
    """Phases ``adafactor_main`` (the launcher with ``--optimizer
    adafactor``, 2 steps: loss, ms, peak) and ``chunked_train`` (``--seq-len
    8192 --global-batch 4``: one sequence a peer, two query blocks of 4,096
    a layer, 2 steps: ms, peak), both at full width with the main path's
    launches (48 B1 + 24 B2 a step)."""
    none = {k: 0 for k in counters}
    per_step = {**none, "fwht": 48, "masked_mean": 24}
    for phase, extra in (("adafactor_main", ("--optimizer", "adafactor")),
                         ("chunked_train", ("--seq-len", str(CHUNK_SEQ),
                                            "--global-batch", "4"))):
        counts, _ = train_main_path("optireduce", 2, counters, phase=phase,
                                    extra=extra)
        expect = {k: v * 2 for k, v in per_step.items()}
        if counts != expect:
            fail(f"{phase}: launches {counts}, expected {expect}")
        free_card()


def chunked_prefill(dev) -> None:
    """Phase ``chunked_prefill``: ``prefill_step`` on gpt2-paper at full
    width over ``PREFILL_32K`` tokens (the reference's ``prefill_32k``
    sequence; its batch cut from 32 to ``PREFILL_32K_BATCH``): ms, peak
    bytes, the KV state's bytes; then one attention layer at S 8,192, B 1,
    in fp32, chunked (``attn_chunk`` 4,096) against dense, within
    ``CHUNK_DENSE_TOL``."""
    import torch
    from repro_torch.core.keys import key
    from repro_torch.models import init_params, prefill_step
    from repro_torch.models import layers as tl

    cfg = full_width("gpt2-paper")
    params = init_params(key(0), cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab_size,
                           (PREFILL_32K_BATCH, PREFILL_32K),
                           generator=_seeded(11, dev), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        tok, states = prefill_step(params, {"tokens": prompt}, cfg)
        end.record()
    torch.cuda.synchronize()
    row = {"phase": "chunked_prefill", "arch": cfg.name,
           "batch": PREFILL_32K_BATCH, "prompt": PREFILL_32K,
           "attn_chunk": cfg.attn_chunk, "ms": start.elapsed_time(end),
           "tok_per_s": PREFILL_32K_BATCH * PREFILL_32K
           / start.elapsed_time(end) * 1e3,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": _nbytes([t for st in states for t in st]),
           "token_in_vocab": bool(0 <= int(tok.min())
                                  and int(tok.max()) < cfg.vocab_size)}
    del params, states, prompt
    free_card()
    d, h = cfg.d_model, cfg.n_heads
    g = _seeded(12, dev)
    w = {name: torch.randn(shape, generator=g, device=dev) / math.sqrt(d)
         for name, shape in (("wq", (d, h * cfg.dh)), ("wk", (d, h * cfg.dh)),
                             ("wv", (d, h * cfg.dh)), ("wo", (h * cfg.dh, d)))}
    x = torch.randn((1, CHUNK_SEQ, d), generator=g, device=dev)
    pos = torch.arange(CHUNK_SEQ, device=dev)[None]
    with torch.no_grad():
        chunked = tl.attention_train(x, {**w, "head_dim": cfg.dh,
                                         "attn_chunk": cfg.attn_chunk},
                                     positions=pos)
        dense = tl.attention_train(x, {**w, "head_dim": cfg.dh,
                                       "attn_chunk": 0}, positions=pos)
    rel = float((chunked - dense).abs().max() / dense.abs().max())
    row.update(chunk_vs_dense_seq=CHUNK_SEQ, chunk_vs_dense_rel_err=rel,
               chunk_vs_dense_tol=CHUNK_DENSE_TOL)
    del chunked, dense, x, w
    free_card()
    emit(row)
    if not (row["token_in_vocab"] and rel <= CHUNK_DENSE_TOL):
        fail(f"chunked_prefill: {row}")


# ----------------------------------------- one rank a peer (ROADMAP A18c)
DIST_RANKS = 4
DIST_ARENA = (3, 65_536)       # every strategy and policy, small
DIST_RATE = 0.01
DIST_PACKET = 256
DIST_STEPS = 2
DIST_TIMEOUT_S = 600
DIST_THREADS = 2               # torch's host threads a rank: 4 ranks, 8 cores
DIST_RS = (50_257, 768)        # gpt2-paper's embedding, reduce-scattered
DIST_PODS = 2                  # the pod grid over gloo's 4 ranks: 2 x 2
# the small arena's tail drops on the pod grid: at DIST_RATE its 2-peer
# data axis loses no entry of that arena, at 0.05 masks with zeros cross
DIST_POD_RATE = 0.05
# what the ranks hold against the stacked pod grid's per-step launches
DIST_POD_PHASES = {"pod_main": ("dist_pod_main", "pod_main"),
                   "pod_fsdp": ("dist_pod_fsdp_main", "fsdp_main")}
# tp over gloo's 4 ranks: (data 2, model 2); the loss and grad norm against
# the stacked form's (bf16 partial sums added in another order), and the
# parameters after the steps: an AdamW step moves an entry ~lr, a small
# gradient's sign may flip, and each form rounds the entry to bf16 after
# each step (half a bf16 step each), so within 4 x lr and one bf16 step a
# step of the stacked entry
DIST_TP_REL = 1e-2
DIST_TP_LR = 3e-4                  # the launcher's default
DIST_TP_PARAM_TOL = 4 * DIST_TP_LR
# the ranks' per-step digests of their state and the stacked sides': each
# leaf's every 997th entry and a checksum of all its entries, taken on the
# card (distcheck.sample), where a SHA-256 of every byte on the host took
# 1.5 GB a rank a step (dist_pod_main); the replicated leaves under FSDP
# and tp whole
DIST_STRIDE = 997
# the MoE family over gloo's 4 ranks as (data 2, model 2): qwen2-moe-a2.7b
# at full width (d 2048, 60 experts top-4, 4 shared, vocab 151,936, bf16),
# cut to 1 of 24 layers as TP_FAMILIES_MAIN cuts it, replicated and FSDP
# x TP. A rank's router gradient covers only its own experts' slots until
# the tp group's sum; in bf16 each rank's part is rounded before that sum
# and the second step starts from parameters that differ by it, so the
# router's first moment after 2 steps is held within DIST_MOE_ROUTER_REL of
# the stacked moment's largest entry: tools/tp_sum_gap.py reads 0.85%
# after one step and 4.9% after two on the CPU (bf16), and 111-127% when
# the sum is left out
DIST_MOE_ARCH = "qwen2-moe-a2.7b"
DIST_MOE_LAYERS = 1
DIST_MOE_ROUTER_REL = 0.25
# the SSM family over gloo's 4 ranks as (data 2, model 2): mamba2-1.3b at
# full width (d 2048, d_inner 4096, 64 heads of 64, state 128, conv 4,
# vocab 50,280, tied, bf16), cut to 12 of 48 layers as TP_FAMILIES_MAIN
# cuts it, replicated and FSDP x TP, each tp rank holding and running its
# 32 heads. A rank's wB / wC gradient covers only its own heads until the
# tp group's sum. Random-init Mamba-2 amplifies rounding ~1.2x a layer
# (ROADMAP C): at this width and depth a bf16 step's gradient is off by a
# third (tp_families_main's --tp 1 step without drops: grad norm 272.52 in
# bf16 against 444.04 in float64 on an H100), and two bf16 steps that
# round in another order lie as far apart, so the bf16 runs'
# grad norm, blocks and wB / wC moments are recorded and
# dist_ssm_float64 holds them: in float64 the ranks' step, and wB's and
# wC's first moments, against the stacked --tp 1 step's within
# TP_GRAD_TOL (without the sum a rank's moment is its heads' share alone:
# tools/tp_sum_gap.py --arch mamba2-1.3b reads 33-61% of the largest entry
# without it, 0.45-0.60% with it, bf16 on the CPU)
DIST_SSM_ARCH = "mamba2-1.3b"
DIST_SSM_LAYERS = 12
# the frontend-prefix family over gloo's 4 ranks as (data 2, model 2) with
# --seq-parallel and its prefix: llava-next-mistral-7b at full width (d
# 4096, 32 heads and 8 KV heads of 128, d_ff 14,336, vocab 32,000, a
# 2,048-patch prefix of width 1,024, bf16), cut to 2 of 32 layers as
# TP_FAMILIES_MAIN cuts it, replicated and FSDP x TP. Under SP a rank's
# norms see its sequence slice alone until the tp group's sum (copy_seq),
# and frontend_proj's gradient is whole on every rank with no sum of its
# own; their first moments after 2 steps are held within
# DIST_FRONTEND_REL of the stacked moment's largest entry:
# tools/tp_sum_gap.py --arch llava-next-mistral-7b reads 0.47-0.75% for
# the norms and 0.65-0.86% for frontend_proj after 1 and 2 steps on the
# CPU (bf16, d 256), and 36.5-75.8% for the norms without their sum (a sum
# of frontend_proj's over tp would double it: 100%)
DIST_FRONTEND_ARCH = "llava-next-mistral-7b"
DIST_FRONTEND_LAYERS = 2
DIST_FRONTEND_REL = 0.1


def _distcheck():
    """``tools/distcheck.py``, the ranks' side of the ``dist_*`` phases."""
    sys.path.insert(0, str(ROOT / "tools"))
    import distcheck
    return distcheck


def _dist_train_argv(world: int) -> list:
    """The launcher's flags of ``dist_main``: the main path at full width,
    ``optireduce``, ``pipelined``, ``DIST_STEPS`` steps, ``world`` peers."""
    argv = train_argv("optireduce")
    argv[argv.index("--dp") + 1] = str(world)
    return argv + ["--steps", str(DIST_STEPS), "--sync-mode", "pipelined"]


def dist_tp_argv(world: int, ranks: bool) -> list:
    """The launcher's flags of ``dist_tp_main``: ``dist_main``'s at ``--dp
    world / TP --tp TP`` (under torchrun, ``ranks``, over gloo)."""
    argv = _dist_train_argv(world)
    argv[argv.index("--dp") + 1] = str(world // TP)
    return argv + ["--tp", str(TP)] + (["--dist-backend", "gloo"] if ranks
                                       else [])


def dist_pod_jobs(world: int) -> dict:
    """The ``--pod-train`` runs of gloo's world (``distcheck.pod_train``):
    the main path's gpt2-paper at full width on the ``(pod 2, data 2)``
    grid, ``optireduce_2d``, tail drops ``DIST_RATE``, ``pipelined``,
    ``DIST_STEPS`` steps, replicated and FSDP."""
    base = {"arch": "gpt2-paper", "smoke": False, "pods": DIST_PODS,
            "peers": world, "steps": DIST_STEPS, "seq_len": 128,
            "global_batch": 8, "drop_rate": DIST_RATE, "block": BLOCK,
            "bucket_elems": BUCKET, "lr": 3e-4, "skip_threshold": 0.10,
            "sync_mode": "pipelined", "seed": 0, "kernel_mode": "kernel",
            "strategy": "optireduce_2d", "stride": DIST_STRIDE}
    return {"pod_main": {**base, "name": "pod_main", "dp_mode": "replicated"},
            "pod_fsdp": {**base, "name": "pod_fsdp", "dp_mode": "fsdp"}}


# the tp grid's launcher runs over gloo's ranks, a family's runs: name ->
# flags past dist_family_argv
DIST_TP_RUNS = {"tp_main": [], "tp_fsdp_main": ["--dp-mode", "fsdp"]}
DIST_MOE_RUNS = {"moe_main": [], "moe_fsdp_main": ["--dp-mode", "fsdp"]}
DIST_SSM_RUNS = {"ssm_main": [], "ssm_fsdp_main": ["--dp-mode", "fsdp"]}
DIST_FRONTEND_RUNS = {"frontend_main": ["--seq-parallel", "--prefix"],
                      "frontend_fsdp_main": ["--seq-parallel", "--prefix",
                                             "--dp-mode", "fsdp"]}
# family -> (arch, its depth cut, its runs, the leaves replicated over tp
# whose first moments are held against the stacked run's, their bound:
# None where dist_ssm_float64 holds them); the dense family is
# dist_tp_argv's gpt2-paper at full depth
DIST_FAMILIES = {
    "dense": (None, None, DIST_TP_RUNS, (), None),
    "moe": (DIST_MOE_ARCH, DIST_MOE_LAYERS, DIST_MOE_RUNS, ("router",),
            DIST_MOE_ROUTER_REL),
    "ssm": (DIST_SSM_ARCH, DIST_SSM_LAYERS, DIST_SSM_RUNS, ("wB", "wC"),
            None),
    "frontend": (DIST_FRONTEND_ARCH, DIST_FRONTEND_LAYERS,
                 DIST_FRONTEND_RUNS, ("frontend_proj", "ln1", "ln2",
                                      "final_ln"), DIST_FRONTEND_REL)}
# the phase suffix of a family's summed leaves (_dist_summed_held)
DIST_SUMMED_PHASE = {"moe": "router", "ssm": "bc", "frontend": "summed"}
# the run whose stacked side is tp_families_main's run of the same flags
# (its records, last parameters and launches, kept; not run again), held
# after it
DIST_REUSED = "frontend_main"
# the ranks' float64 step of the SSM family (dist_ssm_float64)
DIST_SSM_F64 = "ssm_float64"


def dist_family(run: str) -> str:
    """The family of a tp grid run of gloo's world."""
    return next(f for f, spec in DIST_FAMILIES.items() if run in spec[2])


def dist_family_argv(world: int, ranks: bool, family: str) -> list:
    """The launcher's flags of a family's tp grid runs: ``dist_tp_main``'s
    (:func:`dist_tp_argv`) on the family's arch, whose depth the run's
    config override cuts (:func:`dist_family_config`)."""
    argv = dist_tp_argv(world, ranks)
    arch = DIST_FAMILIES[family][0]
    if arch is not None:
        argv[argv.index("--arch") + 1] = arch
    return argv


def dist_family_config(family: str) -> dict | None:
    """The config override (``distcheck.job_config``) of a family's runs:
    its depth cut, or None."""
    layers = DIST_FAMILIES[family][1]
    return None if layers is None else {"n_layers": layers}


def dist_family_cfg(family: str):
    """The config a family's runs train."""
    arch, layers = DIST_FAMILIES[family][:2]
    return full_width(arch or "gpt2-paper", layers)


def dist_ssm_float64_job(world: int) -> dict:
    """The ``--tp-train`` job of ``dist_ssm_float64``: one replicated step
    of ``DIST_SSM_ARCH`` at ``DIST_SSM_LAYERS`` layers in float64 without
    drops, at ``--tp TP`` over the ranks; every flag but ``--tp`` (and the
    backend) is ``tp_families_main``'s float64 ``--tp 1`` step's (its
    ``train_main_path`` flags), whose records it is held against."""
    argv = train_argv("optireduce", arch=DIST_SSM_ARCH) + [
        "--steps", "1", "--dp", str(world // TP), "--tp", str(TP),
        "--drop-rate", "0", "--dist-backend", "gloo"]
    return {"name": DIST_SSM_F64, "argv": argv, "stride": DIST_STRIDE,
            "save_replicated": True,
            "config": {"n_layers": DIST_SSM_LAYERS,
                       "param_dtype": TP_GRAD_DTYPE[DIST_SSM_ARCH]}}


def _stacked_tp(world: int, family: str = "dense") -> dict:
    """The stacked side of a family's tp grid runs (``dist_tp_main`` and
    ``dist_tp_fsdp_main``, ``dist_moe_*``, ``dist_ssm_*``): the launcher at
    ``--dp world / TP --tp TP`` as one process, replicated and FSDP x TP
    (``DIST_FAMILIES``): each run's records, last parameters (on the host),
    launches a step and seconds; outside the dense family also the last
    parameters and moments of each leaf replicated over tp (the router or
    ``wB`` / ``wC``, the norms; on the host)."""
    from repro_torch.kernels import runtime
    from repro_torch.launch import train as launch_train
    distcheck = _distcheck()
    tp = {}
    for run, extra in DIST_FAMILIES[family][2].items():
        if run == DIST_REUSED:          # tp_families_main's run
            continue
        t0 = time.perf_counter()
        # no step's copy: the stacked tp runs' digests are not compared
        with distcheck.job_config(dist_family_config(family)), \
                distcheck.watch_steps(keep=True, steps=0) as seen:
            records = launch_train.run(
                dist_family_argv(world, False, family) + extra)
        runtime.set_kernel_mode(None)
        tp[run] = {"records": records, "params": seen["params"],
                   "launches": seen["launches"],
                   "seconds": time.perf_counter() - t0}
        if family != "dense":
            tp[run]["replicated"] = distcheck.replicated_leaves(
                seen["cfg"], TP, seen["last"], seen["last_state"])
        del seen
        free_card()
    return tp


def dist_tp_jobs(world: int) -> list:
    """The ``--tp-train`` flags of gloo's world: each family's runs
    (``DIST_FAMILIES``, the depth cut by a config override), under
    torchrun, a strided digest of the shards, the last parameters saved
    (and outside the dense family the leaves replicated over tp with their
    moments); then, last, ``dist_ssm_float64``'s step
    (:func:`dist_ssm_float64_job`)."""
    jobs = []
    for family, (_, _, runs, _, _) in DIST_FAMILIES.items():
        for run, extra in runs.items():
            job = {"name": run, "argv": dist_family_argv(world, True, family)
                   + extra, "stride": DIST_STRIDE, "save_last": True}
            if family != "dense":
                job.update(save_replicated=True,
                           config=dist_family_config(family))
            jobs.append(job)
    jobs.append(dist_ssm_float64_job(world))
    return [arg for job in jobs for arg in ("--tp-train", json.dumps(job))]


def _stacked_side(dev, world: int, full: bool) -> dict:
    """The stacked form's side of the ``dist_*`` phases at ``world`` peers:
    each sync case's row digests, loss fraction and launches on the arenas
    and draws the ranks use (with ``full``, also on the pod grid, in
    ``pod_sync``), the pod grid's training runs (``pods``,
    :func:`dist_pod_jobs`) and the launcher's records, per-step parameter
    digests, last parameters and launches."""
    from repro_torch.core import collectives
    from repro_torch.kernels import runtime
    from repro_torch.launch import train as launch_train
    distcheck = _distcheck()

    sync, pod_sync, pods = {}, {}, {}
    grids = [collectives.ONE]
    if full:
        grids.append(collectives.Grid(pods=DIST_PODS))
    for grid in grids:
        for name, y, frac, launched in distcheck.grid_cases(
                grid, range(world), dev, world=world, arena=DIST_ARENA,
                full=(ARENA_BUCKETS, BUCKET) if full else None,
                rs=DIST_RS if full else None, rate=DIST_RATE,
                pod_rate=DIST_POD_RATE, block=BLOCK, packet=DIST_PACKET):
            (pod_sync if grid.pods > 1 else sync)[name] = (
                [distcheck.digest(row) for row in y], frac, launched)
            del y
        free_card()
    tp = {}
    if full:
        for name, job in dist_pod_jobs(world).items():
            pods[name] = distcheck.pod_train(job, dev)
            free_card()
        tp = {run: held for family in DIST_FAMILIES
              for run, held in _stacked_tp(world, family).items()}
    before = distcheck.counts()
    with distcheck.watch_steps(keep=True, stride=DIST_STRIDE) as seen:
        records = launch_train.run(_dist_train_argv(world))
    after = distcheck.counts()
    runtime.set_kernel_mode(None)     # the launcher left it at 'kernel'
    free_card()
    return {"sync": sync, "records": records, "digests": seen["digests"],
            "params": seen["params"], "pod_sync": pod_sync, "pods": pods,
            "tp": tp, "launches": {k: after[k] - before[k] for k in after}}


def _dist_held(phases: tuple, world: int, want: dict, reports: list,
               params_path: Path, times: dict) -> None:
    """Hold the ranks' reports of one world against the stacked side and
    emit its sync row and its launcher's rows (see :func:`dist_paths`).
    ``dist_s`` is emitted for gloo only: its calls return when the data
    has moved, NCCL's once the work is queued."""
    import torch
    sync_phase, main_phase = phases
    gloo = reports[0]["backend"] == "gloo"
    bad, full_rows = [], {}
    for case, (digests, frac, launched) in want["sync"].items():
        got = [rep["sync"][case] for rep in reports]
        for r, g in enumerate(got):
            if g["digest"] != digests[r] or (frac is not None and (
                    g["loss_frac"] != frac or g["launches"] != launched)):
                bad.append({"case": case, "rank": r,
                            "bitwise": g["digest"] == digests[r],
                            "loss_frac": [g.get("loss_frac"), frac],
                            "launches": [g.get("launches"), launched]})
        if case.startswith(("full:", "rs/")):
            full_rows[case.removeprefix("full:")] = {
                "stacked_launches": launched,
                "launches_per_rank": [g["launches"] for g in got],
                "dist_bytes": [g["dist_bytes"] for g in got],
                "dist_s": [g["dist_s"] for g in got] if gloo else None,
                "loss_frac": frac}
    emit({"phase": sync_phase, "backend": reports[0]["backend"],
          "ranks": world, "cases": len(want["sync"]),
          "small_arena": list(DIST_ARENA), **times, "full": full_rows,
          "mismatches": bad})
    if bad:
        fail(f"{sync_phase}: {len(bad)} rank results differ from the "
             f"stacked form: {bad[:4]}")

    runs = [rep["train"]["main"] for rep in reports]
    # the stacked sides ran while the ranks started; their second steps
    # wait for the release (``--wait-for``), which this checks
    later = min(r["starts"][1] for r in runs)
    alone = later >= times["released"]
    params = torch.load(params_path)
    params_gap = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(params, want["params"]))
    metrics_gap = max(abs(a[k] - b[k]) for a, b in zip(runs[0]["records"],
                                                       want["records"])
                      for k in ("loss", "loss_frac", "grad_norm"))
    ranks_equal = all(r["digests"] == runs[0]["digests"] for r in runs)
    launches_ok = all(r["launches"] == want["launches"] for r in runs)
    for r, run in enumerate(runs):
        for i, rec in enumerate(run["records"]):
            emit({"phase": f"{main_phase}_step", "rank": r, "step": i,
                  "loss": rec["loss"], "loss_frac": rec["loss_frac"],
                  "step_ms": rec["step_s"] * 1e3,
                  "wait_ms": run["wait_s"] * 1e3 if i == 0 else 0.0,
                  "peak_bytes": rec["peak_bytes"],
                  "dist_bytes": rec["dist_bytes"],
                  "dist_s": rec["dist_s"] if gloo else None})
    emit({"phase": main_phase, "backend": reports[0]["backend"],
          "ranks": world, "steps": DIST_STEPS,
          "step1_after_release_s": later - times["released"],
          "ranks_bitwise_equal": ranks_equal,
          "rank0_bitwise_stacked": runs[0]["digests"] == want["digests"],
          "params_max_abs_diff": params_gap,
          "metrics_max_abs_diff": metrics_gap, "tolerance": STEP_TOL,
          "stacked": [{k: rec[k] for k in ("loss", "loss_frac", "grad_norm",
                                           "step_s")}
                      for rec in want["records"]],
          "stacked_launches": want["launches"],
          "launches_per_rank": [r["launches"] for r in runs]})
    if not (ranks_equal and launches_ok and params_gap <= STEP_TOL
            and metrics_gap <= STEP_TOL and alone):
        fail(f"{main_phase}: ranks equal {ranks_equal}, launches "
             f"{launches_ok}, params {params_gap}, metrics {metrics_gap} "
             f"(tolerance {STEP_TOL}), step 1 after the release {alone}")


def fsdp_rank_state_bytes(world: int) -> int:
    """Bytes of parameters and AdamW moments one of ``world`` ranks holds
    under FSDP on gpt2-paper: its shard of each sharded leaf (bf16 and two
    fp32 moments) and the replicated leaves whole."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import _map_table, param_table
    cfg = get_config("gpt2-paper")
    leaves = []
    _map_table(leaves.append, param_table(cfg, fsdp_axes=("data",)))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    return sum(math.prod(leaf.shape) // (1 if leaf.fsdp_dim is None
                                         else world)
               for leaf in leaves) * (itemsize + 2 * 4)


def _dist_fsdp_held(reports: list) -> None:
    """Phase ``dist_fsdp_main``: the gloo ranks' FSDP run against
    ``fsdp_main``'s first steps (``FSDP_STACKED``): after every step each
    rank's parameters and AdamW moments bitwise its slice of the stacked
    ones, the replicated leaves bitwise the stacked ones on every rank,
    every rank's loss, loss_frac, grad norm and skipped the stacked run's,
    each step's launches a rank the stacked step's (174 B1, 87 B2, T1),
    and the state bytes a rank its shard's count."""
    want = FSDP_STACKED
    runs = [rep["train"]["fsdp"] for rep in reports]
    world = len(runs)
    count = fsdp_rank_state_bytes(world)
    keys = ("loss", "loss_frac", "grad_norm", "skipped")
    shards_ok = all(run["digests"] == [d[r] for d in want["digests"]]
                    for r, run in enumerate(runs))
    replicated_ok = all(run["replicated"] == want["replicated"]
                        for run in runs)
    records_ok = all([{k: rec[k] for k in keys} for rec in run["records"]]
                     == [{k: rec[k] for k in keys}
                         for rec in want["records"]] for run in runs)
    per_step = A15_PER_STEP["fsdp_main"]
    launches_ok = all(run["step_launches"] == want["launches"]
                      for run in runs) and all(
        all(step[k] == v for k, v in per_step.items())
        for step in want["launches"])
    bytes_ok = all(b == count for run in runs for b in run["state_bytes"])
    for r, run in enumerate(runs):
        for i, rec in enumerate(run["records"]):
            emit({"phase": "dist_fsdp_main_step", "rank": r, "step": i,
                  "loss": rec["loss"], "loss_frac": rec["loss_frac"],
                  "grad_norm": rec["grad_norm"],
                  "step_ms": rec["step_s"] * 1e3,
                  "peak_bytes": rec["peak_bytes"],
                  "state_bytes": run["state_bytes"][i],
                  "dist_bytes": rec["dist_bytes"], "dist_s": rec["dist_s"],
                  "launches": run["step_launches"][i]})
    emit({"phase": "dist_fsdp_main", "backend": reports[0]["backend"],
          "ranks": world, "steps": DIST_STEPS,
          "shards_bitwise_stacked": shards_ok,
          "replicated_bitwise_stacked": replicated_ok,
          "records_equal_stacked": records_ok,
          "launches_equal_stacked": launches_ok,
          "state_bytes_a_rank": count,
          "stacked_state_bytes": want["state_bytes"],
          "stacked": [{k: rec[k] for k in ("loss", "loss_frac", "grad_norm",
                                           "step_s")}
                      for rec in want["records"]],
          "stacked_launches": want["launches"]})
    if not (shards_ok and replicated_ok and records_ok and launches_ok
            and bytes_ok):
        fail(f"dist_fsdp_main: shards {shards_ok}, replicated "
             f"{replicated_ok}, records {records_ok}, launches "
             f"{launches_ok}, state bytes {bytes_ok} ({count} expected)")


def _dist_pod_held(reports: list, want: dict) -> None:
    """Phases ``dist_pod_sync``, ``dist_pod_main`` and
    ``dist_pod_fsdp_main``: gloo's ranks as the ``(pod 2, data 2)`` grid
    against the stacked 2 x 2 grid on the same arenas, draws and flags.
    Sync: each rank's result bitwise its stacked row, the same loss
    fraction and launches. Training (:func:`dist_pod_jobs`): after every
    step each rank's parameters and AdamW moments bitwise the stacked
    ones (FSDP: its pod-major slice), every rank's loss, loss_frac, grad
    norm and skipped the stacked run's, each step's launches a rank the
    stacked step's and those of ``A15_PER_STEP``'s row for the same sync
    (the pod hop of FSDP launches nothing: it is reliable and unrotated),
    the init's launches the stacked init's, and under FSDP the state bytes
    a rank its quarter's count."""
    world = len(reports)
    bad, full_rows = [], {}
    for case, (digests, frac, launched) in want["pod_sync"].items():
        got = [rep["sync"][case] for rep in reports]
        for r, g in enumerate(got):
            if g["digest"] != digests[r] or (frac is not None and (
                    g["loss_frac"] != frac or g["launches"] != launched)):
                bad.append({"case": case, "rank": r,
                            "bitwise": g["digest"] == digests[r],
                            "loss_frac": [g.get("loss_frac"), frac],
                            "launches": [g.get("launches"), launched]})
        if "full:" in case or "rs/" in case:
            full_rows[case.split(":", 1)[1].removeprefix("full:")] = {
                "stacked_launches": launched,
                "launches_per_rank": [g["launches"] for g in got],
                "dist_bytes": [g["dist_bytes"] for g in got],
                "dist_s": [g["dist_s"] for g in got], "loss_frac": frac}
    lossy = {case: frac for case, (_, frac, _) in want["pod_sync"].items()
             if frac}
    emit({"phase": "dist_pod_sync", "backend": reports[0]["backend"],
          "ranks": world, "pods": DIST_PODS, "cases": len(want["pod_sync"]),
          "small_arena": list(DIST_ARENA), "small_arena_rate": DIST_POD_RATE,
          "rate": DIST_RATE, "cases_with_drops": len(lossy),
          "full": full_rows, "mismatches": bad})
    if bad or not lossy:
        fail(f"dist_pod_sync: {len(bad)} rank results differ from the "
             f"stacked form: {bad[:4]}; {len(lossy)} cases dropped")

    keys = ("loss", "loss_frac", "grad_norm", "skipped")
    count = fsdp_rank_state_bytes(world)
    for run, (phase, per_step_row) in DIST_POD_PHASES.items():
        stacked = want["pods"][run]
        runs = [rep["train"][run] for rep in reports]
        fsdp = run == "pod_fsdp"
        states_ok = all(
            got["digests"] == ([d[r] for d in stacked["digests"]] if fsdp
                               else stacked["digests"])
            for r, got in enumerate(runs))
        records_ok = all([{k: rec[k] for k in keys} for rec in got["records"]]
                         == [{k: rec[k] for k in keys}
                             for rec in stacked["records"]] for got in runs)
        per_step = A15_PER_STEP[per_step_row]
        launches_ok = all(
            got["launches"] == stacked["launches"]
            and got["init_launches"] == stacked["init_launches"]
            for got in runs) and all(
            all(step[k] == v for k, v in per_step.items())
            for step in stacked["launches"])
        bytes_ok = all(b == (count if fsdp else stacked["state_bytes"][0])
                       for got in runs for b in got["state_bytes"])
        for r, got in enumerate(runs):
            for i, rec in enumerate(got["records"]):
                emit({"phase": f"{phase}_step", "rank": r, "step": i,
                      "loss": rec["loss"], "loss_frac": rec["loss_frac"],
                      "grad_norm": rec["grad_norm"],
                      "step_ms": rec["step_s"] * 1e3,
                      "peak_bytes": rec.get("peak_bytes"),
                      "state_bytes": got["state_bytes"][i],
                      "dist_bytes": rec["dist_bytes"],
                      "dist_axis_bytes": rec["dist_axis_bytes"],
                      "dist_s": rec["dist_s"],
                      "launches": got["launches"][i]})
        emit({"phase": phase, "backend": reports[0]["backend"],
              "ranks": world, "pods": DIST_PODS, "steps": DIST_STEPS,
              "dp_mode": "fsdp" if fsdp else "replicated",
              "states_bitwise_stacked": states_ok,
              "records_equal_stacked": records_ok,
              "launches_equal_stacked": launches_ok,
              "state_bytes_ok": bytes_ok,
              "stacked_state_bytes": stacked["state_bytes"][0],
              "stacked": [{k: rec[k] for k in keys + ("step_s",)}
                          for rec in stacked["records"]],
              "stacked_launches": stacked["launches"],
              "init_launches": stacked["init_launches"]})
        if not (states_ok and records_ok and launches_ok and bytes_ok):
            fail(f"{phase}: states {states_ok}, records {records_ok}, "
                 f"launches {launches_ok}, state bytes {bytes_ok}")


def tp_rank_state_bytes(world: int, fsdp: bool, cfg=None) -> int:
    """Bytes of parameters and AdamW moments one of ``world`` ranks holds
    on ``cfg`` (gpt2-paper by default) at ``--dp world / TP --tp TP``: its
    tp chunk of each tp-sharded leaf (``TP_LOCAL`` entries a rank on
    gpt2-paper; a rank's ``E_pad / TP`` experts), under FSDP x TP of that
    its data shard (and its data shard of a leaf sharded over data only),
    bf16 and two fp32 moments, the rest whole."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import _map_table, param_table
    cfg = cfg or get_config("gpt2-paper")
    leaves = []
    _map_table(leaves.append, param_table(cfg, tp=TP, fsdp_axes=("data",)))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    entries = sum(math.prod(leaf.shape)
                  // (1 if leaf.tp_dim is None else TP)
                  // (1 if leaf.fsdp_dim is None or not fsdp
                      else world // TP) for leaf in leaves)
    return entries * (itemsize + 2 * 4)


def _dist_tp_held(reports: list, want: dict, out: Path, run: str) -> dict:
    """Phase ``dist_<run>``: gloo's ranks as the ``(data 2, model 2)``
    grid, the launcher with ``--tp 2`` (:func:`dist_tp_argv`; ``tp_main``
    replicated, ``tp_fsdp_main`` with ``--dp-mode fsdp``; ``moe_*`` and
    ``ssm_*`` the same on ``DIST_MOE_ARCH`` and ``DIST_SSM_ARCH``,
    :func:`dist_family_argv`), against the stacked launcher's same steps
    (``want``): launches a rank a step (replicated: 2 B1, 1 B2 and 2 T1 a
    bucket of the rank's local leaves, ``TP_BUCKETS`` on gpt2-paper, and
    outside the dense family the stacked step's the same; FSDP x TP: the
    stacked step's B1, B2 and T1, ``TP_PER_STEP["tp_fsdp"]``'s B1 and B2
    on gpt2-paper) and at init, the leaves no rank shards bitwise equal on
    every rank, each rank's state its data replica's (replicated), the
    loss and the grad norm within ``DIST_TP_REL``, each rank's piece of the
    parameters (its tp chunk; under FSDP x TP the data shard of it) within
    ``DIST_TP_PARAM_TOL`` of the stacked one's, beyond one bf16 step a step
    at the stacked entry (both forms round it to bf16 each step), state
    bytes a rank :func:`tp_rank_state_bytes`. On the SSM family the grad
    norm and the parameters are recorded and ``dist_ssm_float64`` holds
    the step (random-init Mamba-2's bf16 gradient is rounding-bound at
    full width: see ``DIST_SSM_ARCH``). Returns rank 0's launches a step and the
    seconds of the ranks' run, of its stacked side and of these checks."""
    t0 = time.perf_counter()
    import torch
    from repro_torch.models.transformer import tp_dims
    from repro_torch.train import elastic
    family = dist_family(run)
    cfg = dist_family_cfg(family)
    phase = f"dist_{run}"
    fsdp = run.endswith("_fsdp_main")
    runs = [rep["train"][run] for rep in reports]
    world = len(runs)
    if fsdp:
        stacked = want["launches"][0]
        per_step = {k: stacked[k] for k in ("fwht", "masked_mean",
                                            "threefry")}
        if family == "dense":
            per_step.update(TP_PER_STEP["tp_fsdp"])
    else:
        buckets = local_buckets(cfg, TP, BUCKET)[0]
        per_step = {"fwht": 2 * buckets, "masked_mean": buckets,
                    "threefry": 2 * buckets}
    at_init = {"threefry": _normal_leaves(cfg)}
    launches_ok = all(
        all(step[k] == per_step.get(k, 0) for k in step)
        and all(n == at_init.get(k, 0)
                for k, n in run_["other_launches"].items())
        for run_ in runs for step in run_["step_launches"]) and (
        not fsdp and family == "dense"
        or all(all(step[k] == per_step.get(k, 0) for k in step)
               for step in want["launches"]))
    replicated_ok = all(run_["replicated"] == runs[0]["replicated"]
                        for run_ in runs)
    # replicated: rank r and r + TP hold one state; FSDP x TP: each its own
    replicas_ok = all((runs[r]["digests"] == runs[r + TP]["digests"])
                      != fsdp for r in range(world - TP))
    rel = {k: max(abs(rec[k] - ref[k]) / abs(ref[k])
                  for run_ in runs for rec, ref in zip(run_["records"],
                                                        want["records"]))
           for k in ("loss", "grad_norm")}
    # the SSM family's bf16 gradient: recorded; dist_ssm_float64 holds it
    bf16_held = family != "ssm"
    count = tp_rank_state_bytes(world, fsdp, cfg)
    bytes_ok = all(b == count for run_ in runs for b in run_["state_bytes"])
    tp_d = tp_dims(cfg, TP)
    fs_d = elastic.fsdp_dims(cfg, TP) if fsdp else [None] * len(tp_d)
    gap, excess = 0.0, -math.inf
    # on the card: on the host the MoE runs' 440,924,160 entries a rank
    # took 14-28 s of the parent's time
    dev = torch.device("cuda")
    fulls = [p.to(dev) for p in want["params"]]
    for r in range(world):
        shards = torch.load(out / f"{run}.rank{r}.pt", map_location=dev)
        for x, full, a, b in zip(shards, fulls, tp_d, fs_d):
            piece = full if a is None else elastic.split_leaf(full, a,
                                                              TP)[r % TP]
            if b is not None:
                piece = elastic.split_leaf(piece, b, world // TP)[r // TP]
            piece = piece.float()
            diff = (x.float() - piece).abs()
            # a bf16 step at the stacked entry: 2^(e - 8), |b| = m 2^e
            step = torch.where(piece == 0, 0.0, torch.ldexp(
                torch.ones_like(piece), torch.frexp(piece).exponent - 8))
            gap = max(gap, float(diff.max()))
            excess = max(excess, float((diff - DIST_STEPS * step).max()))
        del shards
    del fulls
    free_card()
    for r, run_ in enumerate(runs):
        for i, rec in enumerate(run_["records"]):
            emit({"phase": f"{phase}_step", "rank": r, "step": i,
                  "loss": rec["loss"], "loss_frac": rec["loss_frac"],
                  "grad_norm": rec["grad_norm"],
                  "step_ms": rec["step_s"] * 1e3,
                  "peak_bytes": rec.get("peak_bytes"),
                  "state_bytes": run_["state_bytes"][i],
                  "dist_bytes": rec["dist_bytes"],
                  "dist_axis_bytes": rec["dist_axis_bytes"],
                  "dist_s": rec["dist_s"],
                  "launches": run_["step_launches"][i]})
    seconds = max(run_["run_s"][1] - run_["run_s"][0] for run_ in runs)
    emit({"phase": phase, "backend": reports[0]["backend"],
          "ranks": world, "dp": world // TP, "tp": TP, "steps": DIST_STEPS,
          "dp_mode": "fsdp" if fsdp else "replicated",
          "launches_ok": launches_ok, "per_step_want": per_step,
          "init_want": at_init,
          "init_launches": [run_["other_launches"] for run_ in runs],
          "replicated_bitwise_equal": replicated_ok,
          "data_replicas_bitwise_equal": None if fsdp else replicas_ok,
          "ranks_states_differ": replicas_ok if fsdp else None,
          "records_max_rel_diff": max(rel.values()),
          "loss_max_rel_diff": rel["loss"],
          "grad_norm_max_rel_diff": rel["grad_norm"],
          "grad_norm_and_params_held_by": "this phase" if bf16_held
          else "dist_ssm_float64",
          "records_tolerance": DIST_TP_REL,
          "params_max_abs_diff": gap,
          "params_max_beyond_bf16_steps": excess,
          "params_tolerance": DIST_TP_PARAM_TOL,
          "state_bytes_a_rank": count, "state_bytes_ok": bytes_ok,
          "ranks_s": seconds, "stacked_s": want["seconds"],
          "stacked": [{k: rec[k] for k in ("loss", "loss_frac", "grad_norm",
                                           "step_s")}
                      for rec in want["records"]],
          "stacked_launches": want["launches"]})
    if not (launches_ok and replicated_ok and replicas_ok and bytes_ok
            and rel["loss"] <= DIST_TP_REL
            and (not bf16_held or rel["grad_norm"] <= DIST_TP_REL
                 and excess <= DIST_TP_PARAM_TOL)):
        fail(f"{phase}: launches {launches_ok}, replicated "
             f"{replicated_ok}, data replicas (or distinct states) "
             f"{replicas_ok}, records {rel} (tolerance {DIST_TP_REL}), "
             f"params {excess} beyond a bf16 step a step (tolerance "
             f"{DIST_TP_PARAM_TOL}), state bytes {bytes_ok} ({count} "
             "expected)")
    return {"launches": runs[0]["step_launches"][-1], "ranks_s": seconds,
            "stacked_s": want["seconds"],
            "checks_s": time.perf_counter() - t0}


def _dist_summed_held(want: dict, out: Path, run: str, world: int
                      ) -> dict:
    """Phase ``dist_<run>_router`` (``moe_main``, ``moe_fsdp_main``) or
    ``dist_<run>_bc`` (``ssm_main``, ``ssm_fsdp_main``): each rank's leaves
    replicated over tp whose gradient the tp group sums (the router;
    ``wB`` and ``wC``) and their AdamW first moments after the last step
    against the stacked run's (its data shard of them under FSDP x TP). A
    rank's router gradient reaches only its own experts' slots, its ``wB``
    / ``wC`` gradient only its own heads; ``copy_tp`` sums it over the tp
    group, so each moment must be within the family's bound
    (``DIST_MOE_ROUTER_REL``, ``DIST_SSM_BC_REL``) of the stacked moment's
    largest entry (a rank's own share alone is off by a third of it and
    more), the leaf within ``DIST_TP_PARAM_TOL`` beyond a bf16 step a step.
    The norms' moments are recorded beside them. Where the bound is None
    (the SSM family) the gaps are recorded and ``dist_ssm_float64`` holds
    those moments."""
    import torch
    from repro_torch.models.transformer import _walk, param_table
    from repro_torch.train import elastic
    family = dist_family(run)
    _, _, _, summed, bound = DIST_FAMILIES[family]
    phase = f"dist_{run}_{DIST_SUMMED_PHASE[family]}"
    cfg = dist_family_cfg(family)
    fsdp = run.endswith("_fsdp_main")
    table = param_table(cfg, tp=TP)
    fs_all = elastic.fsdp_dims(cfg, TP)
    reps = [(name, d) for (name, leaf), d in zip(_walk(table), fs_all)
            if leaf.tp_dim is None]
    stacked = want["replicated"]
    n = len(reps)
    gaps = {"m_rel": 0.0, "beyond_bf16_steps": -math.inf,
            "norms_m_rel": 0.0}
    for r in range(world):
        got = torch.load(out / f"{run}.rank{r}.rep.pt")

        def piece(x, d):
            return (elastic.split_leaf(x, d, world // TP)[r // TP]
                    if fsdp and d is not None else x).float()
        for j, (name, d) in enumerate(reps):
            m_want = piece(stacked["state"][j], d)
            m_rel = float((got["state"][j].float() - m_want).abs().max()
                          / m_want.abs().max())
            key = "m_rel" if name in summed else "norms_m_rel"
            gaps[key] = max(gaps[key], m_rel)
            if name in summed:
                w_want = piece(stacked["params"][j], d)
                step = torch.where(w_want == 0, 0.0, torch.ldexp(
                    torch.ones_like(w_want),
                    torch.frexp(w_want).exponent - 8))
                diff = (got["params"][j].float() - w_want).abs()
                gaps["beyond_bf16_steps"] = max(
                    gaps["beyond_bf16_steps"],
                    float((diff - DIST_STEPS * step).max()))
        if len(got["state"]) != 2 * n:
            fail(f"{phase}: rank {r} saved {len(got['state'])} moments of "
                 f"{n} replicated leaves")
    emit({"phase": phase, "ranks": world, "leaves": list(summed),
          "count": sum(name in summed for name, _ in reps), **gaps,
          "tolerance": {"m_rel": bound,
                        "beyond_bf16_steps": DIST_TP_PARAM_TOL}
          if bound is not None else "held by dist_ssm_float64"})
    if bound is not None and not (
            gaps["m_rel"] <= bound
            and gaps["beyond_bf16_steps"] <= DIST_TP_PARAM_TOL):
        fail(f"{phase}: {gaps}")
    return gaps


def _first_moments(saved: dict) -> list:
    """AdamW's first moments of the leaves :func:`distcheck.replicated_leaves`
    saved (its state: the first moments, then the second)."""
    state = saved["state"]
    return state[:len(state) // 2]


def dist_ssm_float64_held(f64: dict, tp1: dict, tp2: list) -> dict:
    """Phase ``dist_ssm_float64``: the ranks' one replicated step of
    ``DIST_SSM_ARCH`` (``DIST_SSM_LAYERS`` layers) in float64 without
    drops at ``--dp 2 --tp 2`` (:func:`dist_ssm_float64_job`; ``f64``: its
    reports and each rank's first moments of the leaves replicated over
    tp), against ``tp_families_main``'s float64 ``--tp 1`` step on the
    same flags (``tp1``: its records and those moments, reused, not run
    again): every rank's loss and grad norm within ``TP_GRAD_TOL``
    relative, and its first moments of ``wB`` and ``wC`` within
    ``TP_GRAD_TOL`` of the stacked moment's largest entry (a moment after
    one step is a tenth of the synced gradient; a rank's heads' share
    alone is off by a third of it and more); the norms' moments and the
    stacked ``--tp 2`` float64 step (``tp2``) recorded beside them. In
    float64 only the fp32 arena's, AdamW's and the loss's fp32 rounding is
    left between tp 2 and tp 1 (about 1e-7); a partial ``wB`` / ``wC``
    gradient or a wrong head would not shrink with the dtype."""
    from repro_torch.models.transformer import _walk, param_table
    runs = f64["runs"]
    gaps = {k: max(abs(run["records"][0][k] - tp1["records"][0][k])
                   / abs(tp1["records"][0][k]) for run in runs)
            for k in ("loss", "grad_norm")}
    names = [name for name, leaf in _walk(param_table(
        dist_family_cfg("ssm"), tp=TP)) if leaf.tp_dim is None]
    m_want = _first_moments(tp1["replicated"])
    m_rel = {"bc": 0.0, "norms": 0.0}
    for got in f64["m"]:
        for name, a, b in zip(names, got, m_want):
            key = "bc" if name in ("wB", "wC") else "norms"
            m_rel[key] = max(m_rel[key], float(
                (a.double() - b.double()).abs().max() / b.abs().max()))
    vs_tp2 = {k: max(abs(run["records"][0][k] - tp2[0][k]) / abs(tp2[0][k])
                     for run in runs) for k in ("loss", "grad_norm")}
    for r, run in enumerate(runs):
        rec = run["records"][0]
        emit({"phase": "dist_ssm_float64_step", "rank": r,
              "loss": rec["loss"], "grad_norm": rec["grad_norm"],
              "loss_frac": rec["loss_frac"], "step_ms": rec["step_s"] * 1e3,
              "peak_bytes": rec.get("peak_bytes"),
              "state_bytes": run["state_bytes"][0],
              "dist_bytes": rec["dist_bytes"],
              "dist_axis_bytes": rec["dist_axis_bytes"],
              "dist_s": rec["dist_s"], "launches": run["step_launches"][0]})
    emit({"phase": "dist_ssm_float64", "ranks": len(runs), "dp": 2,
          "tp": TP, "layers": DIST_SSM_LAYERS,
          "dtype": TP_GRAD_DTYPE[DIST_SSM_ARCH],
          "stacked_tp1": {k: tp1["records"][0][k]
                          for k in ("loss", "grad_norm")},
          "stacked_tp2": {k: tp2[0][k] for k in ("loss", "grad_norm")},
          "rel_diff_vs_tp1": gaps, "rel_diff_vs_stacked_tp2": vs_tp2,
          "bc_m_rel_vs_tp1": m_rel["bc"],
          "norms_m_rel_vs_tp1": m_rel["norms"], "tolerance": TP_GRAD_TOL,
          "ranks_s": max(run["run_s"][1] - run["run_s"][0]
                         for run in runs)})
    if not (all(v <= TP_GRAD_TOL for v in gaps.values())
            and m_rel["bc"] <= TP_GRAD_TOL):
        fail(f"dist_ssm_float64: against the stacked tp 1 step {gaps}, "
             f"wB / wC first moments {m_rel['bc']} (tolerance "
             f"{TP_GRAD_TOL})")
    return {**gaps, "bc_m_rel": m_rel["bc"]}


def dist_paths(dev) -> tuple[dict, dict]:
    """Phases ``dist_sync``, ``dist_main`` (4 gloo ranks on the one card,
    one peer a rank) and ``dist_nccl_sync``, ``dist_nccl_main`` (nccl at a
    world of ``torch.cuda.device_count()``, one rank a card), each world
    started by ``tools/distcheck.py``.

    ``*_sync``: each rank syncs its row of the seeded (P, 3, 65,536) arena
    through every strategy in ``scan`` and ``pipelined`` (tail drops 0.01
    on the lossy ones; the policies too at 4 ranks), ``pmax`` over a NaN
    and a partial ``ppermute``; over gloo also ``optireduce`` and
    ``optireduce_q`` (``pipelined``) on the full (4, 24, 6,553,600) arena.
    Against the stacked form on the same arenas and draws: each rank's
    result bitwise its row, the same loss fraction, and the rank's own
    kernel launches (B1-B6, T1) and permutes equal to the stacked sync's.
    Per rank and full-size case: launches, bytes sent through the group,
    host s in its calls (gloo only).

    ``*_main``: the launcher on every rank (``_dist_train_argv``: 2 steps
    of the main path, the global batch of 8 split over the ranks) against
    the stacked launcher's same steps at ``--dp`` the world: the ranks'
    parameters bitwise equal to each other after every step; rank 0's
    parameters, loss, loss_frac and grad norm within ``STEP_TOL`` of the
    stacked run's (bitwise recorded); each rank's kernel launches (B1, B2,
    T1 with the init's draws) the stacked run's. Per rank and step: host
    ms, peak bytes, bytes sent through the group, host s in its calls.

    ``dist_fsdp_main`` (gloo's world, after ``dist_main``): the launcher
    with ``--dp-mode fsdp`` on the ranks, each holding its shard of every
    sharded leaf, against ``fsdp_main``'s first steps (the same flags; see
    :func:`_dist_fsdp_held`). Gloo's ``dist_sync`` also reduce-scatters
    the embedding's shape (``DIST_RS``), plain and with the 8-bit wire,
    each rank's shard bitwise its stacked row.

    ``dist_pod_sync``, ``dist_pod_main``, ``dist_pod_fsdp_main`` (gloo's
    world, after those): the same ranks as a ``(pod 2, data 2)`` grid of
    groups, the syncs and :func:`dist_pod_jobs` against the stacked 2 x 2
    grid (see :func:`_dist_pod_held`). ``dist_tp_main`` and
    ``dist_tp_fsdp_main`` (gloo's world): the ranks as a ``(data 2, model
    2)`` grid, the launcher at ``--tp 2``, replicated and with
    ``--dp-mode fsdp`` (see :func:`_dist_tp_held`); then
    ``dist_moe_main`` and ``dist_moe_fsdp_main``, the same on the MoE
    family, and ``dist_ssm_main`` and ``dist_ssm_fsdp_main`` on the SSM
    family (and :func:`_dist_summed_held`); last the ranks' float64 step
    of ``dist_ssm_float64``, held later against ``tp_families_main``'s
    (:func:`dist_ssm_float64_held`); ``dist_frontend_main`` and
    ``dist_frontend_fsdp_main`` on the frontend-prefix family with
    ``--seq-parallel`` and the prefix, the first held later against
    ``tp_families_main``'s run of its flags (:func:`dist_reused_held`).
    Returned: each tp run's launches a rank a step and its seconds, the
    float64 step's reports, and the reused run's reports and kept files.

    Both worlds start at once and run their launcher first; both stacked
    sides run in this process meanwhile, during the ranks' start-up and
    cold first step. A world's second step waits for a file (``--wait-for``)
    that this process writes once the stacked sides have ended and nccl's
    rank has finished its first step (gloo's world) or gloo's ranks have
    ended (nccl's), so each world's later steps and its syncs have the card
    to themselves. Every second step's start on the wall clock is held
    against that release."""
    import shutil

    import torch
    distcheck = _distcheck()

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    worlds = [(DIST_RANKS, "gloo", True, ("dist_sync", "dist_main")),
              (torch.cuda.device_count(), "nccl", False,
               ("dist_nccl_sync", "dist_nccl_main"))]

    def argv(world, backend, full):
        flags = ["--device", "cuda", "--backend", backend, "--arena",
                 "%d,%d" % DIST_ARENA, "--block", str(BLOCK), "--packet",
                 str(DIST_PACKET), "--rate", str(DIST_RATE), "--threads",
                 str(DIST_THREADS), "--wait-for", str(out / backend / "go"),
                 "--train", json.dumps({
                     "name": "main", "argv": _dist_train_argv(world)
                     + ["--dist-backend", backend], "stride": DIST_STRIDE}),
                 "--save-params", "main"]
        if not full:
            return flags
        # the gloo world also trains FSDP over its ranks, reduce-scatters
        # the embedding's shape, and runs it all again as a pod grid
        return flags + ["--full", f"{ARENA_BUCKETS},{BUCKET}",
                        "--rs", "%d,%d" % DIST_RS, "--train", json.dumps({
                            "name": "fsdp", "state": True,
                            "stride": DIST_STRIDE,
                            "argv": _dist_train_argv(world)
                            + ["--dp-mode", "fsdp", "--dist-backend",
                               backend]}),
                        "--pods", f"1,{DIST_PODS}", "--pod-rate",
                        str(DIST_POD_RATE)] + [
            arg for job in dist_pod_jobs(world).values()
            for arg in ("--pod-train", json.dumps(job))] + dist_tp_jobs(world)

    free_card()
    deferred = None
    t0 = time.perf_counter()
    procs = [distcheck.start(out / backend, world,
                             argv(world, backend, full))
             for world, backend, full, _ in worlds]
    try:
        wants = [_stacked_side(dev, world, full=full)
                 for world, _, full, _ in worlds]
        stacked_s = time.perf_counter() - t0
        free_card()
        try:
            # nccl's rank idles before gloo's ranks go on
            distcheck.await_ready(procs[1], out / "nccl" / "go",
                                  timeout=DIST_TIMEOUT_S)
        except Exception as e:
            fail(f"dist_nccl_main: {e}")
        for (world, backend, _, phases), ranks, want in zip(worlds, procs,
                                                            wants):
            released = time.time()
            (out / backend / "go").touch()
            try:
                distcheck.wait(ranks, timeout=DIST_TIMEOUT_S)
            except Exception as e:      # a rank's failure or a hang
                fail(f"{phases[0]}: {e}")
            times = {"stacked_s": stacked_s, "released": released,
                     "ranks_s": time.perf_counter() - t0}
            reports = distcheck.reports(out / backend, world)
            _dist_held(phases, world, want, reports,
                       out / backend / "main.pt", times)
            if backend == "gloo":
                _dist_fsdp_held(reports)
                _dist_pod_held(reports, want)
                tp = {run: _dist_tp_held(reports, want["tp"][run],
                                         out / backend, run)
                      for run in want["tp"]}
                for run in want["tp"]:
                    if dist_family(run) != "dense":
                        _dist_summed_held(want["tp"][run], out / backend,
                                          run, world)
                # held after tp_families_main, whose run is its stacked
                # side: its reports and files kept until then
                deferred = {"reports": reports,
                            "dir": Path(tempfile.mkdtemp(
                                prefix="chip_smoke_reused_"))}
                for path in (out / backend).glob(f"{DIST_REUSED}.rank*"):
                    shutil.move(str(path), deferred["dir"] / path.name)
                # the float64 step's reports and each rank's first
                # moments of its leaves replicated over tp (the state's
                # first half), read before the directory goes
                f64 = {"runs": [rep["train"][DIST_SSM_F64]
                                for rep in reports],
                       "m": [_first_moments(torch.load(
                           out / backend / f"{DIST_SSM_F64}.rank{r}.rep.pt"))
                           for r in range(world)]}
    finally:
        for proc in (p for ranks in procs for p in ranks):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(out, ignore_errors=True)
    free_card()
    return tp, f64, deferred


def dist_reused_held(deferred: dict, stacked: dict) -> dict:
    """Phases ``dist_frontend_main`` and ``dist_frontend_main_summed``:
    gloo's ranks' ``DIST_REUSED`` run (``deferred``: their reports and
    saved leaves, kept by :func:`dist_paths`) held as the other tp grid
    runs are (:func:`_dist_tp_held`, :func:`_dist_summed_held`) against
    ``tp_families_main``'s run of the same flags (``stacked``: its records,
    last parameters, launches a step, seconds and the leaves replicated
    over tp with their moments). Returns the held row."""
    import shutil

    from repro_torch.launch import train as launch_train
    world = len(deferred["reports"])
    extra = dict((a, e) for a, _, e in TP_FAMILIES_MAIN)[DIST_FRONTEND_ARCH]
    flags = [vars(launch_train.parser().parse_args(argv)) for argv in (
        dist_family_argv(world, True, "frontend")
        + DIST_FRONTEND_RUNS[DIST_REUSED],
        [*train_argv("optireduce", arch=DIST_FRONTEND_ARCH), "--steps",
         str(TP_FAMILIES_STEPS), "--dp", "2", "--tp", str(TP), *extra])]
    for f in flags:
        f.pop("dist_backend")
    if flags[0] != flags[1]:
        fail(f"dist_{DIST_REUSED}: the ranks' flags {flags[0]} are not "
             f"tp_families_main's {flags[1]}")
    try:
        held = _dist_tp_held(deferred["reports"], stacked, deferred["dir"],
                             DIST_REUSED)
        _dist_summed_held(stacked, deferred["dir"], DIST_REUSED, world)
    finally:
        shutil.rmtree(deferred["dir"], ignore_errors=True)
    free_card()
    return held


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


def emit_profile(prof, label: dict, wall_ms: float | None,
                 prof_wall_ms: float, peak: int, permutes: int) -> None:
    """The ``profile`` row of one profiled step: ``wall_ms`` is the
    unprofiled step before it (None where the profiled step is the run's
    only one), ``prof_wall_ms`` the profiled step's host time."""
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
          "step_ms_unprofiled": wall_ms if wall_ms is not None
          else "not measured", "step_ms_profiled": prof_wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          # busy over the profiled step's wall time; the second share
          # divides the same busy time by the unprofiled step before it,
          # which runs the same kernels without the profiler's host cost
          "device_idle_share_of_profiled_step": (1 - busy_ms / prof_wall_ms)
          if busy_ms > 0 else "not measured",
          "device_idle_share_of_unprofiled_step": (1 - busy_ms / wall_ms)
          if busy_ms > 0 and wall_ms is not None else "not measured",
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
    if sys.argv[1:] == ["--netsim"]:     # the netsim phase's own process
        sys.path.insert(0, str(ROOT / "src"))
        run_netsim()
        sys.exit(0)
    sys.exit(main())
