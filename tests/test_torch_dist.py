"""The process-group form of the peer grid (one rank a peer over gloo)
against the stacked form on one device, on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py``, torchrun's
environment on 127.0.0.1 and a free port). Each rank syncs its
row of a seeded (4, 3, 6000) arena through every registered strategy in
``scan`` and ``pipelined`` (tail drops 0.05 on the lossy ones) and the
participation policies, runs ``pmax`` over a NaN and a ``ppermute`` that
names only some destinations, reduce-scatters a seeded (4, 512, 64) bf16
gradient (the embedding's shape) along dim 1, plain and with the 8-bit
wire, then trains gpt2-smoke through the launcher for 2 steps three
times: ``optireduce`` and ``optireduce_q`` at tail drops 0.01
(``pipelined``), and ``optireduce`` at 0.3 (``scan``), which the 0.10
``loss_frac`` guard skips; then FSDP (ZeRO-3, ``--dp-mode fsdp``, tail
0.01) for 2 steps with a checkpoint, and a second run of the same world
that resumes it for the third step. The parent runs the same on the
stacked form (FSDP: 3 uninterrupted steps, each sliced as the ranks hold
it, ``train/elastic.py``), and resumes the ranks' checkpoint itself.

Everything is held bit for bit: each rank's synced row (reduced shard) is
row r of the stacked result, with the same loss fraction and
``permutes``; after every step the four ranks' parameters are equal to
each other and to the stacked form's, and rank 0's records (loss,
loss_frac, grad_norm, skipped) equal the stacked run's. Under FSDP each
rank's parameters and AdamW moments are slice r of the stacked form's,
its replicated leaves equal, its state bytes its shard's alone. The flags
this form does not run yet raise, and so does a pod grid larger than the
world (``tests/test_torch_dist_pods.py`` runs the pod grid over ranks).
"""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import collectives
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
ARENA = (3, 6000)
SYNC = dict(rate=0.05, block=256, packet=64)
COMMON = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "32",
          "--global-batch", "8", "--log-every", "1", "--drop-pattern",
          "tail"]
RUNS = {"optireduce": ["--drop-rate", "0.01"],
        "optireduce_q": ["--drop-rate", "0.01", "--strategy", "optireduce_q"],
        "guard_skip": ["--drop-rate", "0.3", "--sync-mode", "scan"]}
FSDP = ["--drop-rate", "0.01", "--dp-mode", "fsdp"]
# the FSDP runs of the ranks' world: (flags past COMMON + FSDP, the
# uninterrupted stacked steps they run)
FSDP_RUNS = {"fsdp": ([], (0, 1)),
             "fsdp_resume": (["--steps", "3", "--resume"], (2,))}
RS_SHAPE = (512, 64)            # gpt2-smoke's embedding
SYNC_CASES = ([name for name, *_ in distcheck.cases()]
              + [name for name, _ in distcheck.RS_BITS])
METRICS = ("loss", "loss_frac", "grad_norm", "skipped")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("distcheck")
    go = out / "go"
    ckpt = out / "ckpt"
    argv = ["--device", "cpu", "--arena", ",".join(map(str, ARENA)),
            "--block", str(SYNC["block"]), "--packet", str(SYNC["packet"]),
            "--rate", str(SYNC["rate"]), "--threads", "1",
            "--wait-for", str(go), "--rs", ",".join(map(str, RS_SHAPE))]
    for name, flags in RUNS.items():
        argv += ["--train", json.dumps({
            "name": name, "argv": COMMON + flags + ["--dist-backend",
                                                    "gloo"]})]
    for name, (flags, _) in FSDP_RUNS.items():
        argv += ["--train", json.dumps({
            "name": name, "state": True,
            "argv": COMMON + FSDP + flags + ["--ckpt-dir", str(ckpt),
                                             "--dist-backend", "gloo"]})]
    procs = distcheck.start(out, WORLD, argv)
    distcheck.await_ready(procs, go, timeout=300)
    go.touch()      # the ranks' steps after the first wait for this
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return reports, arrays, go.stat().st_mtime, ckpt


@pytest.fixture(scope="module")
def stacked():
    """The stacked form's side, on one torch thread as the ranks run (a
    CPU matmul's sums may split by the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _stacked()
    finally:
        torch.set_num_threads(threads)


def _stacked():
    x = distcheck.peer_rows(range(WORLD), *ARENA, 0, "cpu")
    sync = {name: (y, frac, launched) for name, y, frac, launched in
            distcheck.sync_cases(x, collectives.ONE, **SYNC)}
    g = distcheck.peer_rows(range(WORLD), *RS_SHAPE, 1, "cpu")
    sync.update((name, (y, frac, launched)) for name, y, frac, launched in
                distcheck.rs_cases(g, collectives.ONE, **SYNC))
    prims = dict(distcheck.primitive_cases(x, collectives.ONE))
    train = {}
    for name, flags in RUNS.items():
        with distcheck.watch_steps() as seen:
            records = launch_train.run(COMMON + flags + ["--dp", str(WORLD)])
        train[name] = (records, seen["digests"])
    # FSDP: 3 uninterrupted steps, each rank's slice digested
    with distcheck.watch_steps(state=True, shards=WORLD) as seen:
        records = launch_train.run(COMMON + FSDP + ["--steps", "3", "--dp",
                                                    str(WORLD)])
    train["fsdp"] = (records, seen)
    return sync, prims, train, x


@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_row_is_the_stacked_row(ranks, stacked, case):
    reports, arrays, _, _ = ranks
    y, frac, launched = stacked[0][case]
    for r in range(WORLD):
        got = reports[r]["sync"][case]
        if got["digest"] != distcheck.digest(y[r]):
            diff = np.abs(arrays[r][case][0] - y[r].float().numpy()).max()
            pytest.fail(f"{case}: rank {r} differs from row {r} "
                        f"(max abs {diff})")
        assert got["loss_frac"] == frac
        assert got["launches"]["permutes"] == launched["permutes"]


def test_pmax_passes_nan(ranks, stacked):
    reports, arrays, _, _ = ranks
    want = stacked[1]["pmax_nan"]
    assert torch.isnan(want[:, 3]).all()
    for r in range(WORLD):
        assert reports[r]["sync"]["pmax_nan"]["digest"] == \
            distcheck.digest(want[r])
        assert np.isnan(arrays[r]["pmax_nan"][0, 3])


def test_ppermute_missing_destinations_get_zeros(ranks, stacked):
    reports, arrays, _, _ = ranks
    want, sent = stacked[1]["ppermute_partial"], stacked[3][:, 0, :64]
    src = {d: s for s, d in distcheck.permute_pairs(WORLD)}
    for r in range(WORLD):
        assert reports[r]["sync"]["ppermute_partial"]["digest"] == \
            distcheck.digest(want[r])
        row = arrays[r]["ppermute_partial"][0]
        if r in src:
            assert np.array_equal(row, sent[src[r]].numpy())
        else:
            assert not row.any()


@pytest.mark.parametrize("run", list(RUNS))
def test_ranks_hold_equal_params_each_step(ranks, run):
    reports, _, _, _ = ranks
    digests = [reports[r]["train"][run]["digests"] for r in range(WORLD)]
    assert len(digests[0]) == 2
    assert all(d == digests[0] for d in digests)
    records = [reports[r]["train"][run]["records"] for r in range(WORLD)]
    for rec in records[1:]:
        for a, b in zip(records[0], rec):
            assert all(a[k] == b[k] for k in METRICS)
    skipped = [rec["skipped"] for rec in records[0]]
    assert skipped == ([1.0, 1.0] if run == "guard_skip" else [0.0, 0.0])
    for rec in records[0]:
        assert rec["dist_bytes"] > 0 and rec["dist_s"] >= 0


@pytest.mark.parametrize("run", list(RUNS))
def test_rank0_steps_are_the_stacked_steps(ranks, stacked, run):
    reports, _, _, _ = ranks
    records, digests = stacked[2][run]
    got = reports[0]["train"][run]
    assert got["digests"] == digests
    for a, b in zip(got["records"], records):
        assert {k: a[k] for k in METRICS} == {k: b[k] for k in METRICS}


# "--tp": tp over ranks runs (tests/test_torch_dist_tp.py), and with
# --dp-mode fsdp (tests/test_torch_dist_tp_fsdp.py), either with
# --seq-parallel too (tests/test_torch_dist_frontend.py), but not on a
# sequence that does not split over tp (31 tokens over 2)
REFUSED = [["--tp", "2", "--seq-parallel", "--seq-len", "31"],
           ["--production-mesh"],
           ["--dp-mode", "fsdp", "--tp", "2", "--seq-parallel", "--seq-len",
            "31"],
           ["--dp-mode", "fsdp", "--production-mesh"],
           ["--sync-mode", "vmap"], ["--recovery", "stale"],
           ["--transport", "inproc"], ["--adaptive"]]


@pytest.mark.parametrize("flags", REFUSED,
                         ids=lambda f: "fsdp" + f[2] if f[1:2] == ["fsdp"]
                         else f[0])
def test_launcher_refuses_later_slices(monkeypatch, flags):
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    with pytest.raises(ValueError, match="A18c"):
        launch_train.run(COMMON + flags)


def test_launcher_checks_dp_and_backend(monkeypatch):
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.run(COMMON + ["--dist-backend", "gloo"])
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    with pytest.raises(ValueError, match="one peer a rank"):
        launch_train.run(COMMON + ["--dp", "3"])
    with pytest.raises(ValueError, match="A18c"):
        launch_serve.main(["--smoke", "--device", "cpu"])


@pytest.fixture
def one_rank_group(tmp_path):
    """A world of one gloo rank in this process, through a file store."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


# the pure_dp cases: a grid of 2 pods (the (data 1, model 2) mesh's model
# axis) over a world of one rank, which the pod grid over ranks refuses by
# its size
MISMATCH = r"a grid of 2 peers \(2 pods\) over a process group of 1 ranks"
TRAINER_REFUSED = {"fsdp_pure_dp": (dict(dp_mode="fsdp", pure_dp=True),
                                    MISMATCH),
                   # FSDP x TP runs, with sequence parallelism too
                   # (tests/test_torch_dist_frontend.py): it gets past
                   # the later slices' checks to the world's size
                   "fsdp_tp": (dict(dp_mode="fsdp", tp=2,
                                    seq_parallel=True),
                               r"a grid of 1 peers \(1 pods, tp 2\) over a "
                               "process group of 1 ranks"),
                   "pure_dp": (dict(pure_dp=True), MISMATCH),
                   "vmap": (dict(sync_mode="vmap"), "A18c"),
                   "recovery": (dict(recovery="stale"), "A18c"),
                   "transport": (dict(transport_override=object()), "A18c")}


@pytest.mark.parametrize("case", list(TRAINER_REFUSED))
def test_trainer_refuses_later_slices(one_rank_group, case):
    """The later slices of A18c raise naming it; a pod grid whose size is
    not the world's, and FSDP x TP with sequence parallelism on a world
    that is not 2 ranks, raise on the mismatch."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.pipeline import OptiReduceConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import TrainConfig, build_train_step
    kw, match = TRAINER_REFUSED[case]
    kw = dict(kw)
    sync = OptiReduceConfig(recovery=kw.pop("recovery", "none"))
    tp = kw.pop("tp", 2 if kw.get("pure_dp") else 1)
    mesh = make_host_mesh(dp=1, tp=tp)
    with pytest.raises(ValueError, match=match):
        build_train_step(get_smoke("gpt2-paper"), TrainConfig(sync=sync, **kw),
                         mesh, device="cpu", group=one_rank_group)


def test_trainer_over_one_rank_is_the_one_peer_step(one_rank_group):
    """A world of one rank: the group form's step is the stacked step of
    one peer, bit for bit."""
    _one_rank_against_one_peer(one_rank_group, "replicated")


def test_fsdp_trainer_over_one_rank_is_the_one_peer_step(one_rank_group):
    """FSDP over a world of one rank (its shards are the whole leaves):
    the group form's step is the stacked FSDP step of one peer."""
    _one_rank_against_one_peer(one_rank_group, "fsdp")


def _one_rank_against_one_peer(one_rank_group, dp_mode):
    from repro_torch.configs import get_smoke
    from repro_torch.core.keys import key
    from repro_torch.core.pipeline import OptiReduceConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train.trainer import TrainConfig, build_train_step
    cfg = get_smoke("gpt2-paper")
    tc = TrainConfig(sync=OptiReduceConfig(drop_rate=0.05,
                                           hadamard_block=256),
                     bucket_elems=16_384, seq_chunk=32, dp_mode=dp_mode)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=2, seed=0)).host_batch(0, 0, 1)
    out = []
    for group in (None, one_rank_group):
        step, opt = build_train_step(cfg, tc, make_host_mesh(dp=1),
                                     device="cpu", group=group)
        params = init_params(key(0), cfg, device="cpu")
        params, _, m = step(params, opt.init(params), batch, 0, key(0))
        out.append((distcheck.tree_digest(params),
                    {k: float(v) for k, v in m.items()}))
    assert out[0] == out[1]


@pytest.mark.parametrize("run", list(RUNS))
def test_steps_after_the_first_wait_for_the_file(ranks, run):
    """``--wait-for``: every rank's second step starts after the file
    appeared, and its first step waited for it."""
    reports, _, go, _ = ranks
    for r in range(WORLD):
        got = reports[r]["train"][run]
        assert len(got["starts"]) == 2 and got["starts"][1] >= go
    assert reports[0]["train"][list(RUNS)[0]]["wait_s"] >= 0.0


def test_wait_raises_with_a_failed_ranks_output(tmp_path):
    procs = distcheck.start(tmp_path, 1, ["--device", "cpu", "--arena", "x"])
    with pytest.raises(RuntimeError, match=r"rank 0 exit 2\][\s\S]*--arena"):
        distcheck.wait(procs, timeout=120)


def test_distcheck_runs_on_the_card_by_default(monkeypatch):
    """Without ``--device`` a rank asks for the card, as the launchers do,
    and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distcheck.main(["unused"])


def test_kernel_build_lock_excludes_other_processes():
    """Ranks that start together build each kernel library once: while
    one process holds the build lock, another cannot take it."""
    import subprocess
    import sys

    from repro_torch.kernels import build
    probe = ("import fcntl, sys\n"
             "f = open(sys.argv[1], 'w')\n"
             "try:\n"
             "    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
             "except BlockingIOError:\n"
             "    sys.exit(3)\n")
    lock = str(build.BUILD_DIR / ".lock")
    with build._build_lock():
        held = subprocess.run([sys.executable, "-c", probe, lock])
    free = subprocess.run([sys.executable, "-c", probe, lock])
    assert (held.returncode, free.returncode) == (3, 0)


def _fsdp_side(stacked):
    return stacked[2]["fsdp"]


@pytest.mark.parametrize("run", list(FSDP_RUNS))
def test_fsdp_rank_holds_slice_r_of_the_stacked_state(ranks, stacked, run):
    """After every step each rank's parameters and AdamW moments are
    bitwise its slice of the stacked form's (``elastic.split_leaf``); the
    resumed run's step is the uninterrupted third step."""
    reports, _, _, _ = ranks
    _, seen = _fsdp_side(stacked)
    want = [seen["digests"][i] for i in FSDP_RUNS[run][1]]
    for r in range(WORLD):
        got = reports[r]["train"][run]["digests"]
        assert got == [w[r] for w in want], f"rank {r}"


@pytest.mark.parametrize("run", list(FSDP_RUNS))
def test_fsdp_ranks_share_the_replicated_leaves(ranks, stacked, run):
    reports, _, _, _ = ranks
    _, seen = _fsdp_side(stacked)
    want = [seen["replicated"][i] for i in FSDP_RUNS[run][1]]
    for r in range(WORLD):
        assert reports[r]["train"][run]["replicated"] == want, f"rank {r}"


@pytest.mark.parametrize("run", list(FSDP_RUNS))
def test_fsdp_rank0_records_are_the_stacked_records(ranks, stacked, run):
    reports, _, _, _ = ranks
    records, _ = _fsdp_side(stacked)
    want = [records[i] for i in FSDP_RUNS[run][1]]
    for r in range(WORLD):
        got = reports[r]["train"][run]["records"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert {k: a[k] for k in METRICS} == {k: b[k] for k in METRICS}
        for rec in got:
            assert rec["dist_bytes"] > 0 and rec["skipped"] == 0.0


def test_fsdp_rank_holds_its_shard_bytes_alone(ranks):
    """A rank holds exactly its shard of every sharded leaf and of its two
    AdamW moments, and the replicated leaves whole: no full leaf of the
    init survives (a shard that were a view of one would count it)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import _map_table, param_table
    reports, _, _, _ = ranks
    cfg = get_smoke("gpt2-paper")
    leaves = []
    _map_table(leaves.append, param_table(cfg, fsdp_axes=("data",)))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    entries = sum(int(np.prod(leaf.shape)) // (1 if leaf.fsdp_dim is None
                                                else WORLD)
                  for leaf in leaves)
    want = entries * (itemsize + 2 * 4)
    for r in range(WORLD):
        for run in FSDP_RUNS:
            got = reports[r]["train"][run]["state_bytes"]
            assert got == [want] * len(FSDP_RUNS[run][1]), (r, run)


def test_stacked_form_resumes_the_ranks_checkpoint(ranks, stacked,
                                                   tmp_path):
    """The ranks' checkpoint holds the full leaves, the stacked form's
    format: the stacked launcher resumes it, and its step is the
    uninterrupted third step."""
    _, _, _, ckpt = ranks
    records, seen = _fsdp_side(stacked)
    ckpt_dir = tmp_path / "ckpt"      # the ranks' save after 2 steps
    shutil.copytree(ckpt / "step_00000002", ckpt_dir / "step_00000002")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with distcheck.watch_steps(state=True, shards=WORLD) as resumed:
            got = launch_train.run(COMMON + FSDP + [
                "--steps", "3", "--resume", "--ckpt-dir", str(ckpt_dir),
                "--dp", str(WORLD)])
    finally:
        torch.set_num_threads(threads)
    assert resumed["digests"] == [seen["digests"][2]]
    assert {k: got[0][k] for k in METRICS} == \
        {k: records[2][k] for k in METRICS}
