"""The process-group form of the peer grid (one rank a peer over gloo)
against the stacked form on one device, on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py``, torchrun's
environment on 127.0.0.1 and a free port). Each rank syncs its
row of a seeded (4, 3, 6000) arena through every registered strategy in
``scan`` and ``pipelined`` (tail drops 0.05 on the lossy ones) and the
participation policies, runs ``pmax`` over a NaN and a ``ppermute`` that
names only some destinations, then trains gpt2-smoke through the launcher
for 2 steps three times: ``optireduce`` and ``optireduce_q`` at tail drops
0.01 (``pipelined``), and ``optireduce`` at 0.3 (``scan``), which the 0.10
``loss_frac`` guard skips. The parent runs the same on the stacked form.

Everything is held bit for bit: each rank's synced row is row r of the
stacked result, with the same loss fraction and ``permutes``; after every
step the four ranks' parameters are equal to each other and to the stacked
form's, and rank 0's records (loss, loss_frac, grad_norm, skipped) equal
the stacked run's. The flags this form does not run yet raise.
"""
import json
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
SYNC_CASES = [name for name, *_ in distcheck.cases()]
METRICS = ("loss", "loss_frac", "grad_norm", "skipped")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("distcheck")
    go = out / "go"
    argv = ["--device", "cpu", "--arena", ",".join(map(str, ARENA)),
            "--block", str(SYNC["block"]), "--packet", str(SYNC["packet"]),
            "--rate", str(SYNC["rate"]), "--threads", "1",
            "--wait-for", str(go)]
    for name, flags in RUNS.items():
        argv += ["--train", json.dumps({
            "name": name, "argv": COMMON + flags + ["--dist-backend",
                                                    "gloo"]})]
    procs = distcheck.start(out, WORLD, argv)
    distcheck.await_ready(procs, go, timeout=300)
    go.touch()      # the ranks' steps after the first wait for this
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return reports, arrays, go.stat().st_mtime


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
    prims = dict(distcheck.primitive_cases(x, collectives.ONE))
    train = {}
    for name, flags in RUNS.items():
        with distcheck.watch_steps() as seen:
            records = launch_train.run(COMMON + flags + ["--dp", str(WORLD)])
        train[name] = (records, seen["digests"])
    return sync, prims, train, x


@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_row_is_the_stacked_row(ranks, stacked, case):
    reports, arrays, _ = ranks
    y, frac, launched = stacked[0][case]
    for r in range(WORLD):
        got = reports[r]["sync"][case]
        if got["digest"] != distcheck.digest(y[r]):
            diff = np.abs(arrays[r][case][0] - y[r].numpy()).max()
            pytest.fail(f"{case}: rank {r} differs from row {r} "
                        f"(max abs {diff})")
        assert got["loss_frac"] == frac
        assert got["launches"]["permutes"] == launched["permutes"]


def test_pmax_passes_nan(ranks, stacked):
    reports, arrays, _ = ranks
    want = stacked[1]["pmax_nan"]
    assert torch.isnan(want[:, 3]).all()
    for r in range(WORLD):
        assert reports[r]["sync"]["pmax_nan"]["digest"] == \
            distcheck.digest(want[r])
        assert np.isnan(arrays[r]["pmax_nan"][0, 3])


def test_ppermute_missing_destinations_get_zeros(ranks, stacked):
    reports, arrays, _ = ranks
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
    reports, _, _ = ranks
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
    reports, _, _ = ranks
    records, digests = stacked[2][run]
    got = reports[0]["train"][run]
    assert got["digests"] == digests
    for a, b in zip(got["records"], records):
        assert {k: a[k] for k in METRICS} == {k: b[k] for k in METRICS}


REFUSED = [["--tp", "2"], ["--production-mesh"], ["--dp-mode", "fsdp"],
           ["--sync-mode", "vmap"], ["--recovery", "stale"],
           ["--transport", "inproc"], ["--adaptive"]]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: f[0])
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


TRAINER_REFUSED = {"fsdp": dict(dp_mode="fsdp"), "pure_dp": dict(pure_dp=True),
                   "vmap": dict(sync_mode="vmap"),
                   "recovery": dict(recovery="stale"),
                   "transport": dict(transport_override=object())}


@pytest.mark.parametrize("case", list(TRAINER_REFUSED))
def test_trainer_refuses_later_slices(one_rank_group, case):
    from repro_torch.configs import get_smoke
    from repro_torch.core.pipeline import OptiReduceConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import TrainConfig, build_train_step
    kw = dict(TRAINER_REFUSED[case])
    sync = OptiReduceConfig(recovery=kw.pop("recovery", "none"))
    mesh = make_host_mesh(dp=1, tp=2 if case == "pure_dp" else 1)
    with pytest.raises(ValueError, match="A18c"):
        build_train_step(get_smoke("gpt2-paper"), TrainConfig(sync=sync, **kw),
                         mesh, device="cpu", group=one_rank_group)


def test_trainer_over_one_rank_is_the_one_peer_step(one_rank_group):
    """A world of one rank: the group form's step is the stacked step of
    one peer, bit for bit."""
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
                     bucket_elems=16_384, seq_chunk=32)
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
    reports, _, go = ranks
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
