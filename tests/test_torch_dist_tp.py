"""Tensor parallelism over ranks: the launcher's ``--dp 2 --tp 2`` on a
``(data 2, model 2)`` grid of gloo process groups, one tp rank a process,
against the stacked tp form on one device and the JAX package's trainer,
on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py --tp 2``,
torchrun's environment on 127.0.0.1 and a free port): rank ``r = i * 2 +
t`` is data index i, tp rank t, and makes its tp group and its data group
once. Each rank syncs its row of a seeded (4, 3, 6000) arena (the stacked
grid's row ``t * 2 + i``) through ``optireduce`` and ``optireduce_q`` in
``scan`` and ``pipelined`` at tail drops 0.05 over its data group, and
runs ``psum`` over its tp group and ``pmax`` over a NaN; then the launcher
under torchrun trains, each rank holding only its tp shard: gpt2-smoke
and smollm-smoke (GQA with one KV head, heads padded 3 -> 4,
``kv_replicated`` and ``kv_single`` at tp 2) for 2 AdamW steps at drop 0,
gpt2-smoke at tail drops 0.05 for 2 steps with a checkpoint, and a third
step resumed from it. The parent runs the same launcher flags as one
process (the stacked tp form) meanwhile, and one child runs the
reference's trainer on 4 forced host devices: 2 steps at ``tp = 1`` on
``(data 2, model 1)`` and one at ``tp = 2`` on ``(data 2, model 2)``, from
its padded tp-2 init.

Held bit for bit: each rank's synced row, loss fraction and launches are
its stacked row's; after every step the leaves replicated over tp (the
norms, and under ``kv_replicated`` the K / V projections, with their
moments) are equal on all four ranks, and each rank's state is its data
replica's; init's shards put back together are the stacked init; the
ranks' checkpoint is their shards put back together.

Not bit for bit: whole steps against the stacked form. A rank's "f" (the
identity whose backward sums the tp group's input gradients) adds T
partial products where the stacked form runs one GEMM over the whole
weight, and each rank's sum of squares of its shard is added over the tp
group where the stacked form sums one ``(T, ...)`` run. Measured on these
steps: loss within 7.9e-8 and grad_norm within 3.4e-6 relative, moments
within 4.0e-7 and 1.5e-8, parameters within 3.2e-4 (AdamW moves an entry
of a tiny gradient by ~lr whatever its size; ROADMAP C, "Known
differences"). So the steps are held, against the stacked form and
against the reference (its ``tp = 2`` loss, its ``tp = 1`` gradients:
its tp gradients are wrong, ROADMAP C), with ``tests/test_torch_tp_step.py``'s
tolerances: loss and grad_norm 1e-5 relative, AdamW's moments 1e-6 and
1e-7 absolute, parameters 1e-1 x lr. The refused combinations raise
naming their slice of ROADMAP A18c (FSDP x TP runs:
``tests/test_torch_dist_tp_fsdp.py``; the MoE family:
``tests/test_torch_dist_moe.py``; the frontend-prefix families and
sequence parallelism: ``tests/test_torch_dist_frontend.py``).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import collectives
from repro_torch.core.keys import key as torch_key
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.models.transformer import tp_dims
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
TP = 2
DP = WORLD // TP
ARENA = (3, 6000)
SYNC = dict(rate=0.05, block=256, packet=64)
LR = 1e-2
SEQ = 32
GLOBAL_BATCH = 8
COMMON = ["--smoke", "--device", "cpu", "--dp", str(DP), "--tp", str(TP),
          "--seq-len", str(SEQ), "--global-batch", str(GLOBAL_BATCH),
          "--log-every", "1", "--lr", str(LR), "--drop-pattern", "tail"]
ARCHS = {"gpt2": "gpt2-paper", "smollm": "smollm-360m"}
DROPS = ["--arch", "gpt2-paper", "--drop-rate", "0.05"]
SYNC_CASES = [name for name, *_ in distcheck.cases(
    strategies=distcheck.TP_STRATEGIES, policies=None)]
PRIMITIVES = ("psum_model", "pmax_nan")
METRICS = ("loss", "grad_norm", "loss_frac", "skipped")
PARAM_TOL = 1e-1 * LR
REF_JOB = {"archs": list(ARCHS.values()), "tp": TP, "dp": DP, "steps": 2,
           "seq_len": SEQ, "global_batch": GLOBAL_BATCH, "seed": 0,
           "lr": LR, "block": 1024}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.core.allreduce import OptiReduceConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, job = sys.argv[1], eval(sys.argv[2])
save = {}
for arch in job["archs"]:
    cfg = get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=job["seq_len"],
                                  global_batch=job["global_batch"],
                                  seed=job["seed"]))
    key = jax.random.PRNGKey(job["seed"])
    params0 = init_params(key, cfg, tp=job["tp"])
    # tp = 1 on the padded tree (its gradients), then tp = T (its loss)
    for tp, steps in ((1, job["steps"]), (job["tp"], 1)):
        tc = TrainConfig(sync=OptiReduceConfig(hadamard_block=job["block"]),
                         optimizer=OptimizerConfig(lr=job["lr"]),
                         seq_chunk=job["seq_len"])
        mesh = make_mesh((job["dp"], tp), ("data", "model"))
        make_step, opt, _ = build_train_step(cfg, tc, mesh)
        step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                                data.host_batch(0, 0, 1))
        params = jax.device_put(params0, sh["params"])
        opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
        jf = jax.jit(step_fn)
        for step in range(steps):
            batch = jax.device_put(data.host_batch(step, 0, 1), sh["batch"])
            params, opt_state, m = jf(params, opt_state, batch,
                                      jnp.asarray(step, jnp.int32), key)
            pre = f"{arch}/tp{tp}/{step}"
            for k, v in m.items():
                save[f"{pre}/metric/{k}"] = np.asarray(v)
            if tp > 1:
                continue
            leaves = (jax.tree.leaves(params) + jax.tree.leaves(opt_state.m)
                      + jax.tree.leaves(opt_state.v))
            for i, leaf in enumerate(leaves):
                save[f"{pre}/leaf/{i}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(out_path, **save)
print("child OK")
"""


def _jobs(ckpt: Path) -> dict:
    """The ranks' launcher runs: name -> (argv past COMMON, save)."""
    jobs = {name: (["--arch", arch, "--steps", "2"], True)
            for name, arch in ARCHS.items()}
    jobs["drops"] = (DROPS + ["--steps", "2", "--ckpt-dir", str(ckpt)], True)
    jobs["resume"] = (DROPS + ["--steps", "3", "--resume", "--ckpt-dir",
                               str(ckpt)], True)
    return jobs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps, in a child started first: it runs while the
    ranks and the stacked side do."""
    out = tmp_path_factory.mktemp("dist_tp_ref") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(out), repr(REF_JOB)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref_result(ref):
    proc, out = ref
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The 4 ranks, started (after the reference's child) and running."""
    out = tmp_path_factory.mktemp("distcheck_tp")
    ckpt = out / "ckpt"
    argv = ["--device", "cpu", "--tp", str(TP), "--arena",
            ",".join(map(str, ARENA)), "--block", str(SYNC["block"]),
            "--packet", str(SYNC["packet"]), "--rate", str(SYNC["rate"]),
            "--threads", "1"]
    for name, (flags, save) in _jobs(ckpt).items():
        argv += ["--tp-train", json.dumps({
            "name": name, "argv": COMMON + flags, "save": save})]
    procs = distcheck.start(out, WORLD, argv)
    try:
        yield procs, out, ckpt
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _stacked_run(flags: list) -> dict:
    return distcheck.tp_train({"name": "stacked", "argv": COMMON + flags,
                               "save": True})


@pytest.fixture(scope="module")
def stacked(world):
    """The stacked form's side, computed while the ranks run, on one torch
    thread as they run: the sync cases on the stacked ``(data 2, model
    2)`` grid, and the launcher's runs as one process (the drops run for
    3 uninterrupted steps)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sync = {name: (y, frac, launched) for name, y, frac, launched in
                distcheck.grid_cases(collectives.Grid(tp=TP), range(WORLD),
                                     "cpu", world=WORLD, arena=ARENA,
                                     pod_rate=SYNC["rate"], **SYNC)}
        train = {name: _stacked_run(["--arch", arch, "--steps", "2"])
                 for name, arch in ARCHS.items()}
        train["drops"] = _stacked_run(DROPS + ["--steps", "3"])
        return sync, train
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world, stacked):
    procs, out, ckpt = world
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    leaves = {name: [torch.load(out / f"{name}.rank{r}.pt")
                     for r in range(WORLD)] for name in _jobs(ckpt)}
    return reports, arrays, leaves, ckpt


def _dims(arch: str) -> list:
    """Each leaf's tp dim in the order the ranks save them: the
    parameters', then AdamW's two moments'."""
    return tp_dims(get_smoke(arch), TP) * 3


def _slices(leaf: torch.Tensor, dim, t: int) -> torch.Tensor:
    return leaf if dim is None else elastic.split_leaf(leaf, dim, TP)[t]


def _assembled(rank_leaves: list, dims: list) -> list:
    """The full leaves of one step from the ranks' shards: tp rank t's
    chunks of data index 0, joined along each tp dim."""
    return [elastic.join_leaf([rank_leaves[t][i] for t in range(TP)], d)
            for i, d in enumerate(dims)]


# ------------------------------------------------------------------- sync
@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_row_is_the_stacked_row(ranks, stacked, case):
    """Each rank's data-axis sync of its row is, bit for bit, its row of
    the stacked ``(data 2, model 2)`` grid's sync on the same arenas and
    draws: the same loss fraction and launches."""
    reports, arrays, _, _ = ranks
    y, frac, launched = stacked[0][f"tp{TP}:{case}"]
    rows = distcheck.tp_stacked_rows(WORLD, TP)
    for r in range(WORLD):
        got = reports[r]["sync"][f"tp{TP}:{case}"]
        if got["digest"] != distcheck.digest(y[rows[r]]):
            diff = np.abs(arrays[r][f"tp{TP}:{case}"][0]
                          - y[rows[r]].float().numpy()).max()
            pytest.fail(f"{case}: rank {r} differs from row {rows[r]} "
                        f"(max abs {diff})")
        assert got["loss_frac"] == pytest.approx(frac, abs=1e-7)
        assert got["launches"] == launched
        assert got["dist_bytes"] > 0
    assert frac > 0, "tail 0.05 drops entries of the small arena"


@pytest.mark.parametrize("name", PRIMITIVES)
def test_tp_primitives_are_the_stacked_rows(ranks, stacked, name):
    """``psum`` over the model axis adds the tp group's rows in rank
    order; ``pmax`` over the data axis passes the NaN to its tp group."""
    reports, _, _, _ = ranks
    want = stacked[0][f"tp{TP}:{name}"][0]
    rows = distcheck.tp_stacked_rows(WORLD, TP)
    if name == "pmax_nan":
        assert torch.isnan(want[:, 3]).all()
    for r in range(WORLD):
        assert reports[r]["sync"][f"tp{TP}:{name}"]["digest"] == \
            distcheck.digest(want[rows[r]]), f"rank {r}"


# --------------------------------------------------------------- training
@pytest.mark.parametrize("run", ["gpt2", "smollm", "drops", "resume"])
def test_replicated_leaves_equal_on_every_rank(ranks, run):
    """After every step the leaves replicated over tp (and their moments)
    are bitwise equal on all four ranks, and each rank's whole state is
    its data replica's (rank ``r`` and ``r + T``)."""
    reports, _, _, _ = ranks
    runs = [rep["train"][run] for rep in reports]
    assert all(got["replicated"] == runs[0]["replicated"] for got in runs)
    for t in range(TP):
        assert runs[t]["digests"] == runs[t + TP]["digests"], t
    assert runs[0]["digests"] != runs[1]["digests"]   # the shards differ


@pytest.mark.parametrize("run", ["gpt2", "smollm", "drops"])
def test_rank_steps_match_the_stacked_steps(ranks, stacked, run):
    """Two steps on the ranks against the same launcher flags as one
    process: every rank's loss, grad_norm, loss_frac and skipped, and its
    shards of the parameters and AdamW moments against the stacked
    ones' tp slices, within ``tests/test_torch_tp_step.py``'s
    tolerances."""
    reports, _, leaves, _ = ranks
    want = stacked[1][run]
    dims = _dims(ARCHS.get(run, "gpt2-paper"))
    n = len(dims) // 3
    for r in range(WORLD):
        got = reports[r]["train"][run]
        for a, b in zip(got["records"], want["records"][:2]):
            for k in ("loss", "grad_norm"):
                assert a[k] == pytest.approx(b[k], rel=1e-5), (r, k)
            assert a["loss_frac"] == pytest.approx(b["loss_frac"], abs=1e-7)
            assert a["skipped"] == b["skipped"]
            assert a["dist_axis_bytes"]["model"] > 0
            assert a["dist_axis_bytes"]["data"] > 0
        for step in range(2):
            for i, (x, full, d) in enumerate(zip(
                    leaves[run][r][step], want["leaves"][step], dims)):
                tol = (PARAM_TOL if i < n else 1e-6 if i < 2 * n else 1e-7)
                np.testing.assert_allclose(
                    x.float().numpy(),
                    _slices(full, d, r % TP).float().numpy(), atol=tol,
                    rtol=0, err_msg=f"{run} rank {r} step {step} leaf {i}")
    if run == "drops":     # masks with zeros cross; step 0 is skipped
        assert all(rec["loss_frac"] > 0 for rec in want["records"][:2])


@pytest.mark.parametrize("run", list(ARCHS))
def test_rank_steps_match_the_reference(ranks, ref_result, run):
    """The ranks' two steps against the reference: the first loss its ``tp
    = 2`` step's, every loss and grad_norm, the moments and the
    parameters (put back together from the ranks' shards) its ``tp = 1``
    steps' on the same padded tree."""
    reports, _, leaves, _ = ranks
    arch = ARCHS[run]
    want = ref_result
    dims = _dims(arch)
    n = len(dims) // 3
    assert reports[0]["train"][run]["records"][0]["loss"] == pytest.approx(
        float(want[f"{arch}/tp{TP}/0/metric/loss"]), rel=1e-5)
    for step in range(2):
        pre = f"{arch}/tp1/{step}"
        rec = reports[0]["train"][run]["records"][step]
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(float(want[f"{pre}/metric/{k}"]),
                                           rel=1e-5), (step, k)
        full = _assembled([leaves[run][t][step] for t in range(TP)], dims)
        for i, leaf in enumerate(full):
            tol = (PARAM_TOL if i < n else 1e-6 if i < 2 * n else 1e-7)
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want[f"{pre}/leaf/{i}"], atol=tol,
                                       rtol=0, err_msg=f"{pre} leaf {i}")


def test_rank_holds_its_tp_shard_bytes(ranks):
    """A rank holds its half of every tp-sharded leaf and AdamW moment,
    and the leaves replicated over tp whole (gpt2-smoke pads nothing)."""
    from repro_torch.models.transformer import _map_table, param_table
    reports, _, _, _ = ranks
    cfg = get_smoke("gpt2-paper")
    table = []
    _map_table(table.append, param_table(cfg, tp=TP))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    entries = sum(int(np.prod(leaf.shape)) // (1 if leaf.tp_dim is None
                                                else TP) for leaf in table)
    for r in range(WORLD):
        got = reports[r]["train"]["gpt2"]["state_bytes"]
        assert got == [entries * (itemsize + 2 * 4)] * 2, r


def test_init_shards_put_together_are_the_stacked_init():
    """Each tp rank draws the full leaves and keeps its chunk
    (``elastic.rank_cuts``: tp rank t's along ``tp_dims``); the chunks
    joined are the stacked form's init, bit for bit."""
    cfg = get_smoke("smollm-360m")
    dims = tp_dims(cfg, TP)
    cuts = [elastic.rank_cuts(cfg, ranks=TP, rank=t, tp=TP)
            for t in range(TP)]
    pieces = [tree_leaves(init_params(torch_key(0), cfg, device="cpu",
                                      tp=TP, keep=lambda i, w, c=cuts[t]:
                                      elastic.cut_piece(w, c[i])))
              for t in range(TP)]
    whole = tree_leaves(init_params(torch_key(0), cfg, device="cpu", tp=TP))
    for got, want in zip(_assembled(pieces, dims), whole):
        assert torch.equal(got, want)


def test_checkpoint_is_the_shards_put_together(ranks, stacked, tmp_path):
    """The ranks' checkpoint holds the full leaves, the stacked format:
    their last step's shards joined over each tp group, bit for bit. The
    ranks' resumed third step and the stacked form's resume of the same
    checkpoint match the uninterrupted stacked third step."""
    reports, _, leaves, ckpt = ranks
    dims = _dims("gpt2-paper")
    like = stacked[1]["drops"]["leaves"][1]
    _, restored, _ = ckpt_lib.restore(str(ckpt), like, step=2, device="cpu")
    want = _assembled([leaves["drops"][t][1] for t in range(TP)], dims)
    for got, full in zip(tree_leaves(restored), want):
        assert torch.equal(got, full)
    # the ranks' resumed run saved its own step 3 beside it: resume step 2
    alone = tmp_path / "ckpt"
    shutil.copytree(ckpt / "step_00000002", alone / "step_00000002")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        resumed = _stacked_run(DROPS + ["--steps", "3", "--resume",
                                        "--ckpt-dir", str(alone)])
    finally:
        torch.set_num_threads(threads)
    third = stacked[1]["drops"]["records"][2]
    for rec in (resumed["records"][0],
                reports[0]["train"]["resume"]["records"][0]):
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(third[k], rel=1e-5), k
        assert rec["loss_frac"] == pytest.approx(third["loss_frac"],
                                                 abs=1e-7)


# ---------------------------------------------------------------- refused
LAUNCHER_REFUSED = {
    # FSDP x TP runs (tests/test_torch_dist_tp_fsdp.py), the MoE, SSM and
    # frontend-prefix families too (tests/test_torch_dist_moe.py,
    # test_torch_dist_ssm.py, test_torch_dist_frontend.py), not for the
    # hybrid family
    "fsdp_x_tp": (["--dp-mode", "fsdp", "--arch", "jamba-v0.1-52b"],
                  "the hybrid family"),
    # --seq-parallel runs with the dense block (test_torch_dist_frontend.py)
    # on a sequence that splits over tp, not on 31 tokens over tp 2
    "seq_parallel": (["--seq-parallel", "--seq-len", "31"],
                     "31 positions here, over tp 2"),
    # the MoE family runs over tp ranks, not with sequence parallelism
    "moe": (["--arch", "qwen2-moe-a2.7b", "--seq-parallel"],
            "--seq-parallel with the MoE or SSM block"),
    # the SSM family runs over tp ranks, not with sequence parallelism
    "ssm": (["--arch", "mamba2-1.3b", "--seq-parallel"],
            "--seq-parallel with the MoE or SSM block"),
    "hybrid": (["--arch", "jamba-v0.1-52b"], "the hybrid family"),
    # the frontend-prefix family runs over tp ranks, with --seq-parallel
    # too, not where its 8-position prefix and 33 tokens do not split
    "frontend": (["--arch", "llava-next-mistral-7b", "--seq-parallel",
                  "--prefix", "--seq-len", "33"],
                 "41 positions here, over tp 2")}


@pytest.mark.parametrize("case", list(LAUNCHER_REFUSED))
def test_launcher_refuses_later_tp_slices(monkeypatch, case):
    """Under torchrun ``--tp`` with the hybrid family (with or without
    FSDP), with sequence parallelism on the MoE or SSM block, or on a
    sequence (prefix and tokens) that does not split over tp, raises
    naming its slice of A18c, before the process group is joined."""
    flags, what = LAUNCHER_REFUSED[case]
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    with pytest.raises(ValueError, match=f"{what}.*ROADMAP A18c"):
        launch_train.run(COMMON + flags)


def test_launcher_checks_the_world_is_dp_times_tp(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    with pytest.raises(ValueError, match="the world --dp x --tp"):
        launch_train.run(["--smoke", "--device", "cpu", "--dp", "4",
                          "--tp", "2"])


@pytest.fixture
def one_rank_group(tmp_path):
    """A world of one gloo rank in this process, through a file store."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


# what: the later slice a combination raises for; None where this slice
# lets it through to the world's size (one rank here, a grid of 2)
TRAINER_REFUSED = {
    # FSDP x TP runs, not on a grid of pods
    "fsdp_x_tp": ({"dp_mode": "fsdp"}, "gpt2-paper", "pods x tp"),
    # sequence parallelism runs over tp ranks with the dense block
    "seq_parallel": ({"seq_parallel": True}, "gpt2-paper", None),
    "pods_x_tp": ({}, "gpt2-paper", "pods x tp"),
    "adafactor": ({"optimizer": "adafactor"}, "gpt2-paper",
                  "Adafactor over tp ranks"),
    # the MoE family runs over tp ranks, not with sequence parallelism
    "moe": ({"seq_parallel": True}, "qwen2-moe-a2.7b",
            "--seq-parallel with the MoE or SSM block"),
    "ssm": ({"seq_parallel": True}, "mamba2-1.3b",
            "--seq-parallel with the MoE or SSM block"),
    "hybrid": ({}, "jamba-v0.1-52b", "the hybrid family"),
    # the frontend-prefix family runs over tp ranks
    "frontend": ({}, "musicgen-medium", None)}


@pytest.mark.parametrize("case", list(TRAINER_REFUSED))
def test_trainer_refuses_later_tp_slices(one_rank_group, case):
    """``build_train_step(..., group=)`` at tp 2 raises on each
    combination a later slice of A18c runs, before it checks the world's
    size (one rank here); the combinations this slice runs (sequence
    parallelism, the frontend-prefix family) get past that check to the
    world's size."""
    from repro_torch.launch.mesh import HostMesh, make_host_mesh
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    kw, arch, what = TRAINER_REFUSED[case]
    kw = dict(kw)
    opt = OptimizerConfig(name=kw.pop("optimizer", "adamw"))
    mesh = (HostMesh(("pod", "data", "model"), (2, 1, TP))
            if case in ("pods_x_tp", "fsdp_x_tp")
            else make_host_mesh(dp=1, tp=TP))
    match = (f"{what}.*ROADMAP A18c" if what is not None
             else r"a grid of 1 peers \(1 pods, tp 2\) over a process "
             "group of 1 ranks")
    with pytest.raises(ValueError, match=match):
        build_train_step(get_smoke(arch), TrainConfig(optimizer=opt, **kw),
                         mesh, device="cpu", group=one_rank_group)


def test_grid_refuses_pods_with_tp(one_rank_group):
    with pytest.raises(ValueError, match="pods x tp over ranks.*A18c"):
        collectives.Grid(pods=2, tp=TP, group=one_rank_group)
