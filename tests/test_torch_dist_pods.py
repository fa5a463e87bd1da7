"""The pod grid over ranks: the hierarchical 2D TAR and FSDP's two hops on
a ``(pod 2, data 2)`` grid of gloo process groups, one rank a peer, against
the stacked form on one device and the JAX package's ``pure_dp`` trainer,
on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py --pods 2``,
torchrun's environment on 127.0.0.1 and a free port): rank ``r = g * 2 +
i`` is pod g, data index i, and each rank makes its pod's data group and
its data index's pod group once. Each rank syncs its row of a seeded (4,
3, 6000) arena through every registered strategy in ``scan`` and
``pipelined`` and the policies that run on 2 data peers, at tail drops
0.05 (on a 2-peer data axis 0.01 times out no receiver of this arena: at
0.05 masks with zeros cross the rank form), runs ``pmax`` over a NaN and
``pmean`` over the pod axis and over both, reduce-scatters a seeded (4,
512, 64) bf16 gradient along dim 1 over both hops (the pod hop reliable,
then the data hop with drops), plain and with the 8-bit wire, then trains
gpt2-smoke through ``build_train_step`` with ``pure_dp`` on a ``(data 2,
model 2)`` mesh for 2 steps three times: ``optireduce_2d`` and
``optireduce_q`` replicated, and ``optireduce_2d`` under FSDP with a
checkpoint of its last step; then once more under FSDP on a ``(pod 2,
data 2)`` mesh, the other way to a pod grid. The parent runs the same on the stacked grid
(FSDP for 3 steps, each sliced as the ranks hold it), and one child runs
the reference's ``pure_dp`` trainer, replicated and FSDP, on the same
config, for 2 steps.

Held bit for bit against the stacked form: each rank's synced row
(reduced shard) is row r of the stacked result, with the same loss
fraction, ``permutes`` and kernel launches; after every step each rank's
parameters and optimizer state are the stacked form's (under FSDP its
pod-major slice r), its records and launches the stacked run's; an FSDP
rank holds its quarter of each sharded leaf and AdamW moment alone; the
stacked form resumes the ranks' checkpoint into the uninterrupted third
step. Against the reference, as ``tests/test_torch_fsdp.py`` holds the
stacked ``pure_dp`` steps and with its tolerances: loss and grad_norm
1e-5 relative, loss_frac 1e-7, skipped equal, AdamW's moments 1e-6 and
1e-7 absolute, parameters 1e-1 x lr (the port draws its own threefry
init, within 2 ulp of the reference's normals, and its own draws, the
reference's bits).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import collectives

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
PODS = 2
ARENA = (3, 6000)
RS_SHAPE = (512, 64)            # gpt2-smoke's embedding
SYNC = dict(rate=0.05, block=256, packet=64)
LR = 1e-2
JOB = {"arch": "gpt2-paper", "smoke": True, "pods": PODS, "peers": WORLD,
       "steps": 2, "seq_len": 32, "global_batch": 8, "drop_rate": 0.05,
       "block": 256, "bucket_elems": 16_384, "lr": LR,
       "skip_threshold": 0.9, "sync_mode": "pipelined", "seed": 0}
RUNS = {"optireduce_2d": dict(strategy="optireduce_2d",
                              dp_mode="replicated"),
        "optireduce_q": dict(strategy="optireduce_q", dp_mode="replicated"),
        "fsdp": dict(strategy="optireduce_2d", dp_mode="fsdp"),
        # the other way to a pod grid: a mesh with a pod axis
        "pod_axis_fsdp": dict(strategy="optireduce_2d", dp_mode="fsdp",
                              mesh="pod")}
# the runs the reference's pure_dp trainer runs too: run -> its dp_mode
REF_RUNS = {"optireduce_2d": "replicated", "fsdp": "fsdp"}
PREFIX = f"pods{PODS}:"
SYNC_CASES = ([name for name, *_ in distcheck.cases(
    policies=distcheck.POD_POLICIES)]
    + [name for name, _ in distcheck.RS_BITS])
PRIMITIVES = ("pmax_nan", "pmean_pod", "pmean_both")
METRICS = ("loss", "loss_frac", "grad_norm", "skipped")

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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

out_path, job, runs = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
save = {}
cfg = get_smoke(job["arch"])
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=job["seq_len"],
                              global_batch=job["global_batch"], seed=0))
key = jax.random.PRNGKey(job["seed"])
params0 = init_params(key, cfg)
mesh = make_mesh((job["peers"] // job["pods"], job["pods"]),
                 ("data", "model"))
for name, mode in runs.items():
    sync = OptiReduceConfig(strategy="optireduce_2d",
                            drop_rate=job["drop_rate"],
                            hadamard_block=job["block"],
                            skip_threshold=job["skip_threshold"])
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=job["lr"]),
                     bucket_elems=job["bucket_elems"],
                     seq_chunk=job["seq_len"], dp_mode=mode, pure_dp=True,
                     sync_mode=job["sync_mode"])
    make_step, opt, _ = build_train_step(cfg, tc, mesh)
    step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                            data.host_batch(0, 0, 1))
    params = jax.device_put(params0, sh["params"])
    opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
    jf = jax.jit(step_fn)
    for step in range(job["steps"]):
        batch = jax.device_put(data.host_batch(step, 0, 1), sh["batch"])
        params, opt_state, m = jf(params, opt_state, batch,
                                  jnp.asarray(step, jnp.int32), key)
        for k, v in m.items():
            save[f"{name}/{step}/metric/{k}"] = np.asarray(v)
        leaves = (jax.tree.leaves(params) + jax.tree.leaves(opt_state.m)
                  + jax.tree.leaves(opt_state.v))
        for i, leaf in enumerate(leaves):
            save[f"{name}/{step}/leaf/{i}"] = np.asarray(
                leaf.astype(jnp.float32))
np.savez(out_path, **save)
print("child OK")
"""


def _job(run: str, **extra) -> dict:
    return {**JOB, "name": run, **RUNS[run], **extra}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's pure_dp steps, in a child started first: it runs
    while the ranks and the stacked side do."""
    out = tmp_path_factory.mktemp("dist_pods_ref") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(out), repr(JOB), repr(REF_RUNS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _ref_result(ref):
    proc, out = ref
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The 4 ranks, started (after the reference's child) and running."""
    out = tmp_path_factory.mktemp("distcheck_pods")
    ckpt = out / "ckpt"
    argv = ["--device", "cpu", "--pods", str(PODS), "--arena",
            ",".join(map(str, ARENA)), "--rs", ",".join(map(str, RS_SHAPE)),
            "--block", str(SYNC["block"]), "--packet", str(SYNC["packet"]),
            "--rate", str(SYNC["rate"]), "--threads", "1"]
    for run in RUNS:
        extra = {"ckpt_dir": str(ckpt)} if run == "fsdp" else {}
        argv += ["--pod-train", json.dumps(_job(run, **extra))]
    procs = distcheck.start(out, WORLD, argv)
    try:
        yield procs, out, ckpt
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def stacked(world):
    """The stacked form's side, computed while the ranks run, on one torch
    thread as they run (a CPU matmul's sums may split by the thread
    count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grid = collectives.Grid(pods=PODS)
        sync = {name: (y, frac, launched) for name, y, frac, launched in
                distcheck.grid_cases(grid, range(WORLD), "cpu", world=WORLD,
                                     arena=ARENA, rs=RS_SHAPE,
                                     pod_rate=SYNC["rate"], **SYNC)}
        train = {run: distcheck.pod_train(
            _job(run, steps=3 if run == "fsdp" else 2), torch.device("cpu"),
            keep=run in REF_RUNS) for run in RUNS}
        return sync, train
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world, stacked):
    procs, out, ckpt = world
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return reports, arrays, ckpt


@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_row_is_the_stacked_row(ranks, stacked, case):
    reports, arrays, _ = ranks
    y, frac, launched = stacked[0][PREFIX + case]
    for r in range(WORLD):
        got = reports[r]["sync"][PREFIX + case]
        if got["digest"] != distcheck.digest(y[r]):
            diff = np.abs(arrays[r][PREFIX + case][0]
                          - y[r].float().numpy()).max()
            pytest.fail(f"{case}: rank {r} differs from row {r} "
                        f"(max abs {diff})")
        assert got["loss_frac"] == frac
        assert got["launches"] == launched
        assert got["dist_bytes"] > 0


def test_drops_cross_the_rank_form(stacked):
    """At 0.05 the 2-peer data axis loses entries: the lossy cases' masks
    hold zeros (0.01 loses none of this arena, see the module doc)."""
    for case in ("optireduce_2d/scan", "optireduce_q/pipelined",
                 "tar_rounds_q/scan", "rs/optireduce"):
        assert stacked[0][PREFIX + case][1] > 0, case


@pytest.mark.parametrize("name", PRIMITIVES)
def test_pod_primitives_are_the_stacked_rows(ranks, stacked, name):
    """``pmax`` over both axes passes the NaN to every rank; ``pmean`` over
    the pod axis and over both adds in index order, bitwise the stacked
    form's."""
    reports, arrays, _ = ranks
    want = stacked[0][PREFIX + name][0]
    if name == "pmax_nan":
        assert torch.isnan(want[:, 3]).all()
    for r in range(WORLD):
        assert reports[r]["sync"][PREFIX + name]["digest"] == \
            distcheck.digest(want[r]), f"rank {r}"
    if name == "pmean_pod":       # the two pods' rows at each data index
        assert torch.equal(want[0], want[2]) and torch.equal(want[1], want[3])


@pytest.mark.parametrize("run", list(RUNS))
def test_rank_steps_are_the_stacked_steps(ranks, stacked, run):
    """After each of the 2 steps every rank's parameters and optimizer
    state are the stacked form's (FSDP: its pod-major slice r), its
    records and each step's launches the stacked run's."""
    reports, _, _ = ranks
    want = stacked[1][run]
    fsdp = RUNS[run]["dp_mode"] == "fsdp"
    for r in range(WORLD):
        got = reports[r]["train"][run]
        digests = [d[r] for d in want["digests"][:2]] if fsdp \
            else want["digests"]
        assert got["digests"] == digests, f"rank {r}"
        assert len(got["records"]) == 2
        for a, b in zip(got["records"], want["records"]):
            assert {k: a[k] for k in METRICS} == {k: b[k] for k in METRICS}
            assert a["dist_bytes"] > 0
        assert got["launches"] == want["launches"][:2], f"rank {r}"
        assert got["init_launches"] == want["init_launches"]


@pytest.mark.parametrize("run", list(REF_RUNS))
def test_steps_match_the_reference(ref, stacked, run):
    """The stacked steps, which rank 0's equal bit for bit, against the
    reference's ``pure_dp`` steps on the ``(data 2, model 2)`` mesh."""
    want = _ref_result(ref)
    got = stacked[1][run]
    n_param = sum(1 for k in want if k.startswith(f"{run}/0/leaf/")) // 3
    for step in range(2):
        pre = f"{run}/{step}"
        rec = got["records"][step]
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(float(want[f"{pre}/metric/{k}"]),
                                           rel=1e-5), (step, k)
        assert rec["loss_frac"] == pytest.approx(
            float(want[f"{pre}/metric/loss_frac"]), abs=1e-7)
        assert rec["skipped"] == float(want[f"{pre}/metric/skipped"])
        for i, leaf in enumerate(got["leaves"][step]):
            tol = (1e-1 * LR if i < n_param else 1e-6 if i < 2 * n_param
                   else 1e-7)
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want[f"{pre}/leaf/{i}"], atol=tol,
                                       rtol=0, err_msg=f"{pre} leaf {i}")


def test_fsdp_rank_holds_its_pod_major_shard_bytes(ranks):
    """An FSDP rank holds exactly its quarter of every leaf sharded over
    ``('model', 'data')`` and of its two AdamW moments, and the replicated
    leaves whole."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import _map_table, param_table
    reports, _, _ = ranks
    cfg = get_smoke("gpt2-paper")
    leaves = []
    _map_table(leaves.append, param_table(cfg, fsdp_axes=("model", "data")))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    entries = sum(int(np.prod(leaf.shape)) // (1 if leaf.fsdp_dim is None
                                                else WORLD)
                  for leaf in leaves)
    for r in range(WORLD):
        got = reports[r]["train"]["fsdp"]["state_bytes"]
        assert got == [entries * (itemsize + 2 * 4)] * 2, r


def test_stacked_form_resumes_the_ranks_checkpoint(ranks, stacked):
    """The ranks' FSDP checkpoint holds the full leaves, the stacked
    form's format: the stacked grid resumes it, and its step is the
    uninterrupted third step."""
    _, _, ckpt = ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = distcheck.pod_train(
            _job("fsdp", steps=3, resume=True, ckpt_dir=str(ckpt)),
            torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    want = stacked[1]["fsdp"]
    assert got["digests"] == want["digests"][2:]
    assert [{k: a[k] for k in METRICS} for a in got["records"]] == \
        [{k: a[k] for k in METRICS} for a in want["records"][2:]]


@pytest.fixture
def one_rank_group(tmp_path):
    """A world of one gloo rank in this process, through a file store."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["pods_over_one_rank", "tp"])
def test_grid_refuses_what_the_world_does_not_hold(one_rank_group, case):
    """A pod grid takes its pods from the group's ranks, a tp grid its tp
    groups: neither 2 pods nor a tp group of 2 fit a world of one rank
    (tp over ranks: ``tests/test_torch_dist_tp.py``)."""
    match = ("do not fill 2 pods" if case == "pods_over_one_rank"
             else "do not fill tp groups of 2")
    kw = {"pods": 2} if case == "pods_over_one_rank" else {"tp": 2}
    with pytest.raises(ValueError, match=match):
        collectives.Grid(group=one_rank_group, **kw)


def test_one_pod_grid_is_the_flat_grid(one_rank_group):
    """With one pod the grid's data group is the group itself and the pod
    axis has no group: its collectives return their input."""
    grid = collectives.rank_grid(one_rank_group)
    assert grid.data_group is one_rank_group and grid.pod_group is None
    x = torch.arange(6.0).reshape(1, 6)
    assert collectives.pmean(x, grid, collectives.POD) is x
    assert grid.index_on(collectives.POD) == 0
    assert grid.index_on(collectives.DATA) == grid.index_on(
        collectives.BOTH) == 0
