"""FSDP x TP over ranks: the launcher's ``--dp 2 --tp 2 --dp-mode fsdp`` on
a ``(data 2, model 2)`` grid of gloo process groups, one rank a process,
each holding only its block of every leaf, against the stacked FSDP x TP
form on one device and the JAX package's trainer, on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py``, torchrun's
environment on 127.0.0.1 and a free port): rank ``r = i * 2 + t`` is data
index i, tp rank t, and holds block ``(i, t)`` of every leaf sharded over
both (data shard i, along the leaf's fsdp dim, of tp chunk t, along its tp
dim) and of its AdamW moments, the leaves sharded over one axis its piece
on that axis, the norms whole. The launcher under torchrun trains
gpt2-smoke and smollm-smoke (GQA with one KV head, heads padded 3 -> 4:
the K / V projections are FSDP-sharded and replicated over tp,
``kv_replicated``) for 2 AdamW steps at drop 0, gpt2-smoke at tail drops
0.05 for 2 steps with a checkpoint, and a third step resumed from it. The
parent runs the same launcher flags as one process (the stacked FSDP x TP
form) meanwhile, and one child runs the reference's FSDP trainer on 4
forced host devices: 2 steps at ``tp = 1`` on ``(data 2, model 1)`` and
one at ``tp = 2`` on ``(data 2, model 2)``, from its padded tp-2 init.

Held bit for bit: after every step the leaves no rank shards (the norms
and their moments) are equal on all four ranks, and a leaf replicated over
tp (the K / V projections under ``kv_replicated``) is equal on the two tp
ranks of a data index; init's blocks put back together are the stacked
init; the ranks' checkpoint is their blocks put back together (the
stacked format, full leaves).

Not bit for bit: whole steps against the stacked form, for the reasons
``tests/test_torch_dist_tp.py`` gives (a rank's "f" adds T partial input
gradients where the stacked form runs one GEMM). So the steps are held,
against the stacked form and against the reference (its ``tp = 2`` loss,
its ``tp = 1`` gradients: its tp gradients are wrong, ROADMAP C), with
``tests/test_torch_tp_step.py``'s tolerances: loss and grad_norm 1e-5
relative, ``loss_frac`` 1e-7 absolute, AdamW's moments 1e-6 and 1e-7
absolute, parameters 1e-1 x lr.
"""
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.keys import key as torch_key
from repro_torch.models import init_params
from repro_torch.models.transformer import _map_table, param_table, tp_dims
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
TP = 2
DP = WORLD // TP
LR = 1e-2
SEQ = 32
GLOBAL_BATCH = 8
COMMON = ["--smoke", "--device", "cpu", "--dp", str(DP), "--tp", str(TP),
          "--dp-mode", "fsdp", "--seq-len", str(SEQ), "--global-batch",
          str(GLOBAL_BATCH), "--log-every", "1", "--lr", str(LR),
          "--drop-pattern", "tail"]
ARCHS = {"gpt2": "gpt2-paper", "smollm": "smollm-360m"}
DROPS = ["--arch", "gpt2-paper", "--drop-rate", "0.05"]
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
    # FSDP at tp = 1 on the padded tree (its gradients), then at tp = T
    # (its loss)
    for tp, steps in ((1, job["steps"]), (job["tp"], 1)):
        tc = TrainConfig(sync=OptiReduceConfig(hadamard_block=job["block"]),
                         optimizer=OptimizerConfig(lr=job["lr"]),
                         seq_chunk=job["seq_len"], dp_mode="fsdp")
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
    """The ranks' launcher runs: name -> argv past COMMON."""
    jobs = {name: ["--arch", arch, "--steps", "2"]
            for name, arch in ARCHS.items()}
    jobs["drops"] = DROPS + ["--steps", "2", "--ckpt-dir", str(ckpt)]
    jobs["resume"] = DROPS + ["--steps", "3", "--resume", "--ckpt-dir",
                              str(ckpt)]
    return jobs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps, in a child started first: it runs while the
    ranks and the stacked side do."""
    out = tmp_path_factory.mktemp("dist_tp_fsdp_ref") / "ref.npz"
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
    out = tmp_path_factory.mktemp("distcheck_tp_fsdp")
    ckpt = out / "ckpt"
    argv = ["--device", "cpu", "--threads", "1"]
    for name, flags in _jobs(ckpt).items():
        argv += ["--tp-train", json.dumps({
            "name": name, "argv": COMMON + flags, "save": True})]
    procs = distcheck.start(out, WORLD, argv)
    try:
        yield procs, out, ckpt
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _stacked_run(flags: list) -> dict:
    """The launcher's flags as one process, on one torch thread as the
    ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return distcheck.tp_train({"name": "stacked", "argv": COMMON + flags,
                                   "save": True})
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stacked(world):
    """The stacked form's runs, computed while the ranks run (the drops
    run for 3 uninterrupted steps)."""
    train = {name: _stacked_run(["--arch", arch, "--steps", "2"])
             for name, arch in ARCHS.items()}
    train["drops"] = _stacked_run(DROPS + ["--steps", "3"])
    return train


@pytest.fixture(scope="module")
def ranks(world, stacked):
    procs, out, ckpt = world
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    leaves = {name: [torch.load(out / f"{name}.rank{r}.pt")
                     for r in range(WORLD)] for name in _jobs(ckpt)}
    return reports, leaves, ckpt


def _dims(arch: str) -> tuple[list, list]:
    """Each leaf's tp dim and fsdp dim in the order the ranks save them:
    the parameters', then AdamW's two moments'."""
    cfg = get_smoke(arch)
    return tp_dims(cfg, TP) * 3, elastic.fsdp_dims(cfg, TP) * 3


def _block(leaf: torch.Tensor, tp_dim, fsdp_dim, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of a full leaf: data shard ``rank // T`` of tp
    chunk ``rank % T`` (the leaf itself along a dim it is not cut on)."""
    if tp_dim is not None:
        leaf = elastic.split_leaf(leaf, tp_dim, TP)[rank % TP]
    if fsdp_dim is not None:
        leaf = elastic.split_leaf(leaf, fsdp_dim, DP)[rank // TP]
    return leaf


def _assembled(rank_leaves: list, tp_d: list, fs_d: list) -> list:
    """The full leaves of one step from the four ranks' blocks: each tp
    chunk's data shards joined along the fsdp dim, then the chunks along
    the tp dim (data index 0's and tp rank 0's copies where a leaf is not
    cut)."""
    return [elastic.join_leaf(
        [elastic.join_leaf([rank_leaves[i * TP + t][j] for i in range(DP)],
                           b) for t in range(TP)], a)
        for j, (a, b) in enumerate(zip(tp_d, fs_d))]


def _tol(i: int, n: int) -> float:
    """A saved leaf's tolerance: parameters, then the two moments."""
    return PARAM_TOL if i < n else 1e-6 if i < 2 * n else 1e-7


# --------------------------------------------------------------- training
@pytest.mark.parametrize("run", ["gpt2", "smollm", "drops", "resume"])
def test_replicated_leaves_equal_on_every_rank(ranks, run):
    """After every step the leaves no rank shards (and their moments) are
    bitwise equal on all four ranks, a leaf replicated over tp on the two
    tp ranks of its data index; every rank's blocks differ."""
    reports, leaves, _ = ranks
    runs = [rep["train"][run] for rep in reports]
    assert all(got["replicated"] == runs[0]["replicated"] for got in runs)
    assert len({str(got["digests"]) for got in runs}) == WORLD
    tp_d, fs_d = _dims(ARCHS.get(run, "gpt2-paper"))
    over_tp = [j for j, a in enumerate(tp_d) if a is None]
    for step in range(len(leaves[run][0])):
        for i in range(DP):
            pair = [leaves[run][i * TP + t][step] for t in range(TP)]
            for j in over_tp:
                assert torch.equal(pair[0][j], pair[1][j]), (step, i, j)
    if run == "smollm":        # kv_replicated: K / V sharded over data only
        assert any(fs_d[j] is not None for j in over_tp)


@pytest.mark.parametrize("run", ["gpt2", "smollm", "drops"])
def test_rank_steps_match_the_stacked_steps(ranks, stacked, run):
    """Two steps on the ranks against the same launcher flags as one
    process: every rank's loss, grad_norm, loss_frac and skipped, and its
    blocks of the parameters and AdamW moments against the stacked
    ones'."""
    reports, leaves, _ = ranks
    want = stacked[run]
    tp_d, fs_d = _dims(ARCHS.get(run, "gpt2-paper"))
    n = len(tp_d) // 3
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
            for i, (x, full) in enumerate(zip(leaves[run][r][step],
                                              want["leaves"][step])):
                np.testing.assert_allclose(
                    x.float().numpy(),
                    _block(full, tp_d[i], fs_d[i], r).float().numpy(),
                    atol=_tol(i, n), rtol=0,
                    err_msg=f"{run} rank {r} step {step} leaf {i}")
    if run == "drops":     # the norms' bucket and the sites lose entries
        assert any(rec["loss_frac"] > 0 for rec in want["records"][:2])


@pytest.mark.parametrize("run", list(ARCHS))
def test_rank_steps_match_the_reference(ranks, ref_result, run):
    """The ranks' two steps against the reference's FSDP: the first loss
    its ``tp = 2`` step's, every loss and grad_norm, the moments and the
    parameters (put back together from the ranks' blocks) its ``tp = 1``
    steps' on the same padded tree."""
    reports, leaves, _ = ranks
    arch = ARCHS[run]
    want = ref_result
    tp_d, fs_d = _dims(arch)
    n = len(tp_d) // 3
    assert reports[0]["train"][run]["records"][0]["loss"] == pytest.approx(
        float(want[f"{arch}/tp{TP}/0/metric/loss"]), rel=1e-5)
    for step in range(2):
        pre = f"{arch}/tp1/{step}"
        rec = reports[0]["train"][run]["records"][step]
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(float(want[f"{pre}/metric/{k}"]),
                                           rel=1e-5), (step, k)
        full = _assembled([leaves[run][r][step] for r in range(WORLD)],
                          tp_d, fs_d)
        for i, leaf in enumerate(full):
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want[f"{pre}/leaf/{i}"],
                                       atol=_tol(i, n), rtol=0,
                                       err_msg=f"{pre} leaf {i}")


@pytest.mark.parametrize("run", list(ARCHS))
def test_rank_holds_its_block_bytes(ranks, run):
    """A rank holds its quarter of every leaf sharded over both axes, its
    half of a leaf sharded over one, the rest whole: parameters (bf16) and
    two fp32 moments, after every step."""
    reports, _, _ = ranks
    cfg = get_smoke(ARCHS[run])
    table = []
    _map_table(table.append, param_table(cfg, tp=TP, fsdp_axes=("data",)))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    entries = sum(int(np.prod(leaf.shape))
                  // (1 if leaf.tp_dim is None else TP)
                  // (1 if leaf.fsdp_dim is None else DP) for leaf in table)
    for r in range(WORLD):
        got = reports[r]["train"][run]["state_bytes"]
        assert got == [entries * (itemsize + 2 * 4)] * 2, r


@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_init_blocks_put_together_are_the_stacked_init(arch):
    """Each rank draws the full leaves and keeps its block
    (``elastic.rank_cuts``, ``cut_piece``); the blocks put back together
    are the stacked form's init, bit for bit, and each block is a
    contiguous copy of its own."""
    cfg = get_smoke(arch)
    tp_d, fs_d = tp_dims(cfg, TP), elastic.fsdp_dims(cfg, TP)
    blocks = []
    for r in range(WORLD):
        cuts = elastic.rank_cuts(cfg, ranks=WORLD, rank=r, tp=TP, fsdp=True)
        blocks.append(tree_leaves(init_params(
            torch_key(0), cfg, device="cpu", tp=TP,
            keep=lambda i, w, c=cuts: elastic.cut_piece(w, c[i]))))
        assert all(x.is_contiguous() for x in blocks[-1])
    whole = tree_leaves(init_params(torch_key(0), cfg, device="cpu", tp=TP))
    for got, want in zip(_assembled(blocks, tp_d, fs_d), whole):
        assert torch.equal(got, want)


def test_checkpoint_is_the_blocks_put_together(ranks, stacked, tmp_path):
    """The ranks' checkpoint holds the full leaves, the stacked format:
    their last step's blocks put back together, bit for bit. The ranks'
    resumed third step and the stacked form's resume of the same
    checkpoint match the uninterrupted stacked third step."""
    reports, leaves, ckpt = ranks
    tp_d, fs_d = _dims("gpt2-paper")
    like = stacked["drops"]["leaves"][1]
    _, restored, _ = ckpt_lib.restore(str(ckpt), like, step=2, device="cpu")
    want = _assembled([leaves["drops"][r][1] for r in range(WORLD)],
                      tp_d, fs_d)
    for got, full in zip(tree_leaves(restored), want):
        assert torch.equal(got, full)
    # the ranks' resumed run saved its own step 3 beside it: resume step 2
    alone = tmp_path / "ckpt"
    shutil.copytree(ckpt / "step_00000002", alone / "step_00000002")
    resumed = _stacked_run(DROPS + ["--steps", "3", "--resume",
                                    "--ckpt-dir", str(alone)])
    third = stacked["drops"]["records"][2]
    for rec in (resumed["records"][0],
                reports[0]["train"]["resume"]["records"][0]):
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(third[k], rel=1e-5), k
        assert rec["loss_frac"] == pytest.approx(third["loss_frac"],
                                                 abs=1e-7)


@pytest.mark.parametrize("tp,fsdp", [(1, True), (TP, False), (TP, True)],
                         ids=["fsdp", "tp", "fsdp_x_tp"])
def test_rank_cuts_partition_every_leaf(tp, fsdp):
    """``elastic.rank_cuts`` for every rank of 4: FSDP at tp 1 is the
    rank's fsdp shard of 4, tp its tp chunk of T, FSDP x TP the data shard
    of its tp chunk; the ranks' pieces of a leaf together hold each entry
    once (or every rank the whole leaf)."""
    cfg = get_smoke("smollm-360m")
    full = tree_leaves(init_params(torch_key(1), cfg, device="cpu", tp=tp))
    cuts = [elastic.rank_cuts(cfg, ranks=WORLD, rank=r, tp=tp, fsdp=fsdp)
            for r in range(WORLD)]
    for j, leaf in enumerate(full):
        pieces = [elastic.cut_piece(leaf, cuts[r][j]) for r in range(WORLD)]
        held = sum(p.numel() for p in pieces)
        replicas = WORLD // math.prod(n for _, n, _, _ in cuts[0][j])
        assert held == leaf.numel() * replicas, j
        if not cuts[0][j]:
            assert all(p is leaf for p in pieces)
        if tp == 1 and cuts[0][j]:
            for r, p in enumerate(pieces):
                assert torch.equal(p, elastic.split_leaf(
                    leaf, cuts[0][j][0][0], WORLD)[r])

