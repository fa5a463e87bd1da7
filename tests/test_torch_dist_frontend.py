"""The frontend-prefix families and sequence parallelism over ranks: the
launcher under torchrun trains llava-smoke and musicgen-smoke on gloo
process groups, one tp rank a process, on the ``(data, model)`` grid with
their frontend's prefix, with ``--seq-parallel`` as a gather and a
reduce-scatter in the tp group, against the stacked form on one device and
the JAX package's trainer, on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py``, torchrun's
environment on 127.0.0.1 and a free port). The one world first runs the
SP collectives' unit (``--sp-unit 2``: each tp group of 2 ranks), then
five launcher jobs in turn (every rank the same jobs), each of 2 AdamW
steps at lr 3e-4 (``LR``) with ``--prefix`` (8 positions before the 32
tokens):

- ``frontend_sp``: llava-smoke at ``--dp 2 --tp 2 --seq-parallel``
  (prefix and tokens, 40 positions, 20 a rank);
- ``frontend_sp_fsdp``: the same with ``--dp-mode fsdp``, saving a
  checkpoint after its last step, and ``sp_resume``: its third step,
  resumed from that checkpoint;
- ``frames``: musicgen-smoke at ``--dp 2 --tp 2`` without SP;
- ``sp_tp4``: llava-smoke at ``--dp 1 --tp 4 --seq-parallel`` (one q head
  a rank, the 2 KV heads replicated over the 4 ranks: ``kv_replicated``).

The parent runs the same launcher flags as one process (the stacked form)
meanwhile (``frontend_sp_fsdp`` for 3 uninterrupted steps), and one child
runs the reference's trainer on 4 forced host devices at ``(data 2)``:
llava-smoke's 2 steps at ``tp = 1`` replicated and FSDP, musicgen-smoke's
at ``tp = 1``, and the ``tp = 2`` SP loss of llava-smoke, from the tp-2
init, with the launcher's batches and prefix embeddings.

Held bit for bit: the leaves replicated over tp (``frontend_proj``, the
norms) on the tp ranks of a data index; the ranks' checkpoint against their
blocks put back together, and ``elastic.cut_tree`` of it (as ``--resume``
cuts it) against each rank's blocks; ``elastic.rank_cuts`` of
``frontend_proj`` (FSDP dim 0, replicated over tp).

Not bit for bit, for the reasons ``tests/test_torch_dist_tp.py`` gives (a
rank's "f" adds T partial gradients where the stacked form runs one
product; under SP the gather's reduce-scatter is that "f"): the runs
against the stacked form and against the reference (its ``tp = 2`` loss,
its ``tp = 1`` steps: its tp gradients are wrong, ROADMAP C), with
``tests/test_torch_tp_step.py``'s tolerances: loss and grad_norm 1e-5
relative, ``loss_frac`` 1e-7 absolute, AdamW's moments 1e-6 and 1e-7
absolute, parameters 1e-1 x lr. ``frontend_proj``, ``ln1``, ``ln2`` and
``final_ln`` and their first moments are held on every rank explicitly:
under SP a rank's norms see its sequence slice alone, and without their
sum over the tp group (``copy_seq``) every rank would train them on tp
rank 0's slice; ``frontend_proj``'s gradient is whole on every rank with
no sum of its own (the slice's backward gathers the whole gradient; a sum
over tp would double it). The SP unit holds ``gather_seq``,
``scatter_seq`` and ``reduce_output`` over 2 ranks against the stacked
methods, values and gradients within 1e-5 relative, and its broken forms
(the "f" doubled, the norms' sum left out) off by far more.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.keys import key as torch_key
from repro_torch.models import init_params
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import (_map_table, check_tp_ranks,
                                            param_table, tp_dims)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
LR = 3e-4
SEQ = 32
GLOBAL_BATCH = 8
LLAVA = "llava-next-mistral-7b"
MUSICGEN = "musicgen-medium"
COMMON = ["--smoke", "--device", "cpu", "--seq-len", str(SEQ),
          "--global-batch", str(GLOBAL_BATCH), "--log-every", "1", "--lr",
          str(LR), "--drop-pattern", "tail", "--prefix"]
SP = ["--seq-parallel"]
# name -> (arch, tp, dp_mode, flags past COMMON); each runs 2 steps
RUNS = {"frontend_sp": (LLAVA, 2, "replicated", SP),
        "frontend_sp_fsdp": (LLAVA, 2, "fsdp", SP),
        "frames": (MUSICGEN, 2, "replicated", []),
        "sp_tp4": (LLAVA, 4, "replicated", SP)}
CKPT_RUN = "frontend_sp_fsdp"
RESUME = "sp_resume"               # CKPT_RUN's third step, resumed
# the runs held against the reference's (data 2) steps: name -> its key
REF_RUNS = {"frontend_sp": "llava/replicated", "frontend_sp_fsdp":
            "llava/fsdp", "frames": "musicgen/replicated"}
PARAM_TOL = 1e-1 * LR
UNIT_TOL = 1e-5                    # the SP unit's fp32 sums in other orders
HELD = ("frontend_proj", "ln1", "ln2", "final_ln")
REF_JOB = {"runs": [[LLAVA, "llava", "replicated"], [LLAVA, "llava", "fsdp"],
                    [MUSICGEN, "musicgen", "replicated"]],
           "tp": 2, "dp": 2, "steps": 2, "seq_len": SEQ,
           "global_batch": GLOBAL_BATCH, "seed": 0, "lr": LR,
           "block": 1024}

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


def batch_of(cfg, data, step):
    # the launcher's batch and its --prefix embeddings, from (seed, step)
    b = dict(data.host_batch(step, 0, 1))
    rng = np.random.default_rng((job["seed"], step, 1))
    b["prefix_embeds"] = rng.standard_normal(
        (job["global_batch"], cfg.prefix_len, cfg.frontend_dim),
        dtype=np.float32)
    return b


# each run's steps at tp = 1 on the tp-2 tree (its gradients), then one
# replicated step of llava at tp = 2 with seq_parallel (its loss)
runs = [(arch, name, mode, 1, job["steps"], False)
        for arch, name, mode in job["runs"]]
runs.append((job["runs"][0][0], "llava", "replicated", job["tp"], 1, True))
for arch, name, mode, tp, steps, sp in runs:
    cfg = get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=job["seq_len"],
                                  global_batch=job["global_batch"],
                                  seed=job["seed"]))
    key = jax.random.PRNGKey(job["seed"])
    params0 = init_params(key, cfg, tp=job["tp"])
    tc = TrainConfig(sync=OptiReduceConfig(hadamard_block=job["block"]),
                     optimizer=OptimizerConfig(lr=job["lr"]),
                     seq_chunk=job["seq_len"], dp_mode=mode,
                     seq_parallel=sp)
    mesh = make_mesh((job["dp"], tp), ("data", "model"))
    make_step, opt, _ = build_train_step(cfg, tc, mesh)
    step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                            batch_of(cfg, data, 0))
    params = jax.device_put(params0, sh["params"])
    opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
    jf = jax.jit(step_fn)
    for step in range(steps):
        batch = jax.device_put(batch_of(cfg, data, step), sh["batch"])
        params, opt_state, m = jf(params, opt_state, batch,
                                  jnp.asarray(step, jnp.int32), key)
        pre = f"{name}/{mode}/tp{tp}/{step}"
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


def _argv(name: str, ckpt: Path | None = None, steps: int = 2) -> list:
    arch, tp, mode, flags = RUNS[name]
    argv = COMMON + flags + ["--arch", arch, "--dp", str(WORLD // tp),
                             "--tp", str(tp), "--dp-mode", mode, "--steps",
                             str(steps)]
    return argv + (["--ckpt-dir", str(ckpt)] if ckpt is not None else [])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps, in a child started first: it runs while the
    ranks and the stacked side do."""
    out = tmp_path_factory.mktemp("dist_frontend_ref") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(out), repr(REF_JOB)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref_result(ref, ranks):
    proc, out = ref
    assert proc.wait(timeout=600) == 0, out.with_suffix(".log").read_text()
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The 4 ranks, started (after the reference's child) and running."""
    out = tmp_path_factory.mktemp("distcheck_frontend")
    ckpt = out / "ckpt"
    argv = ["--device", "cpu", "--threads", "1", "--sp-unit", "2"]
    for name in RUNS:
        argv += ["--tp-train", json.dumps({
            "name": name, "save": True,
            "argv": _argv(name, ckpt if name == CKPT_RUN else None)})]
    argv += ["--tp-train", json.dumps({
        "name": RESUME, "argv": _argv(CKPT_RUN, ckpt, steps=3)
        + ["--resume"]})]
    procs = distcheck.start(out, WORLD, argv)
    try:
        yield procs, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def stacked(world):
    """The stacked form's runs of the same flags (``CKPT_RUN`` for 3
    uninterrupted steps) and the SP unit, computed while the ranks run, on
    one torch thread as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {name: distcheck.tp_train({
            "name": "stacked", "save": True,
            "argv": _argv(name, steps=3 if name == CKPT_RUN else 2)})
            for name in RUNS}
        unit = distcheck.sp_unit(ParallelCtx(tp_axis="model", sp=True,
                                             sizes={"model": 2}))
        return runs, unit
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world, stacked):
    procs, out = world
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    leaves = {name: [torch.load(out / f"{name}.rank{r}.pt")
                     for r in range(WORLD)] for name in RUNS}
    units = [torch.load(out / f"sp_unit.rank{r}.pt") for r in range(WORLD)]
    return reports, leaves, out / "ckpt", units


def _cfg(name: str):
    return get_smoke(RUNS[name][0])


def _paths(cfg, tp: int) -> list:
    """Each leaf's key path in tree order (dict keys sorted)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append(path)
    walk(param_table(cfg, tp=tp), ())
    return out


def _dims(name: str) -> tuple[list, list]:
    """Each saved leaf's tp dim and fsdp dim, the parameters' and AdamW's
    two moments' (the fsdp dims None when replicated over data)."""
    _, tp, mode, _ = RUNS[name]
    cfg = _cfg(name)
    tp_d = tp_dims(cfg, tp)
    fs_d = (elastic.fsdp_dims(cfg, tp) if mode == "fsdp"
            else [None] * len(tp_d))
    return tp_d * 3, fs_d * 3


def _block(leaf: torch.Tensor, name: str, j: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of saved leaf ``j`` of run ``name``: data
    shard ``rank // T`` of tp chunk ``rank % T``."""
    tp = RUNS[name][1]
    tp_d, fs_d = _dims(name)
    if tp_d[j] is not None:
        leaf = elastic.split_leaf(leaf, tp_d[j], tp)[rank % tp]
    if fs_d[j] is not None:
        leaf = elastic.split_leaf(leaf, fs_d[j], WORLD // tp)[rank // tp]
    return leaf


def _assembled(name: str, rank_leaves: list) -> list:
    """The full leaves of one step from the four ranks' blocks."""
    tp = RUNS[name][1]
    dp = WORLD // tp
    tp_d, fs_d = _dims(name)
    return [elastic.join_leaf(
        [elastic.join_leaf([rank_leaves[i * tp + t][j] for i in range(dp)],
                           b) for t in range(tp)], a)
        for j, (a, b) in enumerate(zip(tp_d, fs_d))]


def _tol(i: int, n: int) -> float:
    """A saved leaf's tolerance: parameters, then the two moments."""
    return PARAM_TOL if i < n else 1e-6 if i < 2 * n else 1e-7


def _named(name: str, key: str) -> list[int]:
    """The indices of the parameter leaves called ``key``."""
    return [j for j, p in enumerate(_paths(_cfg(name), RUNS[name][1]))
            if p[-1] == key]


# ------------------------------------------------------------ SP collectives
def _unit_errors(got: dict, want: dict, t: int) -> dict:
    """Each value's largest error relative to the stacked one's largest
    magnitude, the stacked weights' gradients cut to tp rank ``t``'s
    chunk."""
    cut = {"grad/w_up": 1, "grad/head": 1, "grad/w_down": 0}
    out = {}
    for k, w in want.items():
        if k in cut:
            w = w.chunk(2, cut[k])[t]
        out[k] = float((got[k] - w).abs().max() / w.abs().max())
    return out


def test_sp_collectives_are_the_stacked_methods(ranks, stacked):
    """``scatter_seq``, ``gather_seq`` and ``reduce_output`` over each tp
    group of 2 gloo ranks, around a norm, a column-parallel and a
    row-parallel product and a vocab-parallel head (``distcheck.sp_unit``):
    the loss, the gathered residual and every gradient (the input's, both
    norms', each rank's chunk of the three weights') within ``UNIT_TOL`` of
    the stacked methods' on the same tensors."""
    _, _, _, units = ranks
    want = stacked[1]
    for r in range(WORLD):
        errs = _unit_errors(units[r]["sp"], want, r % 2)
        assert set(errs) >= {"loss", "out", "grad/x", "grad/ln1",
                             "grad/ln2", "grad/w_up", "grad/w_down",
                             "grad/head"}
        assert max(errs.values()) <= UNIT_TOL, (r, errs)


@pytest.mark.parametrize("variant,broken", [
    ("doubled_f", ("grad/x", "grad/ln1", "grad/w_up", "grad/w_down")),
    ("no_norm_sum", ("grad/ln1", "grad/ln2"))])
def test_sp_unit_sees_a_broken_form(ranks, stacked, variant, broken):
    """The same unit with the "f" doubled (``copy_tp`` on the gathered
    activation, whose gather's reduce-scatter sums its gradient already)
    or the norms' tp sum left out (``copy_seq`` as the identity): the
    gradients it breaks are off by more than a tenth of the stacked ones'
    largest magnitude on every rank, 10^4 times the unit's tolerance; the
    values are not."""
    _, _, _, units = ranks
    for r in range(WORLD):
        errs = _unit_errors(units[r][variant], stacked[1], r % 2)
        for k in broken:
            assert errs[k] > 1e-1, (r, k, errs[k])
        assert max(errs["loss"], errs["out"]) <= UNIT_TOL, (r, errs)


# ---------------------------------------------------------------- over tp
@pytest.mark.parametrize("run", list(RUNS))
def test_replicated_leaves_equal_on_every_rank(ranks, run):
    """After every step the leaves no rank shards (and their moments) are
    bitwise equal on all four ranks, a leaf replicated over tp
    (``frontend_proj``, the norms) on the tp ranks of its data index."""
    reports, leaves, _, _ = ranks
    runs = [rep["train"][run]["replicated"] for rep in reports]
    assert all(got == runs[0] for got in runs)
    tp = RUNS[run][1]
    tp_d, _ = _dims(run)
    over_tp = [j for j, a in enumerate(tp_d) if a is None]
    assert set(_named(run, "frontend_proj")) <= set(over_tp)
    for step in range(2):
        for i in range(WORLD // tp):
            group = [leaves[run][i * tp + t][step] for t in range(tp)]
            for j in over_tp:
                for t in range(1, tp):
                    assert torch.equal(group[0][j], group[t][j]), \
                        (step, i, t, j)


@pytest.mark.parametrize("run", list(RUNS))
def test_rank_steps_match_the_stacked_steps(ranks, stacked, run):
    """Two steps on the ranks against the same launcher flags as one
    process: every rank's loss, grad_norm, loss_frac and skipped, and its
    blocks of the parameters and AdamW moments against the stacked
    ones'."""
    reports, leaves, _, _ = ranks
    want = stacked[0][run]
    n = len(_dims(run)[0]) // 3
    for r in range(WORLD):
        got = reports[r]["train"][run]
        assert len(got["records"]) == 2
        for a, b in zip(got["records"], want["records"]):
            for k in ("loss", "grad_norm"):
                assert a[k] == pytest.approx(b[k], rel=1e-5), (r, k)
            assert a["loss_frac"] == pytest.approx(b["loss_frac"], abs=1e-7)
            assert a["skipped"] == b["skipped"]
            assert a["dist_axis_bytes"]["model"] > 0
        for step in range(2):
            for j, (x, full) in enumerate(zip(leaves[run][r][step],
                                              want["leaves"][step])):
                np.testing.assert_allclose(
                    x.float().numpy(),
                    _block(full, run, j, r).float().numpy(),
                    atol=_tol(j, n), rtol=0,
                    err_msg=f"{run} rank {r} step {step} leaf {j}")


@pytest.mark.parametrize("run", list(RUNS))
def test_frontend_proj_and_norms_match_the_stacked_form(ranks, stacked,
                                                        run):
    """Every rank's ``frontend_proj``, ``ln1``, ``ln2`` and ``final_ln``
    and their AdamW first moments against the stacked form's, after every
    step. Each moment is ten times its tolerance and more: under SP a
    rank's norm gradient is its slice's until the tp sum, and a sum over
    tp of ``frontend_proj``'s would double it."""
    _, leaves, _, _ = ranks
    want = stacked[0][run]
    n = len(_dims(run)[0]) // 3
    picked = [j for key in HELD for j in _named(run, key)]
    assert len(picked) == len(HELD)
    for step in range(2):
        for j in picked:
            assert float(want["leaves"][step][n + j].abs().max()) > 1e-5
            for r in range(WORLD):
                for k, tol in ((j, PARAM_TOL), (n + j, 1e-6)):
                    np.testing.assert_allclose(
                        leaves[run][r][step][k].float().numpy(),
                        _block(want["leaves"][step][k], run, k,
                               r).float().numpy(),
                        atol=tol, rtol=0,
                        err_msg=f"{run} rank {r} step {step} leaf {k}")


@pytest.mark.parametrize("run", list(RUNS))
def test_rank_holds_its_blocks_bytes(ranks, run):
    """The bytes a rank holds after every step are its blocks': its tp
    chunk of each tp-sharded leaf (under FSDP x TP its data shard of it,
    and of ``frontend_proj``'s dim 0), the rest whole, bf16 or fp32 and
    two fp32 moments."""
    reports, _, _, _ = ranks
    _, tp, mode, _ = RUNS[run]
    cfg = _cfg(run)
    table = []
    _map_table(table.append, param_table(cfg, tp=tp, fsdp_axes=(
        ("data",) if mode == "fsdp" else None)))
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    dp = WORLD // tp
    entries = sum(int(np.prod(leaf.shape))
                  // (1 if leaf.tp_dim is None else tp)
                  // (1 if leaf.fsdp_dim is None or mode != "fsdp" else dp)
                  for leaf in table)
    for r in range(WORLD):
        got = reports[r]["train"][run]["state_bytes"]
        assert got == [entries * (itemsize + 2 * 4)] * 2, r


def test_checkpoint_and_resume_of_fsdp_x_tp(ranks, stacked):
    """The FSDP x TP ranks' checkpoint after their last step holds the
    full leaves, their blocks put back together
    (``elastic.gather_cut_tree``) bit for bit, ``frontend_proj`` among
    them; cutting it again (``elastic.cut_tree``, as ``--resume`` does)
    gives each rank its blocks back; and the ranks' third step resumed
    from it matches the stacked form's uninterrupted third step."""
    reports, leaves, ckpt, _ = ranks
    like = leaves[CKPT_RUN][0][1]
    _, restored, _ = ckpt_lib.restore(str(ckpt), like, step=2, device="cpu")
    restored = tree_leaves(restored)
    want = _assembled(CKPT_RUN, [leaves[CKPT_RUN][r][1]
                                 for r in range(WORLD)])
    cfg = _cfg(CKPT_RUN)
    proj = _named(CKPT_RUN, "frontend_proj")[0]
    assert restored[proj].shape == (cfg.frontend_dim, cfg.d_model)
    for got, full in zip(restored, want):
        assert torch.equal(got, full)
    for r in range(WORLD):
        cuts = elastic.rank_cuts(cfg, ranks=WORLD, rank=r, tp=2, fsdp=True)
        cuts = cuts * 3                  # the parameters, then two moments
        for got, mine in zip(elastic.cut_tree(restored, cuts, "cpu"),
                             leaves[CKPT_RUN][r][1]):
            assert torch.equal(got, mine)
    third = stacked[0][CKPT_RUN]["records"][2]
    for r in range(WORLD):
        rec, = reports[r]["train"][RESUME]["records"]
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(third[k], rel=1e-5), (r, k)
        assert rec["loss_frac"] == pytest.approx(third["loss_frac"],
                                                 abs=1e-7)


@pytest.mark.parametrize("tp,fsdp", [(2, False), (2, True), (4, True)],
                         ids=["tp2", "fsdp_x_tp2", "fsdp_x_tp4"])
def test_rank_cuts_of_frontend_proj(tp, fsdp):
    """``elastic.rank_cuts`` for every rank of 4 on llava-smoke:
    ``frontend_proj`` is replicated over tp and cut on its FSDP dim 0
    alone (whole without FSDP), the norms never; the ranks' pieces hold
    each entry once a replica, and each rank's blocks of a full init put
    back together are the stacked init, bit for bit."""
    cfg = get_smoke(LLAVA)
    full = tree_leaves(init_params(torch_key(1), cfg, device="cpu", tp=tp))
    cuts = [elastic.rank_cuts(cfg, ranks=WORLD, rank=r, tp=tp, fsdp=fsdp)
            for r in range(WORLD)]
    paths = _paths(cfg, tp)
    seen = set()
    for j, (leaf, path) in enumerate(zip(full, paths)):
        pieces = [elastic.cut_piece(leaf, cuts[r][j]) for r in range(WORLD)]
        replicas = WORLD // math.prod(n for _, n, _, _ in cuts[0][j])
        assert sum(p.numel() for p in pieces) == leaf.numel() * replicas
        dims = [d for d, _, _, _ in cuts[0][j]]
        if path[-1] == "frontend_proj":
            assert dims == ([0] if fsdp else []), dims
            seen.add(path[-1])
        if path[-1] in ("ln1", "ln2", "final_ln"):
            assert dims == [], (path, dims)
            seen.add(path[-1])
    assert seen == set(HELD)
    blocks = [tree_leaves(init_params(
        torch_key(1), cfg, device="cpu", tp=tp,
        keep=lambda i, w, c=cuts[r]: elastic.cut_piece(w, c[i])))
        for r in range(WORLD)]
    tp_d = tp_dims(cfg, tp)
    fs_d = elastic.fsdp_dims(cfg, tp) if fsdp else [None] * len(full)
    n_dp = WORLD // tp
    for j, (a, b) in enumerate(zip(tp_d, fs_d)):
        put = elastic.join_leaf([elastic.join_leaf(
            [blocks[i * tp + t][j] for i in range(n_dp)], b)
            for t in range(tp)], a)
        assert torch.equal(put, full[j]), paths[j]


# -------------------------------------------------------------- reference
@pytest.mark.parametrize("run", list(REF_RUNS))
def test_rank_steps_match_the_reference(ranks, ref_result, run):
    """The ranks' two steps against the reference at ``(data 2)``: every
    loss and grad_norm, the moments and the parameters (put back together
    from the ranks' blocks) its ``tp = 1`` steps' on the same tree and
    batches, prefix included."""
    reports, leaves, _, _ = ranks
    n = len(_dims(run)[0]) // 3
    for step in range(2):
        pre = f"{REF_RUNS[run]}/tp1/{step}"
        rec = reports[0]["train"][run]["records"][step]
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(
                float(ref_result[f"{pre}/metric/{k}"]), rel=1e-5), (step, k)
        full = _assembled(run, [leaves[run][r][step] for r in range(WORLD)])
        for i, leaf in enumerate(full):
            np.testing.assert_allclose(leaf.float().numpy(),
                                       ref_result[f"{pre}/leaf/{i}"],
                                       atol=_tol(i, n), rtol=0,
                                       err_msg=f"{pre} leaf {i}")


@pytest.mark.parametrize("run", ["frontend_sp", "frontend_sp_fsdp"])
def test_sp_first_loss_is_the_references_tp2_loss(ranks, ref_result, run):
    """The ranks' first loss under ``--seq-parallel`` with the prefix is
    the reference's ``tp = 2`` SP step's (40 positions split over 2
    ranks: the reference's slices are the ranks')."""
    reports, _, _, _ = ranks
    want = float(ref_result["llava/replicated/tp2/0/metric/loss"])
    for r in range(WORLD):
        got = reports[r]["train"][run]["records"][0]["loss"]
        assert got == pytest.approx(want, rel=1e-5), r


# ------------------------------------------------------ what still waits
@pytest.mark.parametrize("arch,seq_parallel,positions,tp", [
    (LLAVA, False, None, 2), (LLAVA, True, 40, 2), (MUSICGEN, True, 40, 4),
    ("gpt2-paper", True, 32, 4)],
    ids=["llava", "llava_sp", "musicgen_sp_tp4", "dense_sp"])
def test_check_tp_ranks_lets_the_slice_through(arch, seq_parallel,
                                               positions, tp):
    """The frontend-prefix families with or without SP, and SP on the
    dense block, on a sequence that splits over tp."""
    check_tp_ranks(get_smoke(arch), seq_parallel=seq_parallel,
                   positions=positions, tp=tp)


@pytest.mark.parametrize("arch,positions,tp,what", [
    ("jamba-v0.1-52b", 40, 2, "the hybrid family over tp ranks.*slice 3"),
    ("qwen2-moe-a2.7b", 40, 2, "--seq-parallel with the MoE or SSM block"
     ".*slice 12"),
    ("mamba2-1.3b", 40, 2, "--seq-parallel with the MoE or SSM block"
     ".*slice 12"),
    (LLAVA, 41, 2, "splits the sequence.*41 positions here, over tp 2 "
     r"\(slice 6"),
    (LLAVA, 42, 4, "splits the sequence.*42 positions here, over tp 4")],
    ids=["hybrid", "moe_sp", "ssm_sp", "prefix_odd", "prefix_tp4"])
def test_check_tp_ranks_refuses_what_still_waits(arch, positions, tp, what):
    """Over ranks under ``--seq-parallel`` the hybrid family, the MoE and
    SSM blocks, and a sequence (prefix and tokens) that does not split
    over tp raise, naming their slice of A18c and what runs now."""
    with pytest.raises(ValueError, match=f"{what}.*ROADMAP A18c.*one rank "
                       "a tp rank runs the dense, MoE, SSM and "
                       "frontend-prefix families"):
        check_tp_ranks(get_smoke(arch), seq_parallel=True,
                       positions=positions, tp=tp)


def test_launcher_refuses_a_prefix_that_does_not_split(monkeypatch):
    """Under torchrun ``--seq-parallel --prefix`` on llava-smoke with 8
    prefix positions and 33 tokens (41 over tp 2) raises before the
    process group is joined; the tokens alone would not say so."""
    from repro_torch.launch import train as launch_train
    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    with pytest.raises(ValueError, match="41 positions here, over tp 2"):
        launch_train.run(COMMON + SP + ["--arch", LLAVA, "--dp", "2",
                                        "--tp", "2", "--seq-len", "33"])
