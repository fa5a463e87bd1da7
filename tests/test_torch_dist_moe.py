"""The MoE family over ranks: the launcher under torchrun trains
qwen2-moe-smoke and arctic-smoke (a dense residual beside its experts) on
gloo process groups, one rank a peer, at tp 1 and on the ``(data, model)``
grid, each tp rank holding and computing only its own ``E_pad / T``
experts, against the stacked form on one device and the JAX package's
trainer, on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py``, torchrun's
environment on 127.0.0.1 and a free port). The one world runs five
launcher jobs in turn, three grid layouts (every rank the same jobs, so
each layout's groups are made once, alike):

- ``tp1_fsdp``: qwen2-moe-smoke ``--dp 4 --dp-mode fsdp`` at tail drops
  0.05, tp 1;
- ``moe`` and ``moe_fsdp``: qwen2-moe-smoke ``--dp 2 --tp 2``, replicated
  and FSDP x TP (6 experts, 3 a rank);
- ``arctic_fsdp``: arctic-smoke ``--dp 2 --tp 2 --dp-mode fsdp`` (8
  experts, 4 a rank, and the dense MLP's columns);
- ``tp4``: qwen2-moe-smoke ``--dp 1 --tp 4``: 6 experts padded to 8, 2 a
  rank, tp rank 3's two padded experts that no token is routed to.

Each job runs 2 AdamW steps at lr 1e-2. The parent runs the same launcher
flags as one process (the stacked form) meanwhile, and one child runs the
reference's trainer on 4 forced host devices at ``(data 2)``: 2 steps at
``tp = 1`` (qwen2-moe-smoke replicated and FSDP, arctic-smoke FSDP) and
one at ``tp = 2`` (each arch), from its padded tp-2 init.

Held bit for bit: the tp 1 run against the stacked step (every rank's
records, and its FSDP shard of every leaf and moment); the leaves no rank
shards on all four ranks, and a leaf replicated over tp (the router, the
norms) on the tp ranks of a data index.

Not bit for bit, for the reasons ``tests/test_torch_dist_tp.py`` gives (a
rank's "f" adds T partial gradients where the stacked form runs one
product): the tp runs against the stacked form and against the reference
(its ``tp = 2`` loss, its ``tp = 1`` steps: its tp gradients are wrong,
ROADMAP C), with ``tests/test_torch_tp_step.py``'s tolerances: loss and
grad_norm 1e-5 relative, ``loss_frac`` 1e-7 absolute, AdamW's moments 1e-6
and 1e-7 absolute, parameters 1e-1 x lr. The router and its first moment
are held on every rank explicitly: a rank's router gradient reaches only
its own experts' slots, and without the sum over the tp group (``copy_tp``)
every rank would train the router on tp rank 0's experts alone. A rank's
expert leaves have ``E_pad / T`` experts on their expert dim, its state
bytes its block's count, and a padded expert's moments stay zero.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.transformer import (_map_table, check_tp_ranks,
                                            param_table, tp_dims)
from repro_torch.train import elastic

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
LR = 1e-2
SEQ = 32
GLOBAL_BATCH = 8
COMMON = ["--smoke", "--device", "cpu", "--seq-len", str(SEQ),
          "--global-batch", str(GLOBAL_BATCH), "--log-every", "1", "--lr",
          str(LR), "--drop-pattern", "tail", "--steps", "2"]
QWEN, ARCTIC = "qwen2-moe-a2.7b", "arctic-480b"
# name -> (arch, tp, dp_mode, flags past COMMON)
RUNS = {"tp1_fsdp": (QWEN, 1, "fsdp", ["--drop-rate", "0.05"]),
        "moe": (QWEN, 2, "replicated", []),
        "moe_fsdp": (QWEN, 2, "fsdp", []),
        "arctic_fsdp": (ARCTIC, 2, "fsdp", []),
        "tp4": (QWEN, 4, "replicated", [])}
TP_RUNS = [name for name, (_, tp, _, _) in RUNS.items() if tp > 1]
# the runs held against the reference's (data 2) steps: name -> its mode
REF_RUNS = {"moe": "replicated", "moe_fsdp": "fsdp", "arctic_fsdp": "fsdp"}
PARAM_TOL = 1e-1 * LR
REF_JOB = {"cases": [(RUNS[n][0], m) for n, m in REF_RUNS.items()],
           "tp": 2, "dp": 2, "steps": 2, "seq_len": SEQ,
           "global_batch": GLOBAL_BATCH, "seed": 0, "lr": LR, "block": 1024}

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
# each case's steps at tp = 1 on the padded tp-T tree (its gradients),
# then one replicated step at tp = T a arch (its loss)
runs = [(arch, mode, 1, job["steps"]) for arch, mode in job["cases"]]
runs += [(arch, "replicated", job["tp"], 1)
         for arch in dict.fromkeys(a for a, _ in job["cases"])]
for arch, mode, tp, steps in runs:
    cfg = get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=job["seq_len"],
                                  global_batch=job["global_batch"],
                                  seed=job["seed"]))
    key = jax.random.PRNGKey(job["seed"])
    params0 = init_params(key, cfg, tp=job["tp"])
    tc = TrainConfig(sync=OptiReduceConfig(hadamard_block=job["block"]),
                     optimizer=OptimizerConfig(lr=job["lr"]),
                     seq_chunk=job["seq_len"], dp_mode=mode)
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
        pre = f"{arch}/{mode}/tp{tp}/{step}"
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


def _argv(name: str) -> list:
    arch, tp, mode, flags = RUNS[name]
    return COMMON + ["--arch", arch, "--dp", str(WORLD // tp), "--tp",
                     str(tp), "--dp-mode", mode] + flags


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps, in a child started first: it runs while the
    ranks and the stacked side do."""
    out = tmp_path_factory.mktemp("dist_moe_ref") / "ref.npz"
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
    out = tmp_path_factory.mktemp("distcheck_moe")
    argv = ["--device", "cpu", "--threads", "1"]
    for name in RUNS:
        argv += ["--tp-train", json.dumps({"name": name, "argv": _argv(name),
                                           "save": True})]
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
    """The stacked form's runs of the same flags, computed while the ranks
    run, on one torch thread as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: distcheck.tp_train({"name": "stacked",
                                          "argv": _argv(name), "save": True})
                for name in RUNS}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(world, stacked):
    procs, out = world
    distcheck.wait(procs, timeout=300)
    reports = distcheck.reports(out, WORLD)
    leaves = {name: [torch.load(out / f"{name}.rank{r}.pt")
                     for r in range(WORLD)] for name in RUNS}
    return reports, leaves


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
    arch, tp, mode, _ = RUNS[name]
    cfg = get_smoke(arch)
    tp_d = tp_dims(cfg, tp) if tp > 1 else [None] * len(_paths(cfg, tp))
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
    arch, tp, _, _ = RUNS[name]
    return [j for j, p in enumerate(_paths(get_smoke(arch), tp))
            if p[-1] == key]


# ------------------------------------------------------------------- tp 1
def test_tp1_ranks_are_bitwise_the_stacked_step(ranks, stacked):
    """qwen2-moe-smoke under FSDP over 4 data ranks at tail drops 0.05:
    every rank's records, and its shard of every leaf and moment after
    every step, bit for bit the stacked FSDP step's."""
    reports, leaves = ranks
    want = stacked["tp1_fsdp"]
    keys = ("loss", "grad_norm", "loss_frac", "skipped")
    assert any(rec["loss_frac"] > 0 for rec in want["records"])
    for r in range(WORLD):
        got = reports[r]["train"]["tp1_fsdp"]
        assert [{k: rec[k] for k in keys} for rec in got["records"]] == [
            {k: rec[k] for k in keys} for rec in want["records"]], r
        for step in range(2):
            for j, (x, full) in enumerate(zip(leaves["tp1_fsdp"][r][step],
                                              want["leaves"][step])):
                assert torch.equal(x, _block(full, "tp1_fsdp", j, r)), \
                    (r, step, j)


# ---------------------------------------------------------------- over tp
@pytest.mark.parametrize("run", TP_RUNS)
def test_replicated_leaves_equal_on_every_rank(ranks, run):
    """After every step the leaves no rank shards (and their moments) are
    bitwise equal on all four ranks, a leaf replicated over tp (the
    router, the norms) on the tp ranks of its data index."""
    reports, leaves = ranks
    runs = [rep["train"][run]["replicated"] for rep in reports]
    assert all(got == runs[0] for got in runs)
    tp = RUNS[run][1]
    tp_d, _ = _dims(run)
    over_tp = [j for j, a in enumerate(tp_d) if a is None]
    assert set(_named(run, "router")) <= set(over_tp)
    for step in range(2):
        for i in range(WORLD // tp):
            group = [leaves[run][i * tp + t][step] for t in range(tp)]
            for j in over_tp:
                for t in range(1, tp):
                    assert torch.equal(group[0][j], group[t][j]), \
                        (step, i, t, j)


@pytest.mark.parametrize("run", TP_RUNS)
def test_rank_steps_match_the_stacked_steps(ranks, stacked, run):
    """Two steps on the ranks against the same launcher flags as one
    process: every rank's loss, grad_norm, loss_frac and skipped, and its
    blocks of the parameters and AdamW moments against the stacked
    ones'."""
    reports, leaves = ranks
    want = stacked[run]
    n = len(_dims(run)[0]) // 3
    for r in range(WORLD):
        got = reports[r]["train"][run]
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


@pytest.mark.parametrize("run", TP_RUNS)
def test_router_and_its_moment_match_the_stacked_form(ranks, stacked, run):
    """Every rank's router and its AdamW first moment against the stacked
    form's, after every step: a rank's router gradient reaches only its
    own experts' slots, and the moment must be that of the gradient summed
    over the tp group (a moment ten times its tolerance and more)."""
    _, leaves = ranks
    want = stacked[run]
    n = len(_dims(run)[0]) // 3
    for step in range(2):
        for j in _named(run, "router"):
            m_want = want["leaves"][step][n + j]
            assert float(m_want.abs().max()) > 1e-5
            for r in range(WORLD):
                for k, tol in ((j, PARAM_TOL), (n + j, 1e-6)):
                    np.testing.assert_allclose(
                        leaves[run][r][step][k].float().numpy(),
                        _block(want["leaves"][step][k], run, k,
                               r).float().numpy(),
                        atol=tol, rtol=0,
                        err_msg=f"{run} rank {r} step {step} leaf {k}")


@pytest.mark.parametrize("run", TP_RUNS)
def test_rank_holds_and_computes_only_its_experts(ranks, run):
    """A rank's expert leaves (and their moments) hold its ``E_pad / T``
    experts on the expert dim, and the bytes a rank holds are its
    blocks': parameters and two fp32 moments, after every step."""
    reports, leaves = ranks
    arch, tp, mode, _ = RUNS[run]
    cfg = get_smoke(arch)
    table = []
    _map_table(table.append, param_table(cfg, tp=tp, fsdp_axes=(
        ("data",) if mode == "fsdp" else None)))
    n = len(table)
    e_pad = -(-cfg.n_experts // tp) * tp
    for key in ("we_gate", "we_up", "we_down"):
        for j in _named(run, key):
            for r in range(WORLD):
                for k in (j, n + j, 2 * n + j):
                    assert leaves[run][r][1][k].shape[1] == e_pad // tp
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    dp = WORLD // tp
    entries = sum(int(np.prod(leaf.shape))
                  // (1 if leaf.tp_dim is None else tp)
                  // (1 if leaf.fsdp_dim is None or mode != "fsdp" else dp)
                  for leaf in table)
    for r in range(WORLD):
        got = reports[r]["train"][run]["state_bytes"]
        assert got == [entries * (itemsize + 2 * 4)] * 2, r


def test_padded_experts_state_stays_at_the_syncs_rounding(ranks, stacked):
    """qwen2-moe-smoke at tp 4: 6 experts padded to 8, tp rank 3 holding
    the two padded ones. No token is routed to them, so their gradient is
    zero before the sync, and the sync's Hadamard rotation gives a zero
    back exactly in every 1024-entry block that holds only such entries:
    their AdamW moments stay zero there and carry only the rotation's
    rounding where a block shares entries with another leaf (|m| within
    1e-10, |v| within 1e-20, at most 5% of the entries; the stacked form's
    the same), while every other rank's experts move (|m| above 1e-6)."""
    _, leaves = ranks
    n = len(_dims("tp4")[0]) // 3
    experts = [j for key in ("we_gate", "we_up", "we_down")
               for j in _named("tp4", key)]
    for step in range(2):
        for j in experts:
            for k, bound in ((n + j, 1e-10), (2 * n + j, 1e-20)):
                for padded in (leaves["tp4"][3][step][k],
                               stacked["tp4"]["leaves"][step][k][:, 6:]):
                    assert float(padded.abs().max()) <= bound, (step, k)
                    assert float((padded != 0).float().mean()) <= 0.05
            for r in range(3):
                assert float(leaves["tp4"][r][step][n + j].abs().max()) \
                    > 1e-6, (r, j)


@pytest.mark.parametrize("arch,tp,fsdp", [(QWEN, 2, True), (ARCTIC, 2, True),
                                          (QWEN, 4, False), (QWEN, 1, True)],
                         ids=["qwen_fsdp_x_tp", "arctic_fsdp_x_tp",
                              "qwen_tp4", "qwen_fsdp"])
def test_rank_cuts_partition_the_expert_leaves(arch, tp, fsdp):
    """``elastic.rank_cuts`` for every rank of 4 on an MoE tree: an expert
    leaf (tp dim 1, the expert dim; fsdp dim 2 or 3, D) is cut on the
    expert dim first, then on D; the ranks' pieces together hold each
    entry once, and the router (replicated over tp) its data shard's
    entries once a tp group."""
    from repro_torch.core.keys import key as torch_key
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves
    cfg = get_smoke(arch)
    full = tree_leaves(init_params(torch_key(1), cfg, device="cpu", tp=tp))
    cuts = [elastic.rank_cuts(cfg, ranks=WORLD, rank=r, tp=tp, fsdp=fsdp)
            for r in range(WORLD)]
    paths = _paths(cfg, tp)
    seen = set()
    for j, (leaf, path) in enumerate(zip(full, paths)):
        pieces = [elastic.cut_piece(leaf, cuts[r][j]) for r in range(WORLD)]
        held = sum(p.numel() for p in pieces)
        replicas = WORLD // int(np.prod([n for _, n, _, _ in cuts[0][j]]))
        assert held == leaf.numel() * replicas, path
        if path[-1] in ("we_gate", "we_up", "we_down"):
            dims = [d for d, _, _, _ in cuts[0][j]]
            want = [1] if tp > 1 else []
            want += [3 if path[-1] == "we_down" else 2] if fsdp else []
            assert dims == want, (path, dims)
            for r, p in enumerate(pieces):
                assert p.shape[1] == leaf.shape[1] // tp
                assert torch.equal(p, _cut(leaf, cuts[r][j]))
            seen.add(path[-1])
        if path[-1] == "router":
            assert replicas == (tp if fsdp else WORLD)
            seen.add("router")
    assert seen == {"we_gate", "we_up", "we_down", "router"}


def _cut(leaf: torch.Tensor, cuts) -> torch.Tensor:
    """A leaf's piece by slicing, cut after cut: piece k of n along dim."""
    for dim, n, k, _ in cuts:
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, k * size, size)
    return leaf


# -------------------------------------------------------------- reference
@pytest.mark.parametrize("run", list(REF_RUNS))
def test_rank_steps_match_the_reference(ranks, ref_result, run):
    """The ranks' two steps against the reference at ``(data 2)``: the
    first loss its ``tp = 2`` step's, every loss and grad_norm, the
    moments and the parameters (put back together from the ranks'
    blocks) its ``tp = 1`` steps' on the same padded tree."""
    reports, leaves = ranks
    arch = RUNS[run][0]
    mode = REF_RUNS[run]
    n = len(_dims(run)[0]) // 3
    want = ref_result
    assert reports[0]["train"][run]["records"][0]["loss"] == pytest.approx(
        float(want[f"{arch}/replicated/tp2/0/metric/loss"]), rel=1e-5)
    for step in range(2):
        pre = f"{arch}/{mode}/tp1/{step}"
        rec = reports[0]["train"][run]["records"][step]
        for k in ("loss", "grad_norm"):
            assert rec[k] == pytest.approx(float(want[f"{pre}/metric/{k}"]),
                                           rel=1e-5), (step, k)
        full = _assembled(run, [leaves[run][r][step] for r in range(WORLD)])
        for i, leaf in enumerate(full):
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want[f"{pre}/leaf/{i}"],
                                       atol=_tol(i, n), rtol=0,
                                       err_msg=f"{pre} leaf {i}")


# ---------------------------------------------------------------- refusal
@pytest.mark.parametrize("arch,seq_parallel,what", [
    ("jamba-v0.1-52b", False, "the hybrid family"),
    # the SSM family runs over tp ranks (tests/test_torch_dist_ssm.py),
    # not with sequence parallelism
    ("mamba2-1.3b", True, "--seq-parallel with the MoE or SSM block"),
    # the frontend-prefix family runs over tp ranks with sequence
    # parallelism (tests/test_torch_dist_frontend.py), not where its 8
    # prefix positions and 33 tokens do not split over tp 2
    ("llava-next-mistral-7b", True, "41 positions here, over tp 2"),
    ("qwen2-moe-a2.7b", True, "--seq-parallel with the MoE or SSM block")])
def test_check_tp_ranks_refuses_later_slices(arch, seq_parallel, what):
    """The hybrid family, sequence parallelism with the MoE or SSM block
    and a sequence (prefix and tokens) that does not split over tp still
    raise over tp ranks, naming their slice and what runs now."""
    cfg = get_smoke(arch)
    with pytest.raises(ValueError, match=f"{what}.*ROADMAP A18c.*one rank "
                       "a tp rank runs the dense, MoE, SSM and "
                       "frontend-prefix families"):
        check_tp_ranks(cfg, seq_parallel=seq_parallel, tp=2,
                       positions=cfg.prefix_len + 33)


@pytest.mark.parametrize("arch", [QWEN, ARCTIC])
def test_check_tp_ranks_lets_the_moe_family_through(arch):
    check_tp_ranks(get_smoke(arch))


# ------------------------------------------------------------------ digest
def test_sampled_digest_sees_every_entry():
    """``distcheck.sample`` at a stride (the card's digests of a rank's
    state): the strided entries and a checksum of every entry, so a change
    to one entry between two samples changes the digest."""
    x = torch.randn(10_007, generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        a = x.to(dtype)
        want = distcheck.digest(distcheck.sample(a, 997))
        assert distcheck.digest(distcheck.sample(a.clone(), 997)) == want
        for i in (0, 1, 996, 998, 10_006):
            b = a.clone()
            b[i] = -b[i] if b[i] != 0 else 1
            assert distcheck.digest(distcheck.sample(b, 997)) != want, i
    assert torch.equal(distcheck.sample(x, 1), x)
    # a leaf of fewer entries than the stride, and a scalar
    for small in (x[:5].to(torch.bfloat16), torch.tensor(3.0)):
        want = distcheck.digest(distcheck.sample(small, 997))
        other = small.clone()
        other.view(-1)[-1] += 1
        assert distcheck.digest(distcheck.sample(other, 997)) != want
