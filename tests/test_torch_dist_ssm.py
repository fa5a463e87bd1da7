"""The SSM family over ranks: the launcher under torchrun trains
mamba2-smoke on gloo process groups, one rank a peer, at tp 1 and on the
``(data, model)`` grid, each tp rank holding and computing only its own
``H / T`` SSM heads, against the stacked form on one device and the JAX
package's trainer, on the CPU.

A module fixture starts 4 ranks once (``tools/distcheck.py``, torchrun's
environment on 127.0.0.1 and a free port). The one world runs four
launcher jobs in turn, three grid layouts (every rank the same jobs, so
each layout's groups are made once, alike):

- ``tp1_fsdp``: ``--dp 4 --dp-mode fsdp`` at tail drops 0.05, tp 1;
- ``ssm`` and ``ssm_fsdp``: ``--dp 2 --tp 2``, replicated and FSDP x TP
  (8 heads, 4 a rank), ``ssm_fsdp`` saving a checkpoint after its last
  step;
- ``tp4``: ``--dp 1 --tp 4`` on ``SSM_PAD`` (the job's config override:
  2 heads of 64 padded to 4, one a rank, each narrowed to 32 channels).

Each job runs 2 AdamW steps at lr 3e-4 (``LR``). The parent runs the same launcher
flags as one process (the stacked form) meanwhile, and one child runs the
reference's trainer on 4 forced host devices at ``(data 2)``: 2 steps at
``tp = 1`` (replicated and FSDP) and one at ``tp = 2``, from its tp-2
init.

Held bit for bit: the tp 1 run against the stacked step (every rank's
records, and its FSDP shard of every leaf and moment); the leaves
replicated over tp (``wB``, ``wC``, the norms) on the tp ranks of a data
index; the ranks' checkpoint against their blocks put back together, and
``elastic.cut_tree`` of it against each rank's blocks.

Not bit for bit, for the reasons ``tests/test_torch_dist_tp.py`` gives (a
rank's "f" adds T partial gradients where the stacked form runs one
product): the tp runs against the stacked form and against the reference
(its ``tp = 2`` loss, its ``tp = 1`` steps: its tp gradients are wrong,
ROADMAP C), with ``tests/test_torch_tp_step.py``'s tolerances: loss and
grad_norm 1e-5 relative, ``loss_frac`` 1e-7 absolute, AdamW's moments 1e-6
and 1e-7 absolute, parameters 1e-1 x lr. ``wB``, ``wC`` and their first
moments are held on every rank explicitly: a rank's B and C feed only its
own heads, and without the sum over the tp group (``copy_tp``) every rank
would train them on tp rank 0's heads alone. A rank's SSM leaves have
``H / T`` heads and ``d_inner / T`` channels on their tp dim, its state
bytes are its block's count, and under FSDP x TP each rank keeps its own
chunk of ``conv_w``, ``a_log``, ``dt_bias`` and ``d_skip`` (tp-sharded
leaves with no FSDP dim, synced in the small bucket beside the norms).
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
from repro_torch.models.transformer import (_map_table, check_tp_ranks,
                                            param_table, tp_dims)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import distcheck  # noqa: E402

WORLD = 4
# the launcher's default lr. At lr 1e-2 (tests/test_torch_dist_moe.py's)
# the second step's first moment of the embedding is 3.3x (tp 2) and 7.2x
# (tp 4) the 1e-6 bound off the stacked form's, and the stacked form 0.95x
# off the reference's tp = 1 step: a few embedding entries have gradients
# near AdamW's eps (|g| ~ 2e-9), where the first update lr g / (|g| + eps)
# turns a 1e-10 rounding difference into a parameter gap of a quarter of
# PARAM_TOL, and the next gradient of those entries follows it. That gap
# scales with lr, the moments' bounds do not; at 3e-4 the same readings
# are about 0.1x and 0.2x.
LR = 3e-4
SEQ = 32
GLOBAL_BATCH = 8
ARCH = "mamba2-1.3b"
COMMON = ["--smoke", "--device", "cpu", "--arch", ARCH, "--seq-len",
          str(SEQ), "--global-batch", str(GLOBAL_BATCH), "--log-every", "1",
          "--lr", str(LR), "--drop-pattern", "tail", "--steps", "2"]
# SSM heads that do not divide tp (tests/test_torch_tp_families.py): 2
# heads of 64 padded to 4 at tp 4
SSM_PAD = {"ssm_heads": 2, "ssm_head_dim": 64}
# name -> (tp, dp_mode, config overrides, flags past COMMON)
RUNS = {"tp1_fsdp": (1, "fsdp", None, ["--drop-rate", "0.05"]),
        "ssm": (2, "replicated", None, []),
        "ssm_fsdp": (2, "fsdp", None, []),
        "tp4": (4, "replicated", SSM_PAD, [])}
TP_RUNS = [name for name, (tp, _, _, _) in RUNS.items() if tp > 1]
# the runs held against the reference's (data 2) steps: name -> its mode
REF_RUNS = {"ssm": "replicated", "ssm_fsdp": "fsdp"}
CKPT_RUN = "ssm_fsdp"
PARAM_TOL = 1e-1 * LR
REF_JOB = {"arch": ARCH, "modes": list(REF_RUNS.values()), "tp": 2,
           "dp": 2, "steps": 2, "seq_len": SEQ,
           "global_batch": GLOBAL_BATCH, "seed": 0, "lr": LR, "block": 1024}
# the leaves of a Mamba-2 layer that hold the rank's heads or channels on
# their tp dim (stack dim counted), and what that dim holds
HEAD_LEAVES = {"wx": (2, "d_inner"), "wz": (2, "d_inner"),
               "conv_w": (2, "d_inner"), "out_proj": (1, "d_inner"),
               "wdt": (2, "heads"), "a_log": (1, "heads"),
               "dt_bias": (1, "heads"), "d_skip": (1, "heads")}
# tp-sharded with no FSDP dim: the small bucket's own chunks
SMALL_TP = ("conv_w", "a_log", "dt_bias", "d_skip")

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
cfg = get_smoke(job["arch"])
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=job["seq_len"],
                              global_batch=job["global_batch"],
                              seed=job["seed"]))
key = jax.random.PRNGKey(job["seed"])
params0 = init_params(key, cfg, tp=job["tp"])
# each mode's steps at tp = 1 on the tp-T tree (its gradients), then one
# replicated step at tp = T (its loss)
runs = [(mode, 1, job["steps"]) for mode in job["modes"]]
runs.append(("replicated", job["tp"], 1))
for mode, tp, steps in runs:
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
        pre = f"{mode}/tp{tp}/{step}"
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


def _cfg(name: str):
    """Run ``name``'s config: the smoke config with its overrides."""
    return distcheck.with_overrides(get_smoke(ARCH), RUNS[name][2])


def _argv(name: str, ckpt: Path | None = None) -> list:
    tp, mode, _, flags = RUNS[name]
    argv = COMMON + ["--dp", str(WORLD // tp), "--tp", str(tp),
                     "--dp-mode", mode] + flags
    return argv + (["--ckpt-dir", str(ckpt)] if ckpt is not None else [])


def _job(name: str, ckpt: Path | None = None) -> dict:
    job = {"name": name, "argv": _argv(name, ckpt), "save": True}
    if RUNS[name][2]:
        job["config"] = RUNS[name][2]
    return job


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps, in a child started first: it runs while the
    ranks and the stacked side do."""
    out = tmp_path_factory.mktemp("dist_ssm_ref") / "ref.npz"
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
    out = tmp_path_factory.mktemp("distcheck_ssm")
    argv = ["--device", "cpu", "--threads", "1"]
    for name in RUNS:
        ckpt = out / "ckpt" if name == CKPT_RUN else None
        argv += ["--tp-train", json.dumps(_job(name, ckpt))]
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
        return {name: distcheck.tp_train({**_job(name), "name": "stacked"})
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
    return reports, leaves, out / "ckpt"


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
    tp, mode, _, _ = RUNS[name]
    cfg = _cfg(name)
    tp_d = tp_dims(cfg, tp) if tp > 1 else [None] * len(_paths(cfg, tp))
    fs_d = (elastic.fsdp_dims(cfg, tp) if mode == "fsdp"
            else [None] * len(tp_d))
    return tp_d * 3, fs_d * 3


def _block(leaf: torch.Tensor, name: str, j: int, rank: int,
           tp_rank: int | None = None) -> torch.Tensor:
    """Rank ``rank``'s block of saved leaf ``j`` of run ``name``: data
    shard ``rank // T`` of tp chunk ``rank % T`` (of tp chunk ``tp_rank``
    when given)."""
    tp = RUNS[name][0]
    tp_d, fs_d = _dims(name)
    if tp_d[j] is not None:
        t = rank % tp if tp_rank is None else tp_rank
        leaf = elastic.split_leaf(leaf, tp_d[j], tp)[t]
    if fs_d[j] is not None:
        leaf = elastic.split_leaf(leaf, fs_d[j], WORLD // tp)[rank // tp]
    return leaf


def _assembled(name: str, rank_leaves: list) -> list:
    """The full leaves of one step from the four ranks' blocks."""
    tp = RUNS[name][0]
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
    return [j for j, p in enumerate(_paths(_cfg(name), RUNS[name][0]))
            if p[-1] == key]


# ------------------------------------------------------------------- tp 1
def test_tp1_ranks_are_bitwise_the_stacked_step(ranks, stacked):
    """mamba2-smoke under FSDP over 4 data ranks at tail drops 0.05: every
    rank's records, and its shard of every leaf and moment after every
    step, bit for bit the stacked FSDP step's."""
    reports, leaves, _ = ranks
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
    bitwise equal on all four ranks, a leaf replicated over tp (``wB``,
    ``wC``, the norms) on the tp ranks of its data index."""
    reports, leaves, _ = ranks
    runs = [rep["train"][run]["replicated"] for rep in reports]
    assert all(got == runs[0] for got in runs)
    tp = RUNS[run][0]
    tp_d, _ = _dims(run)
    over_tp = [j for j, a in enumerate(tp_d) if a is None]
    assert set(_named(run, "wB") + _named(run, "wC")) <= set(over_tp)
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
    ones' (``tp4``: the padded heads, one a rank)."""
    reports, leaves, _ = ranks
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
def test_b_and_c_and_their_moments_match_the_stacked_form(ranks, stacked,
                                                          run):
    """Every rank's ``wB`` and ``wC`` and their AdamW first moments against
    the stacked form's, after every step: a rank's B and C feed only its
    own heads, and the moments must be those of the gradient summed over
    the tp group (each moment ten times its tolerance and more)."""
    _, leaves, _ = ranks
    want = stacked[run]
    n = len(_dims(run)[0]) // 3
    picked = _named(run, "wB") + _named(run, "wC")
    assert picked
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


@pytest.mark.parametrize("run", TP_RUNS)
def test_rank_holds_and_computes_only_its_heads(ranks, run):
    """A rank's SSM leaves (and their moments) hold its ``H / T`` heads
    and ``d_inner / T`` channels on their tp dim, and the bytes a rank
    holds are its blocks': parameters and two fp32 moments, after every
    step."""
    reports, leaves, _ = ranks
    tp, mode, _, _ = RUNS[run]
    cfg = _cfg(run)
    heads = -(-cfg.ssm_heads // tp) * tp
    table = []
    _map_table(table.append, param_table(cfg, tp=tp, fsdp_axes=(
        ("data",) if mode == "fsdp" else None)))
    n = len(table)
    for key, (dim, what) in HEAD_LEAVES.items():
        want = (cfg.d_inner if what == "d_inner" else heads) // tp
        assert _named(run, key)
        for j in _named(run, key):
            for r in range(WORLD):
                for k in (j, n + j, 2 * n + j):
                    assert leaves[run][r][1][k].shape[dim] == want, \
                        (key, r, k)
    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    dp = WORLD // tp
    entries = sum(int(np.prod(leaf.shape))
                  // (1 if leaf.tp_dim is None else tp)
                  // (1 if leaf.fsdp_dim is None or mode != "fsdp" else dp)
                  for leaf in table)
    for r in range(WORLD):
        got = reports[r]["train"][run]["state_bytes"]
        assert got == [entries * (itemsize + 2 * 4)] * 2, r


def test_fsdp_x_tp_ranks_keep_their_own_small_chunks(ranks, stacked):
    """Under FSDP x TP ``conv_w``, ``a_log``, ``dt_bias`` and ``d_skip``
    (tp-sharded, no FSDP dim) travel in the small bucket beside the norms:
    each rank keeps its own tp chunk of them and of their moments (within
    the tolerances of the stacked one, and nearer to it than to tp rank
    0's chunk), and the two data ranks of a tp rank hold the same bits."""
    _, leaves, _ = ranks
    run = "ssm_fsdp"
    tp = RUNS[run][0]
    want = stacked[run]
    n = len(_dims(run)[0]) // 3
    picked = [j for key in SMALL_TP for j in _named(run, key)]
    assert len(picked) == len(SMALL_TP)
    for step in range(2):
        for j in picked:
            for k in (j, n + j, 2 * n + j):
                full = want["leaves"][step][k]
                for r in range(WORLD):
                    got = leaves[run][r][step][k]
                    own = _block(full, run, k, r)
                    np.testing.assert_allclose(
                        got.float().numpy(), own.float().numpy(),
                        atol=_tol(k, n), rtol=0,
                        err_msg=f"rank {r} step {step} leaf {k}")
                    if r % tp:
                        tp0 = _block(full, run, k, r, tp_rank=0)
                        assert float((got - own).abs().max()) < float(
                            (got - tp0).abs().max()), (r, step, k)
                    if r >= tp:
                        assert torch.equal(got, leaves[run][r - tp][step][k])


def test_checkpoint_is_the_blocks_put_together(ranks):
    """The FSDP x TP ranks' checkpoint after their last step holds the full
    leaves, their blocks put back together (``elastic.gather_cut_tree``),
    bit for bit, the SSM heads of every tp rank among them; and cutting it
    again (``elastic.cut_tree``, as ``--resume`` does) gives each rank its
    blocks back."""
    _, leaves, ckpt = ranks
    like = leaves[CKPT_RUN][0][1]
    _, restored, _ = ckpt_lib.restore(str(ckpt), like, step=2, device="cpu")
    restored = tree_leaves(restored)
    want = _assembled(CKPT_RUN, [leaves[CKPT_RUN][r][1]
                                 for r in range(WORLD)])
    cfg = _cfg(CKPT_RUN)
    assert restored[_named(CKPT_RUN, "a_log")[0]].shape[-1] == cfg.ssm_heads
    for got, full in zip(restored, want):
        assert torch.equal(got, full)
    for r in range(WORLD):
        cuts = elastic.rank_cuts(cfg, ranks=WORLD, rank=r, tp=2, fsdp=True)
        cuts = cuts * 3                  # the parameters, then two moments
        for got, mine in zip(elastic.cut_tree(restored, cuts, "cpu"),
                             leaves[CKPT_RUN][r][1]):
            assert torch.equal(got, mine)


@pytest.mark.parametrize("tp,fsdp", [(1, True), (2, False), (2, True),
                                     (4, False)],
                         ids=["fsdp", "tp2", "fsdp_x_tp2", "tp4_padded"])
def test_rank_cuts_partition_the_ssm_leaves(tp, fsdp):
    """``elastic.rank_cuts`` for every rank of 4 on mamba2-smoke (padded to
    4 heads at tp 4): the head and channel leaves cut on their tp dim (and
    under FSDP x TP ``wx``, ``wz``, ``wdt``, ``out_proj`` then on their
    fsdp dim, while ``conv_w``, ``a_log``, ``dt_bias``, ``d_skip`` keep the
    whole tp chunk); ``wB`` and ``wC`` only on their fsdp dim. The ranks'
    pieces hold each entry once a replica; each rank's blocks of a full
    init put back together are the stacked init, bit for bit."""
    cfg = distcheck.with_overrides(get_smoke(ARCH),
                                   SSM_PAD if tp == 4 else None)
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
        key = path[-1]
        want = []
        if key in HEAD_LEAVES and tp > 1:
            want.append(HEAD_LEAVES[key][0])
        if fsdp and key in ("wx", "wz", "wdt", "wB", "wC", "out_proj"):
            want.append(2 if key == "out_proj" else 1)
        if key in HEAD_LEAVES or key in ("wB", "wC"):
            assert dims == want, (path, dims)
            seen.add(key)
        for r, p in enumerate(pieces):
            assert torch.equal(p, _cut(leaf, cuts[r][j]))
    assert seen == set(HEAD_LEAVES) | {"wB", "wC"}
    blocks = []
    for r in range(WORLD):
        blocks.append(tree_leaves(init_params(
            torch_key(1), cfg, device="cpu", tp=tp,
            keep=lambda i, w, c=cuts[r]: elastic.cut_piece(w, c[i]))))
    tp_d = tp_dims(cfg, tp) if tp > 1 else [None] * len(full)
    fs_d = elastic.fsdp_dims(cfg, tp) if fsdp else [None] * len(full)
    n_dp = WORLD // tp
    for j, (a, b) in enumerate(zip(tp_d, fs_d)):
        put = elastic.join_leaf([elastic.join_leaf(
            [blocks[i * tp + t][j] for i in range(n_dp)], b)
            for t in range(tp)], a)
        assert torch.equal(put, full[j]), paths[j]


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
    blocks) its ``tp = 1`` steps' on the same tree."""
    reports, leaves, _ = ranks
    mode = REF_RUNS[run]
    n = len(_dims(run)[0]) // 3
    want = ref_result
    assert reports[0]["train"][run]["records"][0]["loss"] == pytest.approx(
        float(want["replicated/tp2/0/metric/loss"]), rel=1e-5)
    for step in range(2):
        pre = f"{mode}/tp1/{step}"
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
    # the frontend-prefix family runs over tp ranks with sequence
    # parallelism (tests/test_torch_dist_frontend.py), not on a prefix and
    # tokens that do not split over tp: 8 + 33 over tp 2
    ("llava-next-mistral-7b", True, "41 positions here, over tp 2"),
    ("mamba2-1.3b", True, "--seq-parallel with the MoE or SSM block")])
def test_check_tp_ranks_still_refuses_later_slices(arch, seq_parallel,
                                                   what):
    """The hybrid family, sequence parallelism with the SSM block (and
    the MoE's) and a sequence that does not split over tp still raise
    over tp ranks, naming their slice and what runs now."""
    cfg = get_smoke(arch)
    with pytest.raises(ValueError, match=f"{what}.*ROADMAP A18c.*one rank "
                       "a tp rank runs the dense, MoE, SSM and "
                       "frontend-prefix families"):
        check_tp_ranks(cfg, seq_parallel=seq_parallel, tp=2,
                       positions=cfg.prefix_len + 33)


@pytest.mark.parametrize("overrides", [None, SSM_PAD],
                         ids=["smoke", "padded"])
def test_check_tp_ranks_lets_the_ssm_family_through(overrides):
    check_tp_ranks(distcheck.with_overrides(get_smoke(ARCH), overrides))


def test_job_config_overrides_every_config_the_launcher_reads():
    """``distcheck.job_config``: inside it the launcher's ``get_config``
    and ``get_smoke`` return the overridden configs (a dtype by its name),
    after it the published ones."""
    from repro_torch.launch import train as launch_train
    over = {"n_layers": 12, "param_dtype": "float64"}
    full, smoke = launch_train.get_config(ARCH), launch_train.get_smoke(ARCH)
    with distcheck.job_config(over):
        for cfg, base in ((launch_train.get_config(ARCH), full),
                          (launch_train.get_smoke(ARCH), smoke)):
            assert (cfg.n_layers, cfg.param_dtype) == (12, torch.float64)
            assert cfg.d_model == base.d_model
    assert launch_train.get_config(ARCH) is full
    assert launch_train.get_smoke(ARCH) is smoke
    with distcheck.job_config(None):
        assert launch_train.get_config(ARCH) is full
