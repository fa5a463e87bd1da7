"""The non-dense families over tensor parallelism in the port against the
JAX package's: experts over the ``model`` axis (MoE, arctic's dense
residual, qwen2's shared experts), Mamba-2's SSM heads over it, the
hybrid interleave, and the frontend prefix under tp and sequence
parallelism; the leaf tables, the ``tp = T`` loss, the gradients, and the
launcher at ``--dp 2 --tp 2``.

The reference runs once for the file in a subprocess on 4 forced host
devices (results handed over as an ``.npz``): for each case of ``CASES``
its initial parameters at ``tp = T`` (``PRNGKey(0)``, padded: qwen2-smoke's
6 experts become 8 at tp 4), ``lm_loss`` at ``tp = T`` inside
``shard_map`` over a ``model`` axis (under ``seq_parallel`` for the ``_sp``
cases), and ``jax.grad`` of ``lm_loss`` at ``tp = 1`` on the same padded
tree. The reference's tp gradients are wrong (ROADMAP C), so the port's
gradients at ``tp = T`` are held to its ``tp = 1`` ones. Two more
reference runs pin its behaviour where it cannot run as the port does: the
sequence-parallel loss with a prefix whose length with the tokens does not
split over tp, and the decode step of padded SSM heads.

Tolerances (fp32 smoke configs): losses 1e-5 relative; every gradient
leaf within 1e-4 of that leaf's largest magnitude (fp32 sums in other
orders; the SSD scan's einsums in another association), as
``tests/test_torch_families.py``.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import (ParallelCtx, lm_loss,  # noqa: E402
                                param_specs, param_table)
from repro_torch.models.transformer import (TpLayout, _chunk_loss_tp,  # noqa: E402,E501
                                            _head, _map_table,
                                            forward_hidden, tp_dims)
from repro_torch.serve import (build_serve_step, global_state,  # noqa: E402
                               plan_serving)
from repro_torch.train.trainer import _spec_leaves  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NON_DENSE = ("qwen2-moe-a2.7b", "arctic-480b", "mamba2-1.3b",
             "jamba-v0.1-52b", "llava-next-mistral-7b", "musicgen-medium")
FRONTEND = ("llava-next-mistral-7b", "musicgen-medium")
BATCH, SEQ, PREFIX, SEQ_CHUNK = 2, 16, 4, 8
LOSS_RTOL = 1e-5
REL_TOL = 1e-4
# SSM heads that do not divide tp: 2 heads of 64 padded to 4 at tp 4
SSM_PAD = {"ssm_heads": 2, "ssm_head_dim": 64}
# name -> (arch, config overrides of its smoke config, tp, seq_parallel,
# prefix length, token count)
CASES = {
    "qwen2_tp2": ("qwen2-moe-a2.7b", {}, 2, False, 0, SEQ),
    "qwen2_tp4": ("qwen2-moe-a2.7b", {}, 4, False, 0, SEQ),
    "arctic_tp2": ("arctic-480b", {}, 2, False, 0, SEQ),
    "mamba2_tp2": ("mamba2-1.3b", {}, 2, False, 0, SEQ),
    "jamba_tp2": ("jamba-v0.1-52b", {}, 2, False, 0, SEQ),
    "llava_tp2": ("llava-next-mistral-7b", {}, 2, False, PREFIX, SEQ),
    "musicgen_tp2": ("musicgen-medium", {}, 2, False, PREFIX, SEQ),
    "qwen2_tp2_sp": ("qwen2-moe-a2.7b", {}, 2, True, 0, SEQ),
    "jamba_tp2_sp": ("jamba-v0.1-52b", {}, 2, True, 0, SEQ),
    "llava_tp2_sp": ("llava-next-mistral-7b", {}, 2, True, PREFIX, SEQ),
    "musicgen_tp2_sp": ("musicgen-medium", {}, 2, True, PREFIX, SEQ),
    "ssm_pad_tp4": ("mamba2-1.3b", SSM_PAD, 4, False, 0, SEQ),
}
# (prefix + tokens) % tp != 0 under seq_parallel: 4 + 15 = 19 over 2 ranks
MISALIGNED = ("llava-next-mistral-7b", {}, 2, True, PREFIX, SEQ - 1)

CHILD = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.models import SINGLE, init_params, lm_loss, param_specs
from repro.models.parallel import ParallelCtx
from repro.serve.engine import abstract_state, build_serve_step, plan_serving

out_path, chunk = sys.argv[1], int(sys.argv[2])
cases = eval(sys.argv[3])
save = {}
key = jax.random.PRNGKey(1)


def batch_of(name, cfg, pre, s):
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, cfg.vocab_size, size=(2, s + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if pre:
        b["prefix_embeds"] = rng.standard_normal(
            (2, pre, cfg.frontend_dim)).astype(np.float32)
    for k, v in b.items():
        save[f"{name}/batch/{k}"] = v
    return {k: jnp.asarray(v) for k, v in b.items()}


def tp_loss(cfg, tp, sp, params, b):
    mesh = make_mesh((tp,), ("model",))
    pctx = ParallelCtx(tp_axis="model", sp=sp)
    fn = shard_map(lambda p, bb: lm_loss(p, bb, cfg, pctx, key=key,
                                         seq_chunk=chunk),
                   mesh=mesh, in_specs=(param_specs(cfg, tp=tp), P()),
                   out_specs=P(), check_vma=False)
    return jax.jit(fn)(params, b)


for name, (arch, over, tp, sp, pre, s) in cases.items():
    cfg = dataclasses.replace(get_smoke(arch), **over)
    params = init_params(jax.random.PRNGKey(0), cfg, tp=tp)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        save[f"{name}/init/{i}"] = np.asarray(leaf)
    b = batch_of(name, cfg, pre, s)
    save[f"{name}/loss"] = np.asarray(tp_loss(cfg, tp, sp, params, b))
    if name == "misaligned":
        continue
    grads = jax.jit(jax.grad(lambda p: lm_loss(
        p, b, cfg, SINGLE, key=key, seq_chunk=chunk)))(params)
    for i, g in enumerate(jax.tree.leaves(grads)):
        save[f"{name}/grad/{i}"] = np.asarray(g)

# the decode step of padded SSM heads (2 heads of 64 -> 4 at tp 4)
arch, over, tp = cases["ssm_pad_tp4"][:3]
cfg = dataclasses.replace(get_smoke(arch), **over)
mesh = make_host_mesh(1, tp)
plan = plan_serving(mesh, 1)
ab = abstract_state(cfg, ShapeConfig("s", 8, 1, "decode"), plan)
try:
    fn, _ = build_serve_step(cfg, mesh, plan)(ab)
    state = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), ab)
    jax.jit(fn)(init_params(jax.random.PRNGKey(0), cfg, tp=tp), state,
                jnp.zeros((1, 1), jnp.int32), jnp.int32(0), key)
    save["ssm_pad_decode"] = np.array("ran")
except Exception as e:
    save["ssm_pad_decode"] = np.array(type(e).__name__)
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tp_families") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cases = {**CASES, "misaligned": MISALIGNED}
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), str(SEQ_CHUNK), repr(cases)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke models are too small to gain from torch's intra-op
    threads, and under the suite's parallel workers those threads contend
    for the cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    arch, over = ({**CASES, "misaligned": MISALIGNED}[name])[:2]
    return dataclasses.replace(get_smoke(arch), **over)


def _leaves(table):
    out = []
    _map_table(out.append, table)
    return out


def _params(ref, name):
    tp = {**CASES, "misaligned": MISALIGNED}[name][2]
    table = param_table(_cfg(name), tp=tp)
    like = _map_table(lambda leaf: None, table)
    return params_from_jax(tree_unflatten(
        like, [ref[f"{name}/init/{i}"] for i in range(len(_leaves(table)))]))


def _batch(ref, name):
    pre = f"{name}/batch/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(pre)}


def _pctx(tp, sp=False):
    return ParallelCtx(tp_axis="model", sizes={"model": tp}, sp=sp)


# ------------------------------------------------------------------ layout
_LAYOUT_CASES = ([(a, "smoke", 2) for a in NON_DENSE]
                 + [("qwen2-moe-a2.7b", "smoke", 4)]
                 + [(a, "config", 16) for a in NON_DENSE])


@pytest.mark.parametrize("arch,kind,tp", _LAYOUT_CASES)
def test_layout_and_leaf_table_match_reference(arch, kind, tp):
    """``TpLayout`` (padded experts and SSM heads) and the leaf table
    (global padded shapes, partition specs, fsdp dims, with and without
    FSDP) equal the reference's; ``tp_dims`` is the dim its spec shards
    over ``model``."""
    if kind == "config":
        cfg, jcfg = get_config(arch), jget_config(arch)
    else:
        cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    assert dataclasses.asdict(TpLayout.build(cfg, tp)) == \
        dataclasses.asdict(jtf.TpLayout.build(jcfg, tp))
    for fx in (None, ("data",), ("pod", "data")):
        table = _leaves(param_table(cfg, tp=tp, fsdp_axes=fx))
        jtable = jax.tree.leaves(jtf.param_table(jcfg, tp=tp, fsdp_axes=fx),
                                 is_leaf=lambda x: isinstance(x, jtf.Leaf))
        assert [leaf.shape for leaf in table] == [j.shape for j in jtable]
        assert [leaf.fsdp_dim for leaf in table] == \
            [j.fsdp_dim for j in jtable]
        assert _spec_leaves(param_specs(cfg, tp=tp, fsdp_axes=fx)) == \
            [tuple(j.spec) for j in jtable]
    jtable = jax.tree.leaves(jtf.param_table(jcfg, tp=tp),
                             is_leaf=lambda x: isinstance(x, jtf.Leaf))
    assert tp_dims(cfg, tp) == [
        next((i for i, e in enumerate(j.spec) if e == "model"), None)
        for j in jtable]


# ------------------------------------------------------------ forward, loss
@pytest.mark.parametrize("name", list(CASES))
def test_tp_loss_matches_reference(ref, name):
    """The port's loss at ``tp = T`` (under ``seq_parallel`` for the
    ``_sp`` cases, with a 4-position prefix for the frontend archs) on the
    reference's global padded parameters equals the reference's
    ``shard_map`` loss at ``tp = T``."""
    _, _, tp, sp, _, _ = CASES[name]
    with torch.no_grad():
        got = lm_loss(_params(ref, name), _batch(ref, name), _cfg(name),
                      seq_chunk=SEQ_CHUNK, pctx=_pctx(tp, sp))
    assert float(got) == pytest.approx(float(ref[f"{name}/loss"]),
                                       rel=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_gradients_match_reference_tp1(ref, name):
    """At ``tp = T`` the port's gradients of the global weights equal the
    reference's at ``tp = 1`` on the same padded tree, the replicated
    leaves (``router``, ``wB``, ``wC``, ``frontend_proj``, the norms)
    included: every rank's partial gradient of one feeds the sum by
    construction. Padding changes the function (qwen2's capacity counts
    the padded experts; padded SSM heads are narrower), so the oracle runs
    the padded tree too."""
    _, _, tp, sp, _, _ = CASES[name]
    cfg = _cfg(name)
    params = _params(ref, name)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm_loss(params, _batch(ref, name), cfg, seq_chunk=SEQ_CHUNK,
                   pctx=_pctx(tp, sp))
    grads = torch.autograd.grad(loss, leaves)
    dims = tp_dims(cfg, tp)
    replicated = 0
    for i, (g, d) in enumerate(zip(grads, dims)):
        want = ref[f"{name}/grad/{i}"]
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= REL_TOL * scale, (i, err, scale)
        if d is None and g.dim() >= 2 and scale > 0:
            replicated += 1
    assert replicated >= 1


def test_padded_experts_change_the_capacity():
    """qwen2-smoke at tp 4 pads 6 experts to 8; the reference's capacity
    ``int(cf k t / E_pad)`` counts the padded ones, so the ``tp = 4``
    function differs from the unpadded ``tp = 1`` one, and the padded
    experts are never routed to."""
    cfg = get_smoke("qwen2-moe-a2.7b")
    assert TpLayout.build(cfg, 4).experts_pad == 8 == \
        jtf.TpLayout.build(jget_smoke("qwen2-moe-a2.7b"), 4).experts_pad
    from repro_torch.models.moe import route
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, cfg.d_model), generator=gen)
    router = torch.randn((cfg.d_model, 8), generator=gen)
    r8 = route(x, router, top_k=cfg.top_k, n_experts=6)
    r6 = route(x, router[:, :6], top_k=cfg.top_k, n_experts=6)
    assert r8.capacity < r6.capacity
    assert int(r8.gate_idx.max()) < 6


# ---------------------------------------------- the reference's limits
def test_sp_prefix_that_does_not_split_misaligns_the_reference(ref):
    """Under ``seq_parallel`` with (prefix + tokens) % tp != 0 (4 + 15
    over 2) the reference's ranks take ``s // tp`` positions each, drop the
    last, and ``lm_loss`` re-slices by the length difference: its loss is
    the hidden state of position ``P - r + i`` against label ``i`` (r the
    dropped count), the prefix's last position in the first token's place.
    The port raises instead (ROADMAP C); its own hidden states, shifted as
    the reference shifts them, give the reference's loss."""
    name = "misaligned"
    arch, over, tp, sp, pre, s = MISALIGNED
    cfg = _cfg(name)
    params = _params(ref, name)
    batch = _batch(ref, name)
    with pytest.raises(ValueError, match="divisible by tp"):
        lm_loss(params, batch, cfg, seq_chunk=SEQ_CHUNK, pctx=_pctx(tp, sp))
    r = (pre + s) % tp
    assert r
    with torch.no_grad():
        pctx = _pctx(tp)
        x = forward_hidden(params, batch, cfg, remat=False, pctx=pctx)
        shifted = x[:, pre - r:pre - r + s]
        nll, w = _chunk_loss_tp(shifted, batch["labels"],
                                _head(params, pctx), pctx)
        aligned = lm_loss(params, batch, cfg, seq_chunk=SEQ_CHUNK,
                          pctx=pctx)
    want = float(ref[f"{name}/loss"])
    assert float(nll / w) == pytest.approx(want, rel=LOSS_RTOL)
    assert abs(float(aligned) - want) > 1e-3


def test_padded_ssm_heads_narrow_the_head_and_cannot_decode(ref):
    """2 SSM heads of 64 padded to 4 at tp 4: the reference's block runs
    ``d_inner / H_pad`` = 32-wide heads (the loss above matches it), and
    its decode step fails, its state sized by ``ssm_head_dim``. The
    port's decode raises a ``ValueError`` naming ROADMAP C."""
    assert str(ref["ssm_pad_decode"]) != "ran"
    name = "ssm_pad_tp4"
    cfg = _cfg(name)
    tp = CASES[name][2]
    assert TpLayout.build(cfg, tp).ssm_heads_pad == 4
    mesh = make_host_mesh(1, tp)
    plan = plan_serving(mesh, 1)
    state = global_state(cfg, batch=1, max_seq=8, tp=tp,
                         dtype=torch.float32)
    fn, _ = build_serve_step(cfg, mesh, plan)(state)
    with pytest.raises(ValueError, match="ROADMAP C"):
        fn(_params(ref, name), state, torch.zeros((1, 1), dtype=torch.long),
           0)


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
@pytest.mark.parametrize("arch", NON_DENSE)
def test_launcher_trains_tensor_parallel(arch, mode):
    """``--arch <a> --smoke --device cpu --dp 2 --tp 2`` (with
    ``--seq-parallel --prefix`` for the frontend archs), replicated and
    FSDP x TP (every gather site of the new leaves cut per tp rank),
    trains 2 steps, and without drops every step's loss and grad norm
    equal the ``--tp 1`` launcher's (the smoke configs pad nothing at tp
    2, so both start from the same parameters), within 1e-5 relative."""
    extra = ["--seq-parallel", "--prefix"] if arch in FRONTEND else []
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--dp", "2", "--drop-rate", "0",
            "--log-every", "1", "--dp-mode", mode, *extra]
    tp2 = launch_train.run(base + ["--tp", "2"])
    tp1 = launch_train.run(base + ["--tp", "1"])  # --seq-parallel: no-op
    assert len(tp2) == len(tp1) == 2
    for a, b in zip(tp2, tp1):
        assert math.isfinite(a["loss"]) and a["loss"] > 0
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
