"""Tensor parallelism in the port's model against the JAX package's:
``TpLayout``, the leaf tables, the tp-sharded forward pass and loss, the
gradients, and the reference's fault with them.

The reference runs once for the file in a subprocess on 4 forced host
devices: ``lm_loss`` inside ``shard_map`` over a ``model`` axis of 2 or 4
for ``gpt2-smoke`` and for variants that pad the heads, replicate the KV
projections (``kv_replicated``) or keep one KV head a shard
(``kv_single``), with and without ``seq_parallel``; the gradients at
``tp = 1`` on one device and at ``tp = 2`` through its ``shard_map``; and
one step of its trainer at ``(data 1, model 2)``.

Tolerances: losses 1e-6 relative (fp32; the port computes the same sums,
some in another order); gradients 1e-5 absolute (fp32 gradients of scale
1e-2 and below); the sequence-parallel loss equals the plain one exactly,
as the reference's own test asserts on its first step.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.optimizers import OptimizerConfig as JOptCfg  # noqa: E402
from repro.optim.optimizers import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import (ParallelCtx, init_params,  # noqa: E402
                                lm_loss, param_specs, param_table)
from repro_torch.models.transformer import TpLayout, _map_table  # noqa: E402
from repro_torch.train.trainer import _spec_leaves  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from repro_torch.core.keys import key as tkey  # noqa: E402

SEQ = 32
BATCH = 2
CHUNK = 16
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# loss case -> (config overrides of gpt2-smoke, tp, seq_parallel)
LOSS_CASES = {
    "tp2": ({}, 2, False),
    "tp4": ({}, 4, False),
    "pad_heads": ({"n_heads": 6, "n_kv_heads": 6}, 4, False),
    "kv_replicated": ({"n_heads": 6, "n_kv_heads": 3}, 4, False),
    "kv_single": ({"n_kv_heads": 2}, 4, False),
    "tp2_sp": ({}, 2, True),
    "tp4_sp": ({}, 4, True),
}

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
from repro.core.allreduce import OptiReduceConfig
from repro.launch.mesh import make_host_mesh
from repro.models import SINGLE, init_params, lm_loss, param_specs
from repro.models.parallel import ParallelCtx
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, seq, batch, chunk = sys.argv[1:5]
seq, batch, chunk = int(seq), int(batch), int(chunk)
cases = eval(sys.argv[5])
save = {}
base = get_smoke("gpt2-paper")
rng = np.random.default_rng(0)
tokens = rng.integers(0, base.vocab_size, (batch, seq)).astype(np.int32)
labels = rng.integers(0, base.vocab_size, (batch, seq)).astype(np.int32)
save["tokens"], save["labels"] = tokens, labels
b = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
key = jax.random.PRNGKey(0)


def tp_fn(cfg, tp, sp, what):
    mesh = make_mesh((tp,), ("model",))
    pctx = ParallelCtx(tp_axis="model", sp=sp)
    specs = param_specs(cfg, tp=tp)
    def loss(p, bb):
        return lm_loss(p, bb, cfg, pctx, key=key, seq_chunk=chunk,
                       remat=False)
    body = loss if what == "loss" else jax.grad(loss)
    out = P() if what == "loss" else specs
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P()),
                             out_specs=out, check_vma=False))


for name, (over, tp, sp) in cases.items():
    cfg = dataclasses.replace(base, **over)
    params = init_params(jax.random.PRNGKey(1), cfg, tp=tp)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        save[f"{name}/init/{i}"] = np.asarray(leaf)
    save[f"{name}/loss"] = np.asarray(tp_fn(cfg, tp, sp, "loss")(params, b))

# gradients: tp = 1 on one device, and the reference's tp = 2
params = init_params(jax.random.PRNGKey(1), base, tp=2)
g1 = jax.grad(lambda p: lm_loss(p, b, base, SINGLE, key=key,
                                seq_chunk=chunk, remat=False))(params)
g2 = tp_fn(base, 2, False, "grad")(params, b)
for i, (a, c) in enumerate(zip(jax.tree.leaves(g1), jax.tree.leaves(g2))):
    save[f"grad1/{i}"], save[f"grad2/{i}"] = np.asarray(a), np.asarray(c)

# one SGD step of the reference's trainer at (data 1, model 2): every
# device's copy of the replicated final_ln afterwards
tc = TrainConfig(sync=OptiReduceConfig(strategy="psum"),
                 optimizer=OptimizerConfig(name="sgd", lr=1.0, momentum=0.0,
                                           grad_clip=1e9),
                 seq_chunk=chunk, bucket_elems=16_384)
make_step, opt, _ = build_train_step(base, tc, make_host_mesh(dp=1, tp=2))
step_fn, sh = make_step(jax.eval_shape(opt.init, params),
                        {"tokens": tokens, "labels": labels})
p = jax.device_put(params, sh["params"])
o = jax.jit(opt.init, out_shardings=sh["opt"])(p)
p, o, m = jax.jit(step_fn)(p, o, jax.device_put(
    {"tokens": tokens, "labels": labels}, sh["batch"]),
    jnp.asarray(0, jnp.int32), key)
save["step/final_ln"] = np.stack([np.asarray(s.data) for s in
                                  p["final_ln"].addressable_shards])
save["step/grad_norm"] = np.asarray(m["grad_norm"])
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tp") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), str(SEQ), str(BATCH),
         str(CHUNK), repr(LOSS_CASES)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _batch(ref):
    return {"tokens": torch.from_numpy(ref["tokens"]).long(),
            "labels": torch.from_numpy(ref["labels"]).long()}


def _params(ref, prefix, cfg, tp):
    like = _map_table(lambda leaf: None, param_table(cfg, tp=tp))
    n = len(_leaves(param_table(cfg, tp=tp)))
    return params_from_jax(tree_unflatten(
        like, [ref[f"{prefix}/{i}"] for i in range(n)]))


def _leaves(table):
    out = []
    _map_table(out.append, table)
    return out


def _pctx(tp, sp=False):
    return ParallelCtx(tp_axis="model", sizes={"model": tp}, sp=sp)


# ------------------------------------------------------------------ layout
_LAYOUT_CASES = [("gpt2-paper", {}, tp) for tp in (1, 2, 4, 16)] + [
    ("gpt2-smoke", {}, 16), ("gpt2-smoke", {"n_kv_heads": 2}, 4),
    ("gpt2-smoke", {"n_heads": 6, "n_kv_heads": 3}, 4)]


@pytest.mark.parametrize("arch,over,tp", _LAYOUT_CASES)
def test_layout_and_leaf_table_match_reference(arch, over, tp):
    """``TpLayout`` (its fields, ``kv_select`` and ``kv_map`` a shard) and
    the leaf table (global padded shapes, partition specs, fsdp dims, with
    and without FSDP) equal the reference's."""
    if arch == "gpt2-paper":
        cfg, jcfg = get_config(arch), jget_config(arch)
    else:
        cfg = dataclasses.replace(get_smoke("gpt2-paper"), **over)
        jcfg = dataclasses.replace(jget_smoke("gpt2-paper"), **over)
    lay, jlay = TpLayout.build(cfg, tp), jtf.TpLayout.build(jcfg, tp)
    assert dataclasses.asdict(lay) == dataclasses.asdict(jlay)
    for s in range(tp):
        sel = jlay.kv_select(jnp.int32(s))
        assert lay.kv_select(s) == (None if sel is None else int(sel))
        kmap = jlay.kv_map(jcfg, jnp.int32(s))
        assert lay.kv_map(cfg, s) == (None if kmap is None
                                      else [int(v) for v in kmap])
    for fx in (None, ("data",)):
        table = _leaves(param_table(cfg, tp=tp, fsdp_axes=fx))
        jtable = jax.tree.leaves(jtf.param_table(jcfg, tp=tp, fsdp_axes=fx),
                                 is_leaf=lambda x: isinstance(x, jtf.Leaf))
        assert [leaf.shape for leaf in table] == [j.shape for j in jtable]
        assert [leaf.fsdp_dim for leaf in table] == \
            [j.fsdp_dim for j in jtable]
        assert _spec_leaves(param_specs(cfg, tp=tp, fsdp_axes=fx)) == \
            [tuple(j.spec) for j in jtable]


# ------------------------------------------------------------ forward, loss
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_tp_loss_matches_reference(ref, case):
    """The port's loss at ``tp = T`` (and under sequence parallelism) on
    the reference's global padded parameters equals the reference's
    ``shard_map`` loss at ``tp = T``."""
    over, tp, sp = LOSS_CASES[case]
    cfg = dataclasses.replace(get_smoke("gpt2-paper"), **over)
    params = _params(ref, f"{case}/init", cfg, tp)
    with torch.no_grad():
        got = lm_loss(params, _batch(ref), cfg, seq_chunk=CHUNK,
                      remat=False, pctx=_pctx(tp, sp))
    assert float(got) == pytest.approx(float(ref[f"{case}/loss"]),
                                       rel=LOSS_RTOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_seq_parallel_loss_equals_plain(ref, tp):
    """Sequence parallelism changes no value: the same loss, bit for bit,
    and the same gradients (the reference's own test asserts equal losses
    on its first step)."""
    cfg = get_smoke("gpt2-paper")
    out = []
    for sp in (False, True):
        params = _params(ref, f"tp{tp}/init", cfg, tp)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm_loss(params, _batch(ref), cfg, seq_chunk=CHUNK,
                       pctx=_pctx(tp, sp))
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def _port_grads(ref, tp):
    cfg = get_smoke("gpt2-paper")
    params = _params(ref, "tp2/init", cfg, 2)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    pctx = _pctx(tp) if tp > 1 else None
    loss = lm_loss(params, _batch(ref), cfg, seq_chunk=CHUNK, pctx=pctx)
    return torch.autograd.grad(loss, leaves)


def test_tp_gradients_match_reference_tp1(ref):
    """At ``tp = 2`` the port's gradients of the global weights equal the
    reference's at ``tp = 1`` on the same (unpadded) weights: the math of
    tensor parallelism does not change the gradient."""
    for i, g in enumerate(_port_grads(ref, 2)):
        np.testing.assert_allclose(g.numpy(), ref[f"grad1/{i}"],
                                   atol=GRAD_TOL, rtol=0, err_msg=f"leaf {i}")


def test_reference_tp_gradients_are_scaled_and_replicas_drift(ref):
    """Pins the reference's fault (ROADMAP C): under ``check_vma=False``
    its tp-sharded leaves' gradients are ``tp`` x its ``tp = 1`` ones, its
    replicated leaves get per-shard partial sums, and after one SGD step
    the two devices' copies of ``final_ln`` differ. The port's gradients
    are the ``tp = 1`` ones."""
    cfg = get_smoke("gpt2-paper")
    sharded = [leaf.tp_dim is not None
               for leaf in _leaves(param_table(cfg, tp=2))]
    assert any(sharded) and not all(sharded)
    ports = _port_grads(ref, 2)
    for i, is_sharded in enumerate(sharded):
        g1, g2 = ref[f"grad1/{i}"], ref[f"grad2/{i}"]
        if is_sharded:
            np.testing.assert_allclose(g2, 2.0 * g1, atol=GRAD_TOL, rtol=0)
        else:
            assert float(np.abs(g2 - g1).max()) > 1e-3, i
        np.testing.assert_allclose(ports[i].numpy(), g1, atol=GRAD_TOL,
                                   rtol=0)
    copies = ref["step/final_ln"]
    assert copies.shape[0] == 2
    assert float(np.abs(copies[0] - copies[1]).max()) > 1e-3


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("tp,over,dtype", [
    (2, {}, "float32"), (4, {"n_heads": 6, "n_kv_heads": 3}, "bfloat16")])
def test_params_from_jax_takes_tp_padded_trees(tp, over, dtype):
    """``params_from_jax`` takes the reference's ``tp``-padded global
    parameters and AdamW state leaf for leaf (bf16 bit for bit) into trees
    of the port's ``param_table(cfg, tp=...)`` shapes."""
    jcfg = dataclasses.replace(jget_smoke("gpt2-paper"), **over,
                               param_dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(get_smoke("gpt2-paper"), **over,
                              param_dtype=getattr(torch, dtype))
    jparams = jinit(jax.random.PRNGKey(3), jcfg, tp=tp)
    jstate = jadamw(JOptCfg()).init(jparams)
    jstate = jstate._replace(m=jax.tree.map(lambda x: x + 1, jstate.m))
    np_tree = jax.tree.map(np.asarray, (jparams, jstate))
    params, state = params_from_jax(*np_tree)
    table = _leaves(param_table(cfg, tp=tp))
    for leaf, p, jp, m, jm in zip(table, tree_leaves(params),
                                  jax.tree.leaves(np_tree[0]),
                                  tree_leaves(state.m),
                                  jax.tree.leaves(np_tree[1].m)):
        assert tuple(p.shape) == leaf.shape
        assert p.dtype == cfg.param_dtype
        np.testing.assert_array_equal(
            p.to(torch.float32).numpy(), np.asarray(jp, np.float32))
        np.testing.assert_array_equal(
            m.to(torch.float32).numpy(), np.asarray(jm, np.float32))
    assert tuple(init_params(tkey(0), cfg, device="cpu",
                             tp=tp)["embed"].shape) == table[0].shape


def test_checkpoint_holds_the_global_padded_leaves(tmp_path):
    """``--ckpt-dir`` / ``--resume`` under tensor parallelism: the port's
    checkpoint holds the global padded leaves (bf16 included), restores
    them bit for bit, and restores the reference's own checkpoint of its
    ``tp``-padded parameters and AdamW state (the reference writes bf16 as
    it cannot read back; ROADMAP C)."""
    from repro.train import checkpoint as jckpt
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train import checkpoint as ckpt

    over = {"n_heads": 6, "n_kv_heads": 3}
    tp = 4
    jcfg = dataclasses.replace(jget_smoke("gpt2-paper"), **over,
                               param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_smoke("gpt2-paper"), **over,
                              param_dtype=torch.bfloat16)
    jparams = jinit(jax.random.PRNGKey(4), jcfg, tp=tp)
    jstate = jadamw(JOptCfg()).init(jparams)
    jckpt.save(str(tmp_path / "ref"), 3, (jparams, jstate))
    like = init_params(tkey(0), cfg, device="cpu", tp=tp)
    like_state = make_optimizer(OptimizerConfig()).init(like)
    step, (params, state), _ = ckpt.restore(str(tmp_path / "ref"),
                                            (like, like_state))
    assert step == 3
    for p, jp in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == jp.shape
        np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                      np.asarray(jp).view(np.int16))
    ckpt.save(str(tmp_path / "port"), 5, (params, state))
    _, (back, back_state), _ = ckpt.restore(str(tmp_path / "port"),
                                            (like, like_state))
    for a, b in zip(tree_leaves((back, back_state)),
                    tree_leaves((params, state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
