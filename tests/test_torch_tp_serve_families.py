"""Serving the non-dense families over tensor parallelism: the port's
``build_serve_step`` against the reference's at ``tp`` 2 (and qwen2-moe
at tp 4, its 6 experts padded to 8) under every plan of
``plan_serving``: batch-sharded (dp 2, B 2), sequence-sharded (dp 2, B 1,
4 cache positions a peer, so the steps cross the shard boundary), and
``weight_fsdp`` + ``moe_stationary`` for the MoE archs (the MoE's experts
over ``model``, Mamba-2's conv channels and SSD heads over it, the
frontend archs' attention and MLP).

The reference runs once for the file in a subprocess with 8 forced host
devices (results handed over as an ``.npz``): for each case of ``CASES``,
its ``build_serve_step`` on ``make_host_mesh(dp, tp)`` from a zero fp32
state of ``abstract_state``'s shapes, teacher-forced over numpy tokens:
every step's next tokens and the whole state after the last step.

Tolerance (fp32 smoke configs): every state leaf within ``TOL`` = 1e-5 of
its largest magnitude, as ``tests/test_torch_serve_grid.py``; tokens
equal. At random init greedy decoding collapses onto few tokens, so the
states carry the comparison.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import abstract_params
from repro_torch.serve import build_serve_step, global_state, plan_serving
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import decode_state_from_jax, params_from_jax

NON_DENSE = {"qwen2": "qwen2-moe-a2.7b", "arctic": "arctic-480b",
             "mamba2": "mamba2-1.3b", "jamba": "jamba-v0.1-52b",
             "llava": "llava-next-mistral-7b", "musicgen": "musicgen-medium"}
MOE = ("qwen2", "arctic", "jamba")
# name -> (arch, dp, tp, batch, max_seq, steps, weight_fsdp, moe_stationary)
CASES = {}
for _short, _arch in NON_DENSE.items():
    CASES[f"{_short}_batch"] = (_arch, 2, 2, 2, 8, 6, False, False)
    CASES[f"{_short}_seq"] = (_arch, 2, 2, 1, 8, 6, False, False)
for _short in MOE:
    CASES[f"{_short}_seq_stationary"] = (NON_DENSE[_short], 2, 2, 1, 8, 6,
                                         True, True)
CASES["qwen2_batch_stationary"] = ("qwen2-moe-a2.7b", 2, 2, 2, 8, 6, True,
                                   True)
CASES["qwen2_tp4"] = ("qwen2-moe-a2.7b", 2, 4, 2, 8, 6, False, False)
TOL = 1e-5

CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.models import init_params
from repro.serve.engine import abstract_state, build_serve_step, plan_serving

out_path = sys.argv[1]
cases = eval(sys.argv[2])
key = jax.random.PRNGKey(0)
save = {}
for name, (arch, dp, tp, b, smax, steps, fsdp, stat) in cases.items():
    cfg = get_smoke(arch)
    mesh = make_host_mesh(dp, tp)
    plan = plan_serving(mesh, b)
    params = init_params(key, cfg, tp=tp)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        save[f"{name}/init/{i}"] = np.asarray(leaf)
    ab = abstract_state(cfg, ShapeConfig("s", smax, b, "decode"), plan)
    state = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), ab)
    fn, _ = build_serve_step(cfg, mesh, plan, weight_fsdp=fsdp,
                             moe_stationary=stat)(ab)
    fn = jax.jit(fn)
    toks = np.random.default_rng([b, steps, len(arch)]).integers(
        0, cfg.vocab_size, size=(b, steps)).astype(np.int32)
    save[f"{name}/toks"] = toks
    nxt = []
    for t in range(steps):
        n, state = fn(params, state, toks[:, t:t + 1], jnp.int32(t), key)
        nxt.append(np.asarray(n))
    save[f"{name}/next"] = np.concatenate(nxt, axis=1)
    for i, leaf in enumerate(jax.tree.leaves(state)):
        save[f"{name}/state/{i}"] = np.asarray(leaf)
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tp_serve_families") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), repr(CASES)],
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


def _params(ref, name):
    arch, _, tp = CASES[name][:3]
    like = abstract_params(get_smoke(arch), tp=tp)
    n = len(tree_leaves(like))
    return params_from_jax(tree_unflatten(
        like, [ref[f"{name}/init/{i}"] for i in range(n)]))


@pytest.mark.parametrize("name", list(CASES))
def test_tp_serving_matches_reference(ref, name):
    """Every step's next tokens equal the reference's, and every state
    leaf (KV caches of every rank's heads, conv channels and SSD heads)
    is within ``TOL`` of the reference's after the last step."""
    arch, dp, tp, b, smax, steps, fsdp, stat = CASES[name]
    cfg = get_smoke(arch)
    mesh = make_host_mesh(dp, tp)
    plan = plan_serving(mesh, b)
    assert plan.tp == tp and bool(plan.seq_axes) == (b < dp)
    state = global_state(cfg, batch=b, max_seq=smax, tp=tp,
                         dtype=torch.float32)
    fn, specs = build_serve_step(cfg, mesh, plan, weight_fsdp=fsdp,
                                 moe_stationary=stat)(state)
    assert any("model" in s for s in tree_leaves_specs(specs["state"]))
    params = _params(ref, name)
    toks = torch.from_numpy(ref[f"{name}/toks"])
    nxt = []
    for t in range(steps):
        n, state = fn(params, state, toks[:, t:t + 1], t)
        nxt.append(n)
    np.testing.assert_array_equal(torch.cat(nxt, dim=1).numpy(),
                                  ref[f"{name}/next"])
    for i, leaf in enumerate(tree_leaves(state)):
        want = ref[f"{name}/state/{i}"]
        assert tuple(leaf.shape) == want.shape, i
        scale = float(np.abs(want).max())
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= TOL * max(scale, 1e-30), (i, err, scale)


def tree_leaves_specs(specs):
    """The state specs' leaves (each a tuple of entries)."""
    return [s for st in specs for s in st]


@pytest.mark.parametrize("name", ["mamba2_batch", "jamba_seq", "qwen2_tp4"])
def test_decode_state_from_jax_takes_tp_states(ref, name):
    """The reference's state served over tp (its global arrays: every
    rank's KV heads, conv channels and SSD heads) carries into the port's
    ``global_state`` layout leaf for leaf, bit for bit."""
    from repro.models.layers import KVCache as JKVCache
    from repro.models.ssm import SSMState as JSSMState
    from repro_torch.models.layers import KVCache

    arch, dp, tp, b, smax = CASES[name][:5]
    like = global_state(get_smoke(arch), batch=b, max_seq=smax, tp=tp,
                        dtype=torch.float32, device="meta")
    it = iter(range(len(tree_leaves(like))))
    jstate = [(JKVCache if isinstance(st, KVCache) else JSSMState)(
        *(ref[f"{name}/state/{next(it)}"] for _ in st)) for st in like]
    got = decode_state_from_jax(jstate)
    assert [type(a) for a in got] == [type(a) for a in like]
    for g, w, i in zip(tree_leaves(got), tree_leaves(like),
                       range(len(tree_leaves(like)))):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), ref[f"{name}/state/{i}"])
