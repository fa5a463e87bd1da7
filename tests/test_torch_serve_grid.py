"""The serving engine's peer-grid plans against the reference's
(``src/repro_torch/serve/engine.py``: ``plan_serving``,
``build_serve_step``, ``abstract_state``; the sequence-sharded
``attention_decode``, the per-peer MoE routing and the weights-stationary
MoE beneath them).

The reference runs once for the file in a subprocess with 8 forced host
devices (results handed over as an ``.npz``): for each case of ``CASES``,
its ``build_serve_step`` on ``make_host_mesh(dp, tp)`` under
``plan_serving``'s plan, from a zero fp32 state of ``abstract_state``'s
shapes, teacher-forced over numpy tokens: every step's next tokens and the
whole state after the last step; and ``abstract_state``'s shapes for each
case of ``SHAPE_CASES``.

The cases: the batch-sharded plan (dp 4, B 4) on gpt2-smoke and on
qwen2-moe-smoke (each peer routes its own token); the sequence-sharded
plan (dp 4, B 1, 2 positions a peer, so the 8 steps cross every shard
boundary) on gpt2-smoke, qwen2-moe-smoke and jamba-smoke; ``weight_fsdp``
+ ``moe_stationary`` on qwen2-moe-smoke under both plans; dp 2 x tp 2 on
gpt2-smoke, smollm-smoke (GQA 3:1: each tp rank keeps one KV head) and
command-r-smoke (GQA 4:2, KV heads sharded).

Tolerance (fp32 smoke configs): every state leaf within ``TOL`` = 1e-5 of
its largest magnitude (measured at most 4.6e-7); tokens equal.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.keys import key
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import (abstract_params, decode_step,
                                init_decode_state, init_params)
from repro_torch.serve import (abstract_state, build_serve_step,
                               global_state, plan_serving)
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax

# name -> (arch, dp, tp, batch, max_seq, steps, weight_fsdp, moe_stationary)
CASES = {
    "gpt2_batch": ("gpt2-paper", 4, 1, 4, 8, 6, False, False),
    "qwen2_batch": ("qwen2-moe-a2.7b", 4, 1, 4, 8, 6, False, False),
    "qwen2_batch_stationary": ("qwen2-moe-a2.7b", 4, 1, 4, 8, 6, True, True),
    "gpt2_seq": ("gpt2-paper", 4, 1, 1, 8, 8, False, False),
    "qwen2_seq": ("qwen2-moe-a2.7b", 4, 1, 1, 8, 8, False, False),
    "qwen2_seq_stationary": ("qwen2-moe-a2.7b", 4, 1, 1, 8, 8, True, True),
    "jamba_seq": ("jamba-v0.1-52b", 4, 1, 1, 8, 8, False, False),
    "gpt2_tp": ("gpt2-paper", 2, 2, 2, 8, 6, False, False),
    "smollm_tp": ("smollm-360m", 2, 2, 2, 8, 6, False, False),
    "commandr_tp": ("command-r-plus-104b", 2, 2, 2, 8, 6, False, False),
}
# name -> (arch, dp, tp, batch, max_seq)
SHAPE_CASES = {
    "gpt2_dp4": ("gpt2-paper", 4, 1, 4, 16),
    "gpt2_tp2": ("gpt2-paper", 2, 2, 2, 16),
    "smollm_tp2": ("smollm-360m", 2, 2, 4, 16),
    "commandr_tp2": ("command-r-plus-104b", 2, 2, 4, 16),
    "mamba2_tp2": ("mamba2-1.3b", 2, 2, 4, 16),
    "jamba_seq": ("jamba-v0.1-52b", 4, 1, 1, 32),
    "jamba_tp4": ("jamba-v0.1-52b", 2, 4, 2, 16),
}
TOL = 1e-5

CHILD = r"""
import json, sys
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
cases, shape_cases = eval(sys.argv[2]), eval(sys.argv[3])
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
    # the same tokens for the cases of one arch and plan
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
for name, (arch, dp, tp, b, smax) in shape_cases.items():
    plan = plan_serving(make_host_mesh(dp, tp), b)
    ab = abstract_state(get_smoke(arch), ShapeConfig("s", smax, b, "decode"),
                        plan)
    save[f"shape/{name}"] = np.array(json.dumps(
        [list(a.shape) + [np.dtype(a.dtype).itemsize]
         for a in jax.tree.leaves(ab)]))
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_serve_grid") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), repr(CASES),
         repr(SHAPE_CASES)],
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


def _params(ref, name, arch, tp):
    like = abstract_params(get_smoke(arch), tp=tp)
    n = len(tree_leaves(like))
    return params_from_jax(tree_unflatten(
        like, [ref[f"{name}/init/{i}"] for i in range(n)]))


def _serve(params, name: str, toks: np.ndarray, device="cpu"):
    """The port's ``build_serve_step`` for case ``name``, teacher-forced
    over ``toks``: (next tokens (B, steps), the state's leaves)."""
    arch, dp, tp, b, smax, steps, fsdp, stat = CASES[name]
    cfg = get_smoke(arch)
    mesh = make_host_mesh(dp, tp)
    plan = plan_serving(mesh, b)
    state = global_state(cfg, batch=b, max_seq=smax, tp=tp,
                         dtype=torch.float32, device=device)
    fn, specs = build_serve_step(cfg, mesh, plan, weight_fsdp=fsdp,
                                 moe_stationary=stat)(state)
    toks = torch.from_numpy(toks).to(device)
    nxt = []
    for t in range(steps):
        n, state = fn(params, state, toks[:, t:t + 1], t)
        nxt.append(n)
    return torch.cat(nxt, dim=1), tree_leaves(state)


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.to(torch.float32).cpu().numpy() - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_step_matches_reference_plan(ref, name):
    arch, dp, tp, b = CASES[name][:4]
    plan = plan_serving(make_host_mesh(dp, tp), b)
    assert bool(plan.seq_axes) == (b < dp)
    nxt, leaves = _serve(_params(ref, name, arch, tp), name,
                         ref[f"{name}/toks"])
    np.testing.assert_array_equal(nxt.numpy(), ref[f"{name}/next"])
    for i, leaf in enumerate(leaves):
        _close(leaf, ref[f"{name}/state/{i}"], f"{name}/state/{i}")


@pytest.mark.parametrize("name", list(SHAPE_CASES))
def test_abstract_state_shapes_match_reference(ref, name):
    """Global, tp-padded shapes (and itemsizes: bf16 caches, fp32 SSD
    states) on the ``meta`` device; the non-dense families' shapes at tp >
    1 too, which ``launch/dryrun.py`` will read."""
    arch, dp, tp, b, smax = SHAPE_CASES[name]
    plan = plan_serving(make_host_mesh(dp, tp), b)
    leaves = tree_leaves(abstract_state(
        get_smoke(arch), ShapeConfig("s", smax, b, "decode"), plan))
    assert all(leaf.device.type == "meta" for leaf in leaves)
    got = [list(leaf.shape) + [leaf.element_size()] for leaf in leaves]
    assert got == json.loads(str(ref[f"shape/{name}"]))


def test_batch_plan_routes_each_peers_tokens_alone(ref):
    """Under the batch-sharded plan each data peer routes its own B/P
    tokens (capacity from B/P): qwen2-moe-smoke at dp 4, B 4 equals four
    single-row decodes, and differs from routing the whole batch at once
    (which drops other assignments)."""
    name = "qwen2_batch"
    arch, _, _, b, smax, steps = CASES[name][:6]
    cfg = get_smoke(arch)
    params = _params(ref, name, arch, 1)
    toks = torch.from_numpy(ref[f"{name}/toks"])
    _, leaves = _serve(params, name, ref[f"{name}/toks"])
    rows, whole = [], init_decode_state(None, cfg, batch=b, max_seq=smax,
                                        dtype=torch.float32)
    for i in range(b):
        st = init_decode_state(None, cfg, batch=1, max_seq=smax,
                               dtype=torch.float32)
        for t in range(steps):
            _, st = decode_step(params, st, toks[i:i + 1, t:t + 1], t, cfg)
        rows.append(tree_leaves(st))
    for t in range(steps):
        _, whole = decode_step(params, whole, toks[:, t:t + 1], t, cfg)
    for j, leaf in enumerate(leaves):
        torch.testing.assert_close(
            leaf, torch.cat([r[j] for r in rows], dim=1), atol=1e-6, rtol=0)
    assert max(float((a - w).abs().max())
               for a, w in zip(leaves, tree_leaves(whole))) > 1e-3


def test_stationary_moe_sums_other_peers_tokens_under_the_batch_plan(ref):
    """A fault of the reference, kept by the port (ROADMAP C): under the
    batch-sharded plan the weights-stationary MoE psums partial products of
    the peers' own, different tokens, so its state leaves the
    non-stationary plan's by far more than rounding; under the
    sequence-sharded plan (every peer the same tokens) the two agree within
    rounding."""
    def gap(a, b):
        np.testing.assert_array_equal(ref[f"{a}/toks"], ref[f"{b}/toks"])
        return max(float(np.abs(ref[f"{a}/state/{i}"]
                                - ref[f"{b}/state/{i}"]).max())
                   for i in range(2))
    assert gap("qwen2_batch", "qwen2_batch_stationary") > 1e-2
    assert gap("qwen2_seq", "qwen2_seq_stationary") < 1e-6


def test_plans_and_specs():
    """``plan_serving``'s choice, ``state_specs``' entries and the batch
    checks of the step."""
    cfg = get_smoke("smollm-360m")
    mesh = make_host_mesh(dp=2, tp=2)
    plan = plan_serving(mesh, 4)
    assert (plan.batch_axes, plan.seq_axes, plan.seq_shards) == (
        ("data",), (), 1)
    long = plan_serving(mesh, 1)
    assert (long.batch_axes, long.seq_axes, long.seq_shards) == (
        (), ("data",), 2)
    state = global_state(cfg, batch=4, max_seq=8, tp=2)
    fn, specs = build_serve_step(cfg, mesh, plan, weight_fsdp=True)(state)
    assert specs["state"][0].k == (None, "data", None, "model", None)
    assert specs["tokens"] == ("data", None)
    assert specs["params"]["embed"] == ("model", "data")
    params = init_params(key(0), cfg, device="cpu", tp=2)
    with pytest.raises(ValueError, match="split"):
        fn(params, global_state(cfg, batch=3, max_seq=8, tp=2),
           torch.zeros((3, 1), dtype=torch.long), 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_serve_step_on_the_card_matches_cpu(card, name):
    """Each plan on the card against the CPU, same parameters (TF32 off):
    tokens equal, state within ``TOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, _, tp = CASES[name][:3]
    cfg = get_smoke(arch)
    params = init_params(key(0), cfg, device="cpu", tp=tp)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(CASES[name][3], CASES[name][5]))
    cpu = _serve(params, name, toks)
    gpu = _serve(tree_unflatten(params, [p.to(card) for p in
                                         tree_leaves(params)]),
                 name, toks, device=card)
    assert torch.equal(cpu[0], gpu[0].cpu())
    for a, g in zip(cpu[1], gpu[1]):
        _close(g, a.numpy(), name)
