"""The batched sync (``sync_packed(mode='vmap')``) and the unfused oracle
(``sync_pytree_unfused``) of ``repro_torch/core/allreduce.py``.

Within the port, bitwise: ``vmap`` runs each stage once over all B buckets,
interleaved block by block, and must give every bucket the bits ``scan``
gives it, for every registered strategy, over pods and tp groups, under the
participation policies and with a stale-fill cache; the loss counts are the
per-bucket ones summed. The unfused oracle equals ``sync_pytree`` where
their buckets agree.

Against the reference: one child on 4 host devices runs the reference's
``sync_packed(mode='vmap')`` for a set of strategies and its
``sync_pytree_unfused`` with drops, under ``PRNGKey(11)``; the port runs
under ``key(11)`` with its default draws (nothing injected). The loss
fraction must be equal; the values within fp32 rounding (the rotations are
the butterfly here, the Kronecker form there), quantized codes within one
level where a quotient sits on an integer.
"""
import os
import subprocess
import sys

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.allreduce import (OptiReduceConfig,  # noqa: E402
                                        SyncContext, sync_packed,
                                        sync_pytree, sync_pytree_unfused)
from repro_torch.core.keys import key as tkey  # noqa: E402
from repro_torch.core.pipeline import (ThreefryDraws,  # noqa: E402
                                       strategy_names)

N = 4
B = 3
E = 3000
BLOCK = 256
RATE = 0.1
CPU = torch.device("cpu")
ROT_TOL = 1e-5
REF_STRATEGIES = ("optireduce", "optireduce_q", "tar_tcp",
                  "optireduce_rounds", "gloo_ring", "ring_ht")
TREE = {"w": (37, 50), "b": (123,), "z": (4, 9, 11)}
TREE_BUCKET = 1024

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core.allreduce import (OptiReduceConfig, SyncContext, sync_packed,
                                  sync_pytree_unfused)

out_path, strategies = sys.argv[1], eval(sys.argv[2])
n, B, E, block, rate = 4, 3, 3000, 256, float(sys.argv[3])
tree_shapes, tree_bucket = eval(sys.argv[4]), int(sys.argv[5])
mesh = make_mesh((n,), ("data",))
rng = np.random.default_rng(0)
arena = (rng.standard_normal((n, B, E)) * 0.1).astype(np.float32)
save = {"arena": arena}
key = jax.random.PRNGKey(11)
for strategy in strategies:
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                           hadamard_block=block, quant_bits=8, incast=1)
    def body(batch, cfg=cfg):
        ctx = SyncContext(cfg=cfg, key=key)
        return sync_packed(batch[0], ctx, mode="vmap")[None], \
            ctx.loss_fraction()
    g = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data", None, None),
                          out_specs=(P("data", None, None), P()),
                          check_vma=False))
    synced, frac = g(jnp.asarray(arena))
    save[strategy] = np.asarray(synced)
    save[strategy + "/loss_frac"] = np.asarray(frac)
tree = {k: (rng.standard_normal((n, *s)) * 0.1).astype(np.float32)
        for k, s in tree_shapes.items()}
for k, v in tree.items():
    save["tree/" + k] = v
cfg = OptiReduceConfig(strategy="optireduce", drop_rate=rate,
                       hadamard_block=block)
def ubody(t):
    ctx = SyncContext(cfg=cfg, key=key)
    out = sync_pytree_unfused(jax.tree.map(lambda a: a[0], t), ctx,
                              bucket_elems=tree_bucket)
    return jax.tree.map(lambda a: a[None], out), ctx.loss_fraction()
spec = {k: P("data") for k in tree}
g = jax.jit(shard_map(ubody, mesh=mesh, in_specs=(spec,),
                      out_specs=(spec, P()), check_vma=False))
out, frac = g({k: jnp.asarray(v) for k, v in tree.items()})
for k, v in out.items():
    save["unfused/" + k] = np.asarray(v)
save["unfused/loss_frac"] = np.asarray(frac)
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_vmap") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), repr(REF_STRATEGIES),
         str(RATE), repr(TREE), str(TREE_BUCKET)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    return dict(np.load(out))


def _ctx(cfg, grid=collectives.ONE):
    return SyncContext(cfg=cfg, draws=ThreefryDraws(tkey(11), cfg, CPU),
                       grid=grid)


def _arena(p, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((p, B, E)) * 0.1)
                            .astype(np.float32))


def _both(cfg, arena, grid=collectives.ONE, stale=None):
    out = {}
    for mode in ("scan", "vmap"):
        ctx = _ctx(cfg, grid)
        synced = sync_packed(arena, ctx, mode=mode, stale=stale)
        out[mode] = (synced, float(ctx.loss_fraction()),
                     float(ctx.stats.get("filled", 0.0)))
    return out


@pytest.mark.parametrize("pattern", ["tail", "burst"])
@pytest.mark.parametrize("strategy", strategy_names())
def test_vmap_is_scan_bitwise(strategy, pattern):
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=RATE,
                           drop_pattern=pattern, hadamard_block=BLOCK,
                           packet_elems=64)
    out = _both(cfg, _arena(N))
    assert torch.equal(out["vmap"][0], out["scan"][0])
    assert out["vmap"][1:] == out["scan"][1:]


POLICIES = {
    "pods": ("optireduce_2d", {"pod_axis": "pod"}, collectives.Grid(pods=2)),
    "pods_q": ("optireduce_q", {"pod_axis": "pod"}, collectives.Grid(pods=2)),
    "psum_pods": ("psum", {"pod_axis": "pod"}, collectives.Grid(pods=2)),
    "tp": ("optireduce", {}, collectives.Grid(tp=2)),
    "tp_q": ("optireduce_q", {}, collectives.Grid(tp=2)),
    "tp_rounds_q": ("tar_rounds_q", {}, collectives.Grid(tp=2)),
    "stale": ("optireduce", {"recovery": "stale"}, collectives.ONE),
    "stale_rounds": ("optireduce_rounds", {"recovery": "stale"},
                     collectives.ONE),
    "degraded_rounds": ("optireduce_rounds", {"active_peers": (0, 1, 3)},
                        collectives.ONE),
    "degraded_a2a": ("optireduce", {"active_peers": (0, 1, 3)},
                     collectives.ONE),
    "weighted_rounds": ("optireduce_rounds", {"shard_weights": (1, 2, 1, 1)},
                        collectives.ONE),
    "weighted_ring": ("gloo_ring", {"shard_weights": (1, 2, 1, 1)},
                      collectives.ONE),
    "dead_rounds": ("optireduce_rounds", {"dead_links": ((0, 1),)},
                    collectives.ONE),
    "dead_ring": ("gloo_ring", {"dead_links": ((2, 3),)}, collectives.ONE),
}


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_vmap_is_scan_bitwise_under_policies(case):
    strategy, policy, grid = POLICIES[case]
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=RATE,
                           hadamard_block=BLOCK, packet_elems=64, **policy)
    p = N * grid.pods * grid.tp
    stale = None
    if cfg.recovery != "none":
        stale = _arena(1, seed=5)[0] * 0.5
    out = _both(cfg, _arena(p), grid, stale)
    assert torch.equal(out["vmap"][0], out["scan"][0])
    assert out["vmap"][1:] == out["scan"][1:]
    if cfg.recovery != "none":
        assert out["vmap"][2] > 0


def test_vmap_refuses_the_host_wire():
    from repro_torch.core.pipeline import (CollectiveSpec, Hadamard,
                                           TarTopology, WireTransport)
    cfg = OptiReduceConfig(hadamard_block=BLOCK)
    spec = CollectiveSpec(TarTopology(), WireTransport(lambda x: x),
                          Hadamard())
    with pytest.raises(NotImplementedError, match="batched"):
        sync_packed(_arena(N), _ctx(cfg), mode="vmap", spec=spec)


@pytest.mark.parametrize("strategy", REF_STRATEGIES)
def test_vmap_matches_reference_vmap(ref, strategy):
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=RATE,
                           hadamard_block=BLOCK, quant_bits=8, incast=1)
    ctx = _ctx(cfg)
    got = sync_packed(torch.from_numpy(ref["arena"]), ctx,
                      mode="vmap").numpy()
    want = ref[strategy]
    assert float(ctx.loss_fraction()) == pytest.approx(
        float(ref[strategy + "/loss_frac"]), abs=1e-7)
    if strategy == "optireduce_q":
        # one 8-bit level of the bucket's grid where a quotient sits on an
        # integer (the rotations round differently)
        step = 2 * np.abs(ref["arena"]).max() * 4 / 255
        assert np.abs(got - want).max() <= step
        assert np.mean(np.abs(got - want) > ROT_TOL) < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ROT_TOL)


def _tree(ref):
    return {k: torch.from_numpy(ref["tree/" + k]) for k in TREE}


def test_unfused_matches_reference_unfused(ref):
    cfg = OptiReduceConfig(strategy="optireduce", drop_rate=RATE,
                           hadamard_block=BLOCK)
    ctx = _ctx(cfg)
    got = sync_pytree_unfused(_tree(ref), ctx, bucket_elems=TREE_BUCKET)
    assert float(ctx.loss_fraction()) == pytest.approx(
        float(ref["unfused/loss_frac"]), abs=1e-7)
    for k in TREE:
        assert got[k].shape == (N, *TREE[k])
        np.testing.assert_allclose(got[k].numpy(), ref["unfused/" + k],
                                   rtol=0, atol=ROT_TOL)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_unfused_equals_sync_pytree(ref, rate):
    """With drops the two agree where their buckets do (a tree that fills
    whole buckets); without drops also across a short last bucket, which
    the oracle pads less (only as its encode pads it)."""
    cfg = OptiReduceConfig(strategy="optireduce", drop_rate=rate,
                           hadamard_block=BLOCK)
    tree = _tree(ref)
    if rate:
        tree = {"a": torch.from_numpy(np.random.default_rng(3)
                                      .standard_normal((N, 2 * TREE_BUCKET))
                                      .astype(np.float32))}
    a = sync_pytree_unfused(tree, _ctx(cfg), bucket_elems=TREE_BUCKET)
    b = sync_pytree(tree, _ctx(cfg), bucket_elems=TREE_BUCKET)
    for k in tree:
        assert torch.equal(a[k], b[k])
