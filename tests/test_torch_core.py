"""Bucket plan, safeguards, keys, the peer-axis collectives and the
pipeline's configuration surface of the port, against the JAX package
where it has a counterpart (exact: these are layout and bookkeeping, no
arithmetic that rounds)."""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.bucket_plan import BucketPlan as JPlan  # noqa: E402
from repro.core.safeguards import LossMonitor as JMonitor  # noqa: E402
from repro.core.safeguards import guard_scale as jguard  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.allreduce import (OptiReduceConfig,  # noqa: E402
                                        rs_spec, sync_pytree)
from repro_torch.core.bucket_plan import BucketPlan, bucket_keys  # noqa: E402
from repro_torch.core.keys import fold_in, key, uniform  # noqa: E402
from repro_torch.core.pipeline import (CollectiveSpec, ThreefryDraws,  # noqa: E402
                                       Hadamard, HTQuant, Lossy, PsumTopology,
                                       SyncContext, TarTopology,
                                       resolve_spec)
from repro_torch.core.safeguards import (LossMonitor, guard_scale,  # noqa: E402
                                         guard_update)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((3, 5)).astype(np.float32),
            "a": [{"z": rng.standard_normal(7).astype(np.float32),
                   "y": rng.standard_normal((2, 2)).astype(np.float32)}],
            "c": rng.standard_normal(11).astype(np.float32)}


@pytest.mark.parametrize("bucket_elems", [8, 16, 1000])
def test_pack_matches_reference_layout(bucket_elems):
    tree = _tree()
    jplan = JPlan.for_tree(jax.tree.map(jnp.asarray, tree), bucket_elems)
    want = np.asarray(jplan.pack(jax.tree.map(jnp.asarray, tree)))
    tt = tree_map(torch.from_numpy, tree)
    plan = BucketPlan.for_tree(tt, bucket_elems)
    assert (plan.num_buckets, plan.bucket_elems) == \
        (jplan.num_buckets, jplan.bucket_elems)
    assert plan.offsets == jplan.offsets and plan.total == jplan.total
    np.testing.assert_array_equal(plan.pack(tt).numpy(), want)
    back = plan.unpack(plan.pack(tt))
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert torch.equal(a, b)


def test_pack_into_accumulates_and_stacks_peers():
    tt = tree_map(torch.from_numpy, _tree())
    plan = BucketPlan.for_tree(tt, 16)
    arena = torch.zeros((2, plan.num_buckets, plan.bucket_elems))
    plan.pack_into(arena[1], tt)
    plan.pack_into(arena[1], tt, accumulate=True)
    assert torch.equal(arena[1], 2 * plan.pack(tt))
    assert float(arena[0].abs().sum()) == 0.0
    stacked = tree_map(lambda x: torch.stack([x, -x]), tt)
    packed = plan.pack(stacked)
    assert packed.shape == (2, plan.num_buckets, plan.bucket_elems)
    assert torch.equal(packed[1], -plan.pack(tt))
    back = plan.unpack(packed)
    assert torch.equal(back["a"][0]["z"][1], -tt["a"][0]["z"])


def test_bucket_keys_fold_in_the_index():
    k = fold_in(key(4), 7)
    assert bucket_keys(k, 3) == [fold_in(k, 0), fold_in(k, 1), fold_in(k, 2)]
    assert fold_in(key(1), 2) != fold_in(key(1), 3)
    assert all(0 <= w < 2 ** 32 for w in fold_in(key(1), 2))
    a = uniform(fold_in(key(1), 2), (4,))
    assert torch.equal(a, uniform(fold_in(key(1), 2), (4,)))


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.1, 0.2])
def test_guard_scale_matches_reference(frac):
    scale, skipped = guard_scale(torch.tensor(frac))
    jscale, jskipped = jguard(jnp.float32(frac))
    assert float(scale) == float(jscale)
    assert bool(skipped) == bool(jskipped)


def test_guard_update_zeroes_tree():
    upd, skipped = guard_update({"w": torch.ones(3)}, torch.tensor(0.5))
    assert bool(skipped) and float(upd["w"].abs().sum()) == 0.0


def test_loss_monitor_halts_like_reference():
    port, ref = LossMonitor(halt_after_consecutive_skips=3), \
        JMonitor(halt_after_consecutive_skips=3)
    for step, skipped in enumerate([True, True, False, True, True, True]):
        port.observe(step, 0.2, skipped)
        ref.observe(step, 0.2, skipped)
        assert (port.halted, port.consecutive_skips, port.total_skips) == \
            (ref.halted, ref.consecutive_skips, ref.total_skips)
    port.maybe_snapshot(0, {"w": torch.ones(2)})
    step, params = port.rollback()
    assert step == 0 and not port.halted and torch.equal(params["w"],
                                                         torch.ones(2))


def test_two_rollbacks_around_an_in_place_update_agree():
    """The optimizers write parameters in place, so a rollback hands out
    copies: a second rollback gives the snapshot again, as the reference's
    immutable arrays do."""
    port, ref = LossMonitor(), JMonitor()
    port.maybe_snapshot(0, {"w": torch.ones(2)})
    ref.maybe_snapshot(0, {"w": jnp.ones(2)})
    _, first = port.rollback()
    first["w"].add_(1.0)                       # a step after the rollback
    _, second = port.rollback()
    _, want = ref.rollback()
    assert second["w"] is not first["w"]
    np.testing.assert_array_equal(second["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(second["w"].numpy(), np.ones(2, np.float32))


def test_collectives_on_the_peer_axis():
    x = torch.arange(4 * 4 * 3, dtype=torch.float32).view(4, 4, 3)
    y = collectives.all_to_all(x)
    assert torch.equal(y[2, 1], x[1, 2])               # receiver-major
    own = torch.arange(8, dtype=torch.float32).view(4, 2)
    g = collectives.all_gather(own)
    assert g.shape == (4, 8) and torch.equal(g[3], own.reshape(-1))
    assert torch.equal(collectives.pmean(own)[1], own.mean(0))
    assert torch.equal(collectives.pmax(own)[0], own.amax(0))
    assert collectives.axis_index(own).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        collectives.all_to_all(torch.zeros(4, 3, 2))


@pytest.mark.parametrize("field,value,item", [
    ("pod_axis", "pod", "A15"), ("rs_wire_bits", 8, "A15"),
    ("active_peers", (0, 1), "A14"), ("shard_weights", (1, 2), "A14"),
    ("dead_links", ((0, 1),), "A14"), ("recovery", "ef", "A16"),
])
def test_unported_config_values_raise(field, value, item):
    """Every field value of the reference now resolves: the pod axis and
    the FSDP wire width (A15), the participation policies of A14 and loss
    recovery (A16) (their semantics are held against the reference in
    tests/test_torch_pod.py, tests/test_torch_fsdp.py,
    tests/test_torch_rounds_sync.py and tests/test_torch_recovery.py)."""
    cfg = OptiReduceConfig(strategy="optireduce_rounds", **{field: value})
    spec = resolve_spec(cfg)
    assert getattr(spec.topology, "schedule") == "rounds"
    assert (type(spec.codec).__name__ == "StaleFill") == (item == "A16")
    if field == "rs_wire_bits":
        codec = rs_spec(cfg).codec
        assert isinstance(codec, HTQuant) and codec.bits == value
        assert codec.noise_salt == 9


def test_registry_and_validation():
    assert isinstance(resolve_spec(OptiReduceConfig()).codec, Hadamard)
    assert isinstance(resolve_spec(OptiReduceConfig(
        strategy="psum")).topology, PsumTopology)
    with pytest.raises(ValueError):
        resolve_spec(OptiReduceConfig(strategy="nope"))
    with pytest.raises(ValueError, match="psum"):
        CollectiveSpec(PsumTopology(), Lossy(), Hadamard())
    assert TarTopology(schedule="rounds").schedule == "rounds"
    with pytest.raises(ValueError, match="schedule"):
        TarTopology(schedule="nope")
    spec2d = resolve_spec(OptiReduceConfig(strategy="optireduce_2d",
                                           pod_axis="pod"))
    assert spec2d.topology == TarTopology(outer="tar")
    assert isinstance(spec2d.transport, Lossy)
    assert isinstance(spec2d.codec, Hadamard)
    assert resolve_spec(OptiReduceConfig(
        strategy="optireduce_q")).topology.outer == "pmean"


def test_use_kernels_demands_the_card():
    cfg = OptiReduceConfig(use_kernels=True)
    ctx = SyncContext(cfg=cfg, draws=ThreefryDraws(key(0), cfg,
                                                    torch.device("cpu")))
    with pytest.raises(RuntimeError, match="CUDA"):
        sync_pytree({"w": torch.zeros(4, 64)}, ctx, bucket_elems=32)


def test_sync_pytree_roundtrips_stacked_leaves():
    g = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn(4, 10, 30, generator=g),
             "b": torch.randn(4, 30, generator=g)}
    cfg = OptiReduceConfig(hadamard_block=16)
    ctx = SyncContext(cfg=cfg, draws=ThreefryDraws(key(0), cfg,
                                                    torch.device("cpu")))
    out = sync_pytree(grads, ctx, bucket_elems=128, mode="pipelined")
    for k in grads:
        assert out[k].shape == grads[k].shape
        torch.testing.assert_close(out[k][2], grads[k].mean(0), atol=1e-5,
                                   rtol=0)
    assert float(ctx.loss_fraction()) == 0.0
