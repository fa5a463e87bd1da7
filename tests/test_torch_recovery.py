"""The loss-recovery codec of the port (``core/recovery.py``) against the JAX
package's, with the reference's draws injected.

The reference runs once for the file in a subprocess on 4 forced host
devices: a (4, 3, 3000) arena of distinct peers and a (3, 3000) stale
cache, blocks of 256 (buckets padded to 3072, shards of 768), burst drops
at 0.1. It records ``sync_packed(..., stale=)`` with ``recovery="stale"`` on
``optireduce`` and on ``optireduce_rounds`` (incast 2), every peer's
``ef_residual_arena`` and one bucket's ``ef_residual`` (Hadamard, and
Identity with ``use_hadamard=False``), each bucket's
``sender_arrival_masks``, and the draws it took: each bucket's sign and
each receiver's arrival mask, drawn under the receiver's id with its own
row forced.

Tolerances: the port rotates with the butterfly where the reference's jnp
path uses Kronecker matmuls, 1e-5 absolute on values of order 0.1-1 (as
``tests/test_torch_rounds_sync.py``); the masks and every Identity-codec
value are the same arithmetic, so bitwise; loss_frac 1e-7.

On the port alone: without a cache, or without drops, the wrapped codec is
the inner one bit for bit; the fill counts every lost entry; EF conserves
mass (``decode(m*w + (1-m)*w_stale) + residual == bucket`` for each peer,
both codecs); a non-finite cache entry turns a filled entry NaN as the
reference's arithmetic does; and the reference's rejections.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import recovery
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
from repro_torch.core.hadamard import ht_decode, ht_encode
from repro_torch.core.keys import key as tkey  # noqa: E402
from repro_torch.core.pipeline import (ThreefryDraws, SyncContext,
                                       resolve_spec)

N = 4
B = 3
E = 3000
BLOCK = 256
L = 3072                     # E padded to a multiple of N * BLOCK
S = L // N
RATE = 0.1
ROT_TOL = 1e-5
STRATEGIES = {"optireduce": 1, "optireduce_rounds": 2}     # -> incast

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import drops, recovery
from repro.core.allreduce import OptiReduceConfig, SyncContext, sync_packed
from repro.core.bucket_plan import bucket_keys
from repro.core.hadamard import rademacher_sign

out_path = sys.argv[1]
n, B, E, block, rate, L = 4, 3, 3000, 256, 0.1, 3072
s = L // n
mesh = make_mesh((n,), ("data",))
rng = np.random.default_rng(0)
arena = (rng.standard_normal((n, B, E)) * 0.1).astype(np.float32)
stale = (rng.standard_normal((B, E)) * 0.1).astype(np.float32)
save = {"arena": arena, "stale": stale}
key = jax.random.PRNGKey(5)
bkeys = bucket_keys(key, B)
save["sign"] = np.stack([np.asarray(rademacher_sign(bkeys[b], block))
                         for b in range(B)])
for name, width in (("mask", s), ("mask_identity", E // n)):
    save[name] = np.stack([np.stack([np.asarray(drops.make_mask(
        "burst", jax.random.fold_in(bkeys[b], r), n, width, rate=rate,
        self_index=r)) for r in range(n)]) for b in range(B)]
        ).astype(np.uint8)

def cfg_of(strategy, incast=1, hadamard=True, mode="stale"):
    return OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            drop_pattern="burst", hadamard_block=block,
                            incast=incast, use_hadamard=hadamard,
                            recovery=mode)

for strategy, incast in (("optireduce", 1), ("optireduce_rounds", 2)):
    cfg = cfg_of(strategy, incast)
    def body(batch, st, cfg=cfg):
        ctx = SyncContext(cfg=cfg, key=key)
        out = sync_packed(batch[0], ctx, mode="scan", stale=st)
        return out[None], ctx.loss_fraction()
    g = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(P("data", None, None), P()),
                          out_specs=(P("data", None, None), P()),
                          check_vma=False))
    synced, frac = g(jnp.asarray(arena), jnp.asarray(stale))
    save["sync/" + strategy] = np.asarray(synced)
    save["sync/" + strategy + "/loss_frac"] = np.asarray(frac)

for name, hadamard in (("hadamard", True), ("identity", False)):
    cfg = cfg_of("optireduce", hadamard=hadamard, mode="ef")
    def body(batch, st, cfg=cfg):
        me = jax.lax.axis_index("data")
        full = recovery.ef_residual_arena(batch[0], key, cfg, n, me,
                                          stale=st)
        one = recovery.ef_residual(batch[0][1], bkeys[1], cfg, n, me,
                                   stale=st[1])
        return full[None], one[None]
    g = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(P("data", None, None), P()),
                          out_specs=(P("data", None, None), P("data", None)),
                          check_vma=False))
    full, one = g(jnp.asarray(arena), jnp.asarray(stale))
    save["ef_arena/" + name] = np.asarray(full)
    save["ef_one/" + name] = np.asarray(one)

cfg = cfg_of("optireduce", mode="ef")
save["arrival"] = np.stack([np.asarray(recovery.sender_arrival_masks(
    cfg, bkeys[b], n, s)) for b in range(B)]).astype(np.uint8)
np.savez(out_path, **save)
print("child OK")
"""


class RecordedDraws:
    """The reference's sign and masks (of the Hadamard geometry, shards of
    768, or the Identity codec's, shards of 750); checks every mask is
    asked for with the receiver's own row forced."""

    def __init__(self, ref, masks="mask"):
        self._sign = torch.from_numpy(ref["sign"])
        self._mask = torch.from_numpy(ref[masks].astype(np.float32))

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s, self_index=None):
        assert self_index in (None, receiver)
        assert (n, s) == tuple(self._mask.shape[-2:])
        return self._mask[bucket, receiver].clone()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_recovery") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _cfg(strategy="optireduce", *, mode="stale", rate=RATE,
         hadamard=True, pattern="burst", **kw):
    return OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=BLOCK,
                            incast=STRATEGIES.get(strategy, 1),
                            use_hadamard=hadamard, recovery=mode, **kw)


def _ctx(cfg, draws, bucket=None):
    ctx = SyncContext(cfg=cfg, draws=draws)
    return ctx if bucket is None else ctx.for_bucket(bucket)


@pytest.mark.parametrize("mode", ["scan", "pipelined"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_stale_fill_sync_matches_reference(ref, strategy, mode):
    """Lost entries filled from the re-encoded cache, then the plain mean
    over all N senders, on both schedules."""
    ctx = _ctx(_cfg(strategy), RecordedDraws(ref))
    got = sync_packed(torch.from_numpy(ref["arena"]), ctx, mode=mode,
                      stale=torch.from_numpy(ref["stale"]))
    want = ref[f"sync/{strategy}"]
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ROT_TOL, err
    assert float(ctx.loss_fraction()) == pytest.approx(
        float(ref[f"sync/{strategy}/loss_frac"]), abs=1e-7)
    # every lost (receiver, sender, entry) was filled, none more
    assert float(ctx.stats["filled"]) == float(
        (1 - ref["mask"].astype(np.float64)).sum())


@pytest.mark.parametrize("case", ["no_cache", "no_drops"])
def test_without_cache_or_drops_the_inner_codec_bitwise(case):
    g = torch.Generator().manual_seed(1)
    arena = torch.randn((N, B, E), generator=g)
    rate = RATE if case == "no_cache" else 0.0
    stale = None if case == "no_cache" else torch.randn((B, E), generator=g)
    outs = []
    for mode in ("stale", "none"):
        cfg = _cfg(mode=mode, rate=rate)
        draws = ThreefryDraws(key=tkey(2), cfg=cfg, device=torch.device("cpu"))
        outs.append(sync_packed(arena, _ctx(cfg, draws), mode="pipelined",
                                stale=stale))
    assert torch.equal(outs[0], outs[1])


def test_stale_fill_differs_from_the_compensated_mean(ref):
    """With a cache the lost entries carry the prediction: the result is
    not the zero-fill-compensated one."""
    draws = RecordedDraws(ref)
    arena = torch.from_numpy(ref["arena"])
    filled = sync_packed(arena, _ctx(_cfg(), draws),
                         stale=torch.from_numpy(ref["stale"]))
    plain = sync_packed(arena, _ctx(_cfg(mode="none"), draws))
    assert not torch.equal(filled, plain)


@pytest.mark.parametrize("codec", ["hadamard", "identity"])
def test_ef_residual_arena_matches_reference(ref, codec):
    cfg = _cfg(mode="ef", hadamard=codec == "hadamard")
    draws = RecordedDraws(ref, "mask" if codec == "hadamard"
                          else "mask_identity")
    got = recovery.ef_residual_arena(torch.from_numpy(ref["arena"]),
                                     _ctx(cfg, draws),
                                     stale=torch.from_numpy(ref["stale"]))
    want = ref[f"ef_arena/{codec}"]
    assert got.shape == want.shape == (N, B, E)
    if codec == "identity":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ROT_TOL, rtol=0)
    assert float(np.abs(want).max()) > 0


@pytest.mark.parametrize("codec", ["hadamard", "identity"])
def test_ef_residual_one_bucket_matches_reference(ref, codec):
    """One bucket, each peer alone and all peers in one call."""
    cfg = _cfg(mode="ef", hadamard=codec == "hadamard")
    ctx = _ctx(cfg, RecordedDraws(ref, "mask" if codec == "hadamard"
                                  else "mask_identity"), bucket=1)
    bucket = torch.from_numpy(ref["arena"][:, 1])
    stale = torch.from_numpy(ref["stale"][1])
    want = ref[f"ef_one/{codec}"]
    every = recovery.ef_residual(bucket, ctx, N, range(N), stale=stale)
    tol = 0 if codec == "identity" else ROT_TOL
    np.testing.assert_allclose(every.numpy(), want, atol=tol, rtol=0)
    for me in range(N):
        one = recovery.ef_residual(bucket[me], ctx, N, me, stale=stale)
        np.testing.assert_allclose(one.numpy(), want[me], atol=tol, rtol=0)


def test_sender_arrival_masks_match_reference(ref):
    for b in range(B):
        got = recovery.sender_arrival_masks(RecordedDraws(ref), b, N, S)
        np.testing.assert_array_equal(got.numpy(), ref["arrival"][b])
        # sender i's row at owner j is receiver j's row i
        np.testing.assert_array_equal(
            got.numpy().reshape(N, N, S),
            ref["mask"][b].transpose(1, 0, 2))


@pytest.mark.parametrize("me", range(N))
@pytest.mark.parametrize("codec", ["hadamard", "identity"])
def test_ef_conserves_mass(codec, me):
    """What the receivers applied for peer ``me`` (arrived entries, the fill
    elsewhere) plus its residual is its whole contribution."""
    hadamard = codec == "hadamard"
    # small packets: every peer loses some entries and keeps others
    cfg = _cfg(mode="ef", hadamard=hadamard, pattern="bernoulli", rate=0.3,
               packet_elems=16)
    ctx = _ctx(cfg, ThreefryDraws(key=tkey(9), cfg=cfg,
                                   device=torch.device("cpu")), bucket=2)
    g = torch.Generator().manual_seed(me)
    x = torch.randn((L,), generator=g, dtype=torch.float64).float()
    st = torch.randn((L,), generator=g, dtype=torch.float64).float()
    m = recovery.sender_arrival_masks(ctx.draws, ctx.bucket, N, S)[me]
    assert 0 < float(m.sum()) < L          # some entries lost, some not
    if hadamard:
        sign = ctx.sign(BLOCK)
        w, w_st = ht_encode(x, sign, block=BLOCK), ht_encode(st, sign,
                                                            block=BLOCK)
        applied = ht_decode(m * w + (1 - m) * w_st, sign, block=BLOCK)
    else:
        applied = m * x + (1 - m) * st
    resid = recovery.ef_residual(x, ctx, N, me, stale=st)
    torch.testing.assert_close(applied + resid, x, atol=ROT_TOL, rtol=0)


def test_a_non_finite_cache_entry_gives_nan_as_the_reference():
    """``mask*received + (1-mask)*stale``: an inf in the cache turns every
    entry it reaches NaN, arrived ones included (0 * inf), not only the
    lost ones a ``where`` would touch."""
    cfg = _cfg(hadamard=False)
    draws = ThreefryDraws(key=tkey(4), cfg=cfg, device=torch.device("cpu"))
    arena = torch.ones((N, 1, L))
    stale = torch.zeros((1, L))
    stale[0, 5] = float("inf")
    out = sync_packed(arena, _ctx(cfg, draws), stale=stale)
    assert bool(torch.isnan(out[:, 0, 5]).all())
    assert bool(torch.isfinite(out[:, 0, 6:]).all())


def test_parse_layers_the_mechanisms():
    pols = {m: recovery.parse(m) for m in recovery.MODES}
    assert [(p.stale, p.ef, p.budget, p.any) for p in pols.values()] == [
        (False, False, False, False), (True, False, False, True),
        (True, True, False, True), (True, True, True, True)]
    with pytest.raises(ValueError, match="unknown recovery mode"):
        recovery.parse("stale+ef")


@pytest.mark.parametrize("mode,keys", [("none", []), ("stale", ["stale"]),
                                       ("ef", ["ef", "stale"]),
                                       ("ef+budget", ["ef", "stale"])])
def test_init_state_shapes(mode, keys):
    state = recovery.init_state(recovery.parse(mode), 3, 1024, peers=N)
    assert sorted(state) == keys
    if "stale" in state:
        assert state["stale"].shape == (3, 1024)
        assert state["stale"].dtype == torch.float32
    if "ef" in state:
        assert state["ef"].shape == (N, 3, 1024)
        assert not bool(state["ef"].any())


@pytest.mark.parametrize("strategy", ["optireduce_q", "tar_rounds_q"])
def test_quantized_codecs_are_rejected(strategy):
    with pytest.raises(ValueError, match="linear codec"):
        resolve_spec(_cfg(strategy, mode="ef"))


def test_degraded_participation_is_rejected():
    with pytest.raises(ValueError, match="degraded participation"):
        resolve_spec(_cfg(mode="stale", active_peers=(0, 1, 3)))


def test_shard_weights_are_rejected():
    cfg = _cfg("optireduce_rounds", mode="stale", shard_weights=(2, 2, 2, 1))
    draws = ThreefryDraws(key=tkey(1), cfg=cfg, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="shard_weights"):
        sync_packed(torch.zeros((N, 1, L)), _ctx(cfg, draws),
                    stale=torch.zeros((1, L)))


def test_none_resolves_the_unwrapped_codec():
    for strategy in ("optireduce", "optireduce_rounds"):
        spec = resolve_spec(_cfg(strategy, mode="none"))
        assert not isinstance(spec.codec, recovery.StaleFill)
        wrapped = resolve_spec(dataclasses.replace(
            _cfg(strategy), recovery="ef+budget")).codec
        assert isinstance(wrapped, recovery.StaleFill)
        assert type(wrapped.inner) is type(spec.codec)
