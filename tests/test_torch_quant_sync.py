"""The quantized exchange ``optireduce_q`` (TAR x Lossy x HTQuant) of the port
against the JAX package: the ``HTQuant`` codec stage by stage, and
``sync_packed`` in both modes.

The reference runs once for the file in a subprocess on 4 forced host
devices: its ``sync_packed`` under ``shard_map`` (the jnp path, the
reference's bit-parity oracle of its kernels), and the codec's stages
called one by one inside ``shard_map`` so that the stage-1 codes, the
reduced shards and the stage-2 codes can be recorded. It also records its
draws — each bucket's sign, each receiver's arrival mask, and both noises
(``fold_in(bucket_key, 3)`` for stage 1 and ``fold_in(bucket_key, 4)`` for
stage 2) — and the port is handed those. The recorded noise confirms what
the reference's code says: it is drawn from the bucket key alone, so every
peer quantizes with the same noise.

Tolerances, and why:

* local amax: butterfly against Kronecker rotation, 1e-5 absolute.
* stage-1 codes, from the reference's shared grids fed to the port: equal
  except isolated floor-boundary codes off by one (at most 1 in 10,000).
* reduced shards, from the port's own stage-1 codes: 1e-6 where the codes
  agree, one grid step where a code differed.
* stage-2 codes, from the reference's reduced shards fed to the port:
  bitwise (the same IEEE ops, no rotation).
* the synced bucket: 1e-5 (rotation rounding) plus, in each Hadamard block,
  one grid step / sqrt(block) for every stage-2 code that differs between
  the port's and the reference's end-to-end run (decode spreads a code's
  error evenly over its block). loss_frac: the same masks, 1e-7.
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

from repro_torch.core import collectives, tar  # noqa: E402
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed  # noqa: E402
from repro_torch.core.pipeline import (Encoded, GeneratorDraws,  # noqa: E402
                                       HTQuant, SyncContext, resolve_spec)

AMAX_TOL = 1e-5
MEAN_TOL = 1e-6
ROT_TOL = 1e-5
FLIP_RATE = 1e-4
N = 4
BUCKETS = 5
E = 7000                  # padded to 8192: 16 blocks a peer, 4 a shard
BLOCK = 512
LPAD = 8192
S = LPAD // N
CASES = {"tail": ("tail", 0.1), "nodrop": ("tail", 0.0)}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import drops
from repro.core import tar as tar_lib
from repro.core.allreduce import OptiReduceConfig, SyncContext, sync_packed
from repro.core.bucket_plan import bucket_keys
from repro.core.hadamard import rademacher_sign
from repro.core.pipeline import HTQuant, Lossy

out_path = sys.argv[1]
n, B, E, block, lpad = 4, 5, 7000, 512, 8192
s = lpad // n
mesh = make_mesh((n,), ("data",))
rng = np.random.default_rng(0)
arena = (rng.standard_normal((n, B, E)) * 0.1).astype(np.float32)
save = {"arena": arena}
key = jax.random.PRNGKey(11)
bkeys = bucket_keys(key, B)
save["sign"] = np.stack([np.asarray(rademacher_sign(bkeys[b], block))
                         for b in range(B)])
save["noise3"] = np.stack([np.asarray(jax.random.uniform(
    jax.random.fold_in(bkeys[b], 3), (lpad // block, block)))
    for b in range(B)])
save["noise4"] = np.stack([np.asarray(jax.random.uniform(
    jax.random.fold_in(bkeys[b], 4), (s // block, block)))
    for b in range(B)])
save["mask"] = np.stack([np.stack([np.asarray(drops.make_mask(
    "tail", jax.random.fold_in(bkeys[b], r), n, s, rate=0.1,
    packet_elems=256, self_index=r)) for r in range(n)]) for b in range(B)])
cases = {"tail": ("tail", 0.1), "nodrop": ("tail", 0.0)}
for name, (pattern, rate) in cases.items():
    cfg = OptiReduceConfig(strategy="optireduce_q", drop_rate=rate,
                           drop_pattern=pattern, hadamard_block=block)
    for mode in ("scan", "pipelined"):
        def body(batch, cfg=cfg, mode=mode):
            ctx = SyncContext(cfg=cfg, key=key)
            synced = sync_packed(batch[0], ctx, mode=mode)
            return synced[None], ctx.loss_fraction()
        g = jax.jit(shard_map(body, mesh=mesh,
                              in_specs=P("data", None, None),
                              out_specs=(P("data", None, None), P()),
                              check_vma=False))
        synced, frac = g(jnp.asarray(arena))
        save[f"{name}/{mode}"] = np.asarray(synced)
        save[f"{name}/{mode}/loss_frac"] = np.asarray(frac)

    # the codec's stages one by one, bucket by bucket
    codec, transport = HTQuant(), Lossy()
    def stages(x, bkey, cfg=cfg):
        ctx = SyncContext(cfg=cfg, key=bkey)
        x, _ = tar_lib.pad_for_tar(x[0], n, block)
        x1, amax = codec.local_amax(x, ctx)
        shared = jax.lax.pmax(amax, "data")
        enc = codec.encode_given_amax(x1, shared, ctx)
        received = jax.lax.all_to_all(enc.data.reshape(n, s), "data", 0, 0,
                                      tiled=True)
        i = jax.lax.axis_index("data")
        mask = transport.arrival_mask(ctx, n, s, "data")
        own = codec.reduce(received, mask, i, enc, ctx)
        wire = codec.encode_shard(own, i, enc, ctx)
        return (amax[None], shared, enc.data[None], own[None], wire[None])
    f = jax.jit(shard_map(stages, mesh=mesh,
                          in_specs=(P("data", None), P()),
                          out_specs=(P("data", None), P(), P("data", None),
                                     P("data", None), P("data", None)),
                          check_vma=False))
    for b in range(B):
        outs = f(jnp.asarray(arena[:, b]), bkeys[b])
        for k, v in zip(("amax", "shared", "codes1", "own", "codes2"), outs):
            save[f"{name}/{b}/{k}"] = np.asarray(v)
np.savez(out_path, **save)
print("child OK")
"""


class RecordedDraws:
    """Serves the reference's recorded sign, masks and noises."""

    def __init__(self, ref):
        self._sign = torch.from_numpy(ref["sign"])
        self._mask = torch.from_numpy(ref["mask"])
        self._noise = {3: torch.from_numpy(ref["noise3"]),
                       4: torch.from_numpy(ref["noise4"])}

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s):
        return self._mask[bucket, receiver].clone()

    def noise(self, bucket, salt, shape):
        out = self._noise[salt][bucket]
        assert tuple(out.shape) == tuple(shape)
        return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_quant_sync") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _cfg(case):
    pattern, rate = CASES[case]
    return OptiReduceConfig(strategy="optireduce_q", drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=BLOCK)


def _port_stages(ref, case, b, *, shared=None):
    """The port's codec stages on bucket b; ``shared`` feeds the
    reference's peer-shared amax in place of the port's own."""
    cfg = _cfg(case)
    ctx = SyncContext(cfg=cfg, draws=RecordedDraws(ref)).for_bucket(b)
    spec = resolve_spec(cfg)
    codec = spec.codec
    x, _ = tar.pad_for_tar(torch.from_numpy(ref["arena"][:, b]), N, BLOCK)
    x1, amax = codec.local_amax(x, ctx)
    if shared is None:
        shared = collectives.pmax(amax)[0]
    enc = codec.encode_given_amax(x1, shared, ctx)
    received = collectives.all_to_all(enc.data.view(N, N, S))
    mask = spec.transport.arrival_mask(ctx, N, S)
    own = codec.reduce(received, mask, enc, ctx)
    return ctx, codec, amax, enc, own, codec.encode_shard(own, enc, ctx)


def _flips(a, b):
    d = a.astype(int) - b.astype(int)
    assert np.abs(d).max() <= 1, "a code differs by more than one"
    return d


def test_optireduce_q_is_registered():
    spec = resolve_spec(OptiReduceConfig(strategy="optireduce_q"))
    assert isinstance(spec.codec, HTQuant)
    rounds = resolve_spec(OptiReduceConfig(strategy="tar_rounds_q"))
    assert isinstance(rounds.codec, HTQuant)
    assert rounds.topology.schedule == "rounds"


@pytest.mark.parametrize("case", list(CASES))
def test_codec_stages_match_reference(ref, case):
    for b in range(BUCKETS):
        want = {k: ref[f"{case}/{b}/{k}"]
                for k in ("amax", "shared", "codes1", "own", "codes2")}
        shared = torch.from_numpy(want["shared"])
        ctx, codec, amax, enc, own, _ = _port_stages(ref, case, b,
                                                     shared=shared)
        np.testing.assert_allclose(amax.numpy(), want["amax"],
                                   atol=AMAX_TOL, rtol=0)
        # stage 1, on the reference's grids
        d1 = _flips(enc.data.numpy(), want["codes1"])
        assert np.count_nonzero(d1) <= FLIP_RATE * d1.size
        # the reduce, from the port's codes: a differing code moves its
        # column by at most one grid step
        step_col = np.repeat(enc.step.numpy(), BLOCK).reshape(N, S)
        touched = np.abs(d1).reshape(N, N, S).any(axis=0)
        err = np.abs(own.numpy() - want["own"])
        assert np.all(err[~touched] <= MEAN_TOL)
        assert np.all(err[touched] <= step_col[touched] + MEAN_TOL)
        # stage 2, on the reference's reduced shards
        wire = codec.encode_shard(torch.from_numpy(want["own"]), enc, ctx)
        np.testing.assert_array_equal(wire.numpy(), want["codes2"])


@pytest.mark.parametrize("mode", ["scan", "pipelined"])
@pytest.mark.parametrize("case", list(CASES))
def test_sync_packed_matches_reference(ref, case, mode):
    ctx = SyncContext(cfg=_cfg(case), draws=RecordedDraws(ref))
    got = sync_packed(torch.from_numpy(ref["arena"]), ctx, mode=mode)
    want = ref[f"{case}/{mode}"]
    assert got.shape == want.shape == (N, BUCKETS, E)
    for b in range(BUCKETS):
        _, codec, _, enc, _, wire = _port_stages(ref, case, b)
        # the port's run decodes exactly its own stage-2 codes
        gathered = collectives.all_gather(wire)
        dec = codec.decode_gathered(
            gathered, Encoded(None, lo=enc.lo, step=enc.step),
            ctx.for_bucket(b))[..., :E]
        assert torch.equal(got[:, b], dec)
        d2 = _flips(wire.numpy(), ref[f"{case}/{b}/codes2"])
        assert np.count_nonzero(d2) <= FLIP_RATE * d2.size + 2
        per_block = np.abs(d2).reshape(-1, BLOCK).sum(axis=1)
        tol = ROT_TOL + per_block * enc.step.numpy() / np.sqrt(BLOCK)
        err = np.abs(got[:, b].numpy() - want[:, b])
        err_blocks = np.pad(err, ((0, 0), (0, LPAD - E))).reshape(
            N, -1, BLOCK).max(axis=2)
        assert np.all(err_blocks <= tol[None, :])
    assert float(ctx.loss_fraction()) == pytest.approx(
        float(ref[f"{case}/{mode}/loss_frac"]), abs=1e-7)


def test_unsplit_encode_is_the_split_encode(ref):
    """``HTQuant.encode`` (amax, pmax, quantize in one call) gives the codes
    and grids the topology's split encode gives."""
    for b in range(BUCKETS):
        ctx, codec, _, enc, _, _ = _port_stages(ref, "tail", b)
        x, _ = tar.pad_for_tar(torch.from_numpy(ref["arena"][:, b]), N, BLOCK)
        whole = codec.encode(x, ctx)
        assert torch.equal(whole.data, enc.data)
        assert torch.equal(whole.lo, enc.lo)
        assert torch.equal(whole.step, enc.step)


def test_every_peer_holds_the_same_synced_bucket(ref):
    ctx = SyncContext(cfg=_cfg("tail"), draws=RecordedDraws(ref))
    got = sync_packed(torch.from_numpy(ref["arena"]), ctx, mode="pipelined")
    for p in range(1, N):
        assert torch.equal(got[p], got[0])


def test_scan_and_pipelined_agree_exactly_on_own_draws():
    cfg = _cfg("tail")
    arena = torch.randn((N, 4, 3000), generator=torch.Generator()
                        .manual_seed(2))
    outs = [sync_packed(arena, SyncContext(cfg=cfg, draws=GeneratorDraws(
        key=(1,), cfg=cfg, device=torch.device("cpu"))), mode=mode)
        for mode in ("scan", "pipelined")]
    assert torch.equal(outs[0], outs[1])
    # 8-bit codes of the rotated mean: an estimate, not garbage
    err = (outs[0][0] - arena.mean(0)).pow(2).mean().sqrt()
    assert 0 < float(err) < 0.2


@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_a_non_finite_gradient_turns_its_block_nan(bad):
    """One non-finite entry on one peer makes its Hadamard block's shared
    grid non-finite, so the whole block decodes to NaN on every peer (a
    visible fault, never a finite wrong update); every other block stays
    finite."""
    cfg = _cfg("tail")
    arena = torch.randn((N, 2, 3000), generator=torch.Generator()
                        .manual_seed(4))
    arena[1, 0, 700] = float(bad)             # bucket 0, block 1 (512..1023)
    for mode in ("scan", "pipelined"):
        got = sync_packed(arena, SyncContext(cfg=cfg, draws=GeneratorDraws(
            key=(1,), cfg=cfg, device=torch.device("cpu"))), mode=mode)
        assert bool(got[:, 0, BLOCK:2 * BLOCK].isnan().all())
        rest = torch.cat([got[:, 0, :BLOCK], got[:, 0, 2 * BLOCK:],
                          got[:, 1]], dim=-1)
        assert bool(rest.isfinite().all())


def test_generator_draws_noise_is_shared_and_uniform():
    cfg = _cfg("tail")
    draws = GeneratorDraws(key=(3,), cfg=cfg, device=torch.device("cpu"))
    a, b = draws.noise(2, 3, (16, 512)), draws.noise(2, 3, (16, 512))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert not torch.equal(a, draws.noise(2, 4, (16, 512)))
    assert not torch.equal(a, draws.noise(1, 3, (16, 512)))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.02


def test_quant_bits_outside_uint8_raise():
    cfg = OptiReduceConfig(strategy="optireduce_q", quant_bits=9,
                           hadamard_block=16)
    with pytest.raises(ValueError, match="1..8 bits"):
        sync_packed(torch.zeros((N, 1, 64)), SyncContext(
            cfg=cfg, draws=GeneratorDraws((0,), cfg, torch.device("cpu"))))
