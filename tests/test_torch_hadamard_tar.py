"""Randomized Hadamard codec, TAR over the peer axis, the sync engine and
the drop model of the port, against the JAX package.

The reference's multi-device side (``tar_allreduce`` and ``sync_packed``
under ``shard_map`` on 4 forced host devices) runs once for the file in a
subprocess that writes an ``.npz``; its arrival masks and Hadamard signs
are drawn there from the reference's keys and handed to the port.

Tolerances: 1e-5 absolute where a rotation is involved (the port's
butterfly against the reference's Kronecker matmuls, fp32 rounding of unit
scale values), 1e-6 for the masked mean alone. The drop model draws from
torch generators, which cannot reproduce threefry, so its patterns are
checked by distribution and structure.
"""
import os
import subprocess
import sys

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import drops as jdrops  # noqa: E402
from repro.core import hadamard as jhad  # noqa: E402
from repro_torch.core import drops, tar  # noqa: E402
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed  # noqa: E402
from repro_torch.core.hadamard import ht_decode, ht_encode, rademacher_sign  # noqa: E402
from repro_torch.core.keys import generator  # noqa: E402
from repro_torch.core.pipeline import SyncContext  # noqa: E402

ROT_TOL = 1e-5
MEAN_TOL = 1e-6
N = 4
L = 4 * 2048
BUCKETS = 5
E = 8192
BLOCK = 512

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
from repro.core.allreduce import OptiReduceConfig, SyncContext, sync_packed
from repro.core.bucket_plan import bucket_keys
from repro.core.hadamard import rademacher_sign
from repro.core.tar import tar_allreduce

out_path = sys.argv[1]
n, L, B, E, block = 4, 4 * 2048, 5, 8192, 512
mesh = make_mesh((n,), ("data",))
rng = np.random.default_rng(0)
save = {}

# 1) tar_allreduce with per-receiver masks (self row forced to 1)
xs = rng.standard_normal((n, L)).astype(np.float32)
mkey = jax.random.PRNGKey(5)
s = L // n
def tar_body(x):
    me = jax.lax.axis_index("data")
    mask = drops.make_mask("bernoulli", jax.random.fold_in(mkey, me), n, s,
                           rate=0.3, packet_elems=64, self_index=me)
    return tar_allreduce(x.reshape(-1), "data", mask=mask)[None], mask[None]
f = jax.jit(shard_map(tar_body, mesh=mesh, in_specs=P("data", None),
                      out_specs=(P("data", None), P("data", None, None)),
                      check_vma=False))
out, masks = f(jnp.asarray(xs))
save.update(tar_x=xs, tar_out=np.asarray(out), tar_mask=np.asarray(masks))

# 2) sync_packed per strategy and mode, with the draws it used
arena = rng.standard_normal((n, B, E)).astype(np.float32)
save["arena"] = arena
key = jax.random.PRNGKey(9)
bkeys = bucket_keys(key, B)
ss = (E + (-E) % (n * block)) // n
save["sign"] = np.stack([np.asarray(rademacher_sign(bkeys[b], block))
                         for b in range(B)])
for pattern in ("tail", "bernoulli"):
    save[f"mask_{pattern}"] = np.stack([np.stack([np.asarray(
        drops.make_mask(pattern, jax.random.fold_in(bkeys[b], r), n, ss,
                        rate=0.1, packet_elems=256, self_index=r))
        for r in range(n)]) for b in range(B)])
cases = {"optireduce_tail": ("optireduce", "tail", 0.1),
         "optireduce_bernoulli": ("optireduce", "bernoulli", 0.1),
         "tar_tcp": ("tar_tcp", "tail", 0.0), "psum": ("psum", "tail", 0.0)}
for name, (strategy, pattern, rate) in cases.items():
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
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
np.savez(out_path, **save)
print("child OK")
"""


class RecordedDraws:
    def __init__(self, sign, mask=None):
        self._sign = torch.from_numpy(sign)
        self._mask = None if mask is None else torch.from_numpy(mask)

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s):
        return self._mask[bucket, receiver].clone()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tar") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


# ------------------------------------------------------------ Hadamard codec
@pytest.mark.parametrize("block", [256, 1024, 4096])
def test_ht_encode_decode_match_reference(block):
    key = jax.random.PRNGKey(block)
    rng = np.random.default_rng(block)
    x = rng.standard_normal(3 * block).astype(np.float32)
    sign = np.asarray(jhad.rademacher_sign(key, block))
    enc_ref = np.asarray(jhad.ht_encode(x, key, block=block))
    dec_ref = np.asarray(jhad.ht_decode(enc_ref, key, block=block))
    st = torch.tensor(sign)
    enc = ht_encode(torch.from_numpy(x), st, block=block)
    np.testing.assert_allclose(enc.numpy(), enc_ref, atol=ROT_TOL)
    dec = ht_decode(torch.from_numpy(enc_ref), st, block=block)
    np.testing.assert_allclose(dec.numpy(), dec_ref, atol=ROT_TOL)
    np.testing.assert_allclose(dec.numpy(), x, atol=ROT_TOL)


def test_ht_encode_rejects_unaligned_bucket():
    with pytest.raises(ValueError, match="multiple of block"):
        ht_encode(torch.zeros(1000), torch.ones(256), block=256)


def test_rademacher_sign_is_pm_one_and_deterministic():
    a = rademacher_sign(generator((1, 2)), 4096)
    b = rademacher_sign(generator((1, 2)), 4096)
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(a.mean())) < 0.1


# ------------------------------------------------------- TAR on peer axis
def test_tar_allreduce_matches_reference(ref):
    x = torch.from_numpy(ref["tar_x"])
    mask = torch.from_numpy(ref["tar_mask"])
    got = tar.tar_allreduce(x, mask=mask)
    np.testing.assert_allclose(got.numpy(), ref["tar_out"], atol=MEAN_TOL,
                               rtol=0)
    for p in range(1, N):                     # every peer holds the result
        assert torch.equal(got[p], got[0])


def test_tar_without_mask_is_the_mean(ref):
    x = torch.from_numpy(ref["tar_x"])
    got = tar.tar_allreduce(x)
    np.testing.assert_allclose(got[0].numpy(), ref["tar_x"].mean(0),
                               atol=MEAN_TOL)


def test_pad_for_tar_block_aligns():
    x, length = tar.pad_for_tar(torch.ones((2, 1000)), 4, 64)
    assert length == 1000 and x.shape == (2, 1024)
    assert float(x[:, 1000:].abs().sum()) == 0.0


# --------------------------------------------------------- the sync engine
@pytest.mark.parametrize("mode", ["scan", "pipelined"])
@pytest.mark.parametrize("case", ["optireduce_tail", "optireduce_bernoulli",
                                  "tar_tcp", "psum"])
def test_sync_packed_matches_reference(ref, case, mode):
    strategy = case.split("_")[0] if case != "tar_tcp" else "tar_tcp"
    pattern = case.split("_")[1] if case.startswith("optireduce") else "tail"
    rate = 0.1 if case.startswith("optireduce") else 0.0
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                           drop_pattern=pattern, hadamard_block=BLOCK)
    draws = RecordedDraws(ref["sign"], ref[f"mask_{pattern}"])
    ctx = SyncContext(cfg=cfg, draws=draws)
    got = sync_packed(torch.from_numpy(ref["arena"]), ctx, mode=mode)
    np.testing.assert_allclose(got.numpy(), ref[f"{case}/{mode}"],
                               atol=ROT_TOL, rtol=0)
    assert float(ctx.loss_fraction()) == pytest.approx(
        float(ref[f"{case}/{mode}/loss_frac"]), abs=1e-7)


# ------------------------------------------------------------- drop model
PATTERNS = ["bernoulli", "tail", "straggler", "burst"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_self_row_is_never_dropped(pattern):
    for r in range(N):
        m = drops.make_mask(pattern, generator((3, r)), N, 5000, rate=0.4,
                            self_index=r)
        assert m.shape == (N, 5000) and m.dtype == torch.float32
        assert bool((m[r] == 1.0).all())
        assert set(m.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("pattern", PATTERNS)
def test_loss_fraction_tracks_rate_like_reference(pattern):
    """Port and reference draw different bits; their mean loss over many
    draws must both sit at the configured rate."""
    rate, n_elems, draws = 0.05, 256 * 200, 60
    port = np.mean([float(drops.loss_fraction(drops.make_mask(
        pattern, generator((7, i)), N, n_elems, rate=rate)))
        for i in range(draws)])
    jmask = jax.jit(lambda k: jdrops.make_mask(pattern, k, N, n_elems,
                                               rate=rate))
    refv = np.mean([float(jdrops.loss_fraction(jmask(
        jax.random.PRNGKey(i)))) for i in range(draws)])
    # straggler loses whole rows: 240 Bernoulli rows -> sd ~0.014
    tol = 0.035 if pattern == "straggler" else 0.015
    assert abs(port - rate) < tol, (pattern, port)
    assert abs(refv - rate) < tol, (pattern, refv)


def test_tail_cut_structure_matches_reference():
    """A timed-out peer loses exactly the packets from the reference's cut
    index onward; the others lose nothing."""
    n_elems, rate, pkt = 256 * 100, 0.02, 256
    jm = np.asarray(jdrops.tail_mask(jax.random.PRNGKey(0), 64, n_elems,
                                     rate=rate, packet_elems=pkt))
    tm = drops.tail_mask(generator((0,)), 64, n_elems, rate=rate,
                         packet_elems=pkt).numpy()

    def cuts(m):
        out = set()
        for row in m:
            zeros = np.flatnonzero(row == 0)
            if zeros.size:
                assert np.all(row[zeros[0]:] == 0)     # a suffix
                out.add(int(zeros[0]))
        return out
    assert cuts(jm) == cuts(tm) == {int(np.floor((1 - rate / 0.08) * 100))
                                    * pkt}


def test_burst_runs_are_clustered():
    """Gilbert-Elliott: mean loss run ~ BURST_MEAN_PKTS packets."""
    m = drops.burst_mask(generator((1,)), 8, 64 * 20_000, rate=0.05,
                         packet_elems=64).numpy()
    pk = m[:, ::64]
    runs = []
    for row in pk:
        d = np.diff(np.concatenate([[1], row, [1]]))
        starts, ends = np.flatnonzero(d == -1), np.flatnonzero(d == 1)
        runs.extend(ends - starts)
    assert abs(np.mean(runs) - drops.BURST_MEAN_PKTS) < 1.5
    assert abs(1 - pk.mean() - 0.05) < 0.01


def test_gilbert_elliott_params_match_reference():
    for rate in (0.0, 0.01, 0.3, 0.999):
        assert drops.gilbert_elliott_params(rate) == \
            jdrops.gilbert_elliott_params(rate)


def test_expand_matches_reference():
    pm = np.array([[1, 0, 1]], np.float32)
    want = np.asarray(jdrops._expand(pm, 7, 3))
    got = drops._expand(torch.from_numpy(pm), 7, 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_zero_rate_keeps_everything():
    m = drops.make_mask("tail", generator((0,)), 4, 100, rate=0.0)
    assert bool((m == 1).all())
