"""The pod axis: ``sync_packed`` on a ``(pod, data)`` peer grid against the
JAX package's ``sync_packed`` on a ``(pod, data)`` mesh, with the
reference's draws injected.

The reference runs once for the file in a subprocess on 8 forced host
devices: a ``(pod 2, data 4)`` mesh for ``optireduce_2d`` (the hierarchical
2D TAR of §3.1.2), ``optireduce_q``, ``optireduce_rounds``, ``tar_rounds``,
``gloo_ring`` and ``psum``, and a ``(pod 4, data 2)`` mesh for
``optireduce_2d`` and ``psum`` (the order of the pod sums at G > 2). Blocks
of 256, tail drops at 0.05 on the lossy strategies (0.2 on the 2-peer data
axis of G = 4, where 0.05 times out no receiver), ``scan`` mode; the
port runs ``scan`` and ``pipelined`` on its pod-major peer grid. The child
records the reference's draws: each bucket's sign, each data-axis
receiver's arrival mask (drawn under its data index alone, so every pod
draws the same) and both quantizer noises.

Tolerances:

* Rotations (``optireduce_2d``, ``optireduce_rounds``): 1e-5 absolute, the
  butterfly against the reference's Kronecker matmuls (as
  ``tests/test_torch_step.py``); the pod join adds one rounding of a mean.
* ``optireduce_q``: as ``tests/test_torch_rounds_sync.py``, a code whose
  floor sits on a boundary may move its block by up to two grid steps /
  sqrt(block); every other block within 1e-5.
* Identity strategies: ``gloo_ring`` bitwise (the ring fixes the order of
  its adds; a mean of two pods is one add). ``tar_rounds``' shard mean and
  ``psum``'s mean over all peers may add in another order than XLA's:
  within (P - 1) 2^-23 max|x| for P terms.
* loss_frac: the same masks, 1e-7.

On the port alone: every peer of both axes holds the same bits, with G = 1
every strategy's result and launch of collectives is the one-axis path's,
and ``optireduce_q`` is registered with the reference's pod join
(``outer='pmean'``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import collectives
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
from repro_torch.core.hadamard import ht_encode
from repro_torch.core.keys import key as tkey  # noqa: E402
from repro_torch.core.pipeline import (CollectiveSpec, ThreefryDraws,
                                       HTQuant, Lossy, SyncContext,
                                       TarTopology, resolve_spec)
from repro_torch.core.tar import pad_for_tar

BUCKETS = 2
E = 3000
BLOCK = 256
RATE = 0.05
ROT_TOL = 1e-5
FLIP_RATE = 1e-4
# case -> (strategy, drop rate, pods, data peers)
CASES = {"optireduce_2d": ("optireduce_2d", RATE, 2, 4),
         "optireduce_q": ("optireduce_q", RATE, 2, 4),
         "optireduce_rounds": ("optireduce_rounds", RATE, 2, 4),
         "tar_rounds": ("tar_rounds", 0.0, 2, 4),
         "gloo_ring": ("gloo_ring", 0.0, 2, 4),
         "psum": ("psum", 0.0, 2, 4),
         "g4/optireduce_2d": ("optireduce_2d", 0.2, 4, 2),
         "g4/psum": ("psum", 0.0, 4, 2)}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
from repro.core.pipeline import HTQuant, TarTopology, resolve_spec

out_path, cases = sys.argv[1], eval(sys.argv[2])
B, E, block = 2, 3000, 256
rng = np.random.default_rng(0)
arena = (rng.standard_normal((8, B, E)) * 0.1).astype(np.float32)
save = {"arena": arena}
key = jax.random.PRNGKey(11)
bkeys = bucket_keys(key, B)
save["sign"] = np.stack([np.asarray(rademacher_sign(bkeys[b], block))
                         for b in range(B)])
for name, (strategy, rate, g, n) in cases.items():
    mesh = make_mesh((g, n), ("pod", "data"))
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                           hadamard_block=block, pod_axis="pod", incast=2)
    def body(batch, cfg=cfg):
        ctx = SyncContext(cfg=cfg, key=key)
        return sync_packed(batch[0], ctx, mode="scan")[None], \
            ctx.loss_fraction()
    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=P(("pod", "data"), None, None),
                          out_specs=(P(("pod", "data"), None, None), P()),
                          check_vma=False))
    synced, frac = f(jnp.asarray(arena))
    save[name] = np.asarray(synced)
    save[name + "/loss_frac"] = np.asarray(frac)
    spec = resolve_spec(cfg)
    if not isinstance(spec.topology, TarTopology):
        continue
    length = E + (-E) % (n * block)
    s = length // n
    if rate > 0:
        save[name + "/mask"] = np.stack([np.stack([np.asarray(
            drops.make_mask(cfg.drop_pattern, jax.random.fold_in(bkeys[b], r),
                            n, s, rate=rate, packet_elems=cfg.packet_elems,
                            self_index=r)) for r in range(n)])
            for b in range(B)]).astype(np.uint8)
    if isinstance(spec.codec, HTQuant):
        for salt, rows in ((3, length // block), (4, s // block)):
            save[f"{name}/noise{salt}"] = np.stack([np.asarray(
                jax.random.uniform(jax.random.fold_in(bkeys[b], salt),
                                   (rows, block))) for b in range(B)])
np.savez(out_path, **save)
print("child OK")
"""


class RecordedDraws:
    """Serves the reference's recorded draws of one case; a receiver is
    asked for by its data index only."""

    def __init__(self, ref, case, n):
        self._sign = torch.from_numpy(ref["sign"])
        self._n = n
        mask = ref.get(f"{case}/mask")
        self._mask = None if mask is None else torch.from_numpy(
            mask.astype(np.float32))
        self._noise = {salt: torch.from_numpy(ref[f"{case}/noise{salt}"])
                       for salt in (3, 4) if f"{case}/noise{salt}" in ref}

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s, self_index=None):
        assert n == self._n and 0 <= receiver < n and self_index is None
        out = self._mask[bucket, receiver]
        assert tuple(out.shape) == (n, s)
        return out.clone()

    def noise(self, bucket, salt, shape):
        out = self._noise[salt][bucket]
        assert tuple(out.shape) == tuple(shape)
        return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_pod") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out),
                           repr(CASES)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _cfg(strategy, rate):
    return OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            hadamard_block=BLOCK, pod_axis="pod", incast=2)


def _run(arena, cfg, draws, pods, mode="scan", spec=None):
    ctx = SyncContext(cfg=cfg, draws=draws,
                      grid=collectives.Grid(pods=pods))
    out = sync_packed(torch.as_tensor(arena), ctx, mode=mode, spec=spec)
    return out, float(ctx.loss_fraction())


def _grid_steps(arena, sign, length):
    """Each bucket's per-block grid step over every peer of both axes."""
    steps = []
    for b in range(BUCKETS):
        x, _ = pad_for_tar(torch.from_numpy(arena[:, b]), 1, length)
        rot = ht_encode(x, torch.from_numpy(sign[b]), block=BLOCK)
        amax = rot.abs().view(arena.shape[0], -1, BLOCK).amax(dim=(0, 2))
        steps.append(2.0 * amax.clamp(min=1e-12) / 255)
    return torch.stack(steps).numpy()


def _assert_matches(ref, case, got):
    strategy, _, g, n = CASES[case]
    want = ref[case]
    got = got.numpy()
    p = g * n
    assert got.shape == want.shape == (p, BUCKETS, E)
    if strategy in ("tar_rounds", "psum"):
        tol = (p - 1) * 2.0 ** -23 * np.abs(ref["arena"]).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        return
    if strategy == "gloo_ring":
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got - want)
    if strategy != "optireduce_q":
        assert float(err.max()) <= ROT_TOL, float(err.max())
        return
    length = E + (-E) % (n * BLOCK)
    err_blocks = np.pad(err, ((0, 0), (0, 0), (0, length - E))).reshape(
        p, BUCKETS, -1, BLOCK).max(axis=3)
    steps = _grid_steps(ref["arena"], ref["sign"], length)
    off = err_blocks > ROT_TOL
    assert int(off.sum()) <= FLIP_RATE * p * BUCKETS * length + 2
    bound = ROT_TOL + 2 * steps[None] / np.sqrt(BLOCK)
    assert np.all(err_blocks <= bound)


@pytest.mark.parametrize("mode", ["scan", "pipelined"])
@pytest.mark.parametrize("case", list(CASES))
def test_sync_packed_on_the_pod_grid_matches_reference(ref, case, mode):
    strategy, rate, g, n = CASES[case]
    got, frac = _run(ref["arena"], _cfg(strategy, rate),
                     RecordedDraws(ref, case, n), g, mode=mode)
    _assert_matches(ref, case, got)
    assert frac == pytest.approx(float(ref[f"{case}/loss_frac"]), abs=1e-7)
    if rate > 0:
        assert frac > 0
    # every peer of both axes holds the same bits
    for p in range(1, g * n):
        assert torch.equal(got[p], got[0]), p


@pytest.mark.parametrize("strategy", ["optireduce_2d", "optireduce_q",
                                      "optireduce_rounds", "gloo_ring",
                                      "psum"])
def test_one_pod_is_the_one_axis_path(strategy):
    """G = 1 with a pod axis configured runs the one-axis path: the same
    bits and the same number of permutes."""
    rate = 0.0 if strategy in ("gloo_ring", "psum") else RATE
    arena = torch.randn((4, 2, 2000), generator=torch.Generator()
                        .manual_seed(2))
    cfg1 = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            hadamard_block=BLOCK)
    draws = ThreefryDraws(key=tkey(5), cfg=cfg1, device=torch.device("cpu"))
    before = collectives.permutes
    a, fa = _run(arena, cfg1, draws, 1)
    mid = collectives.permutes
    b, fb = _run(arena, _cfg(strategy, rate), draws, 1)
    assert torch.equal(a, b) and fa == fb
    assert collectives.permutes - mid == mid - before


def test_pods_draw_the_same_masks_and_hold_one_result():
    """Pods alike: a pod-replicated arena syncs on the (2, 4) grid to the
    same bits as on one pod of 4 (the pod join averages equal values)."""
    arena = torch.randn((4, 2, 2048), generator=torch.Generator()
                        .manual_seed(4))
    cfg1 = OptiReduceConfig(drop_rate=RATE, hadamard_block=BLOCK)
    draws = ThreefryDraws(key=tkey(6), cfg=cfg1, device=torch.device("cpu"))
    one, f1 = _run(arena, cfg1, draws, 1)
    two, f2 = _run(torch.cat([arena, arena]), _cfg("optireduce_2d", RATE),
                   draws, 2)
    assert torch.equal(two[:4], one) and torch.equal(two[4:], one)
    assert f1 == f2


def test_optireduce_q_joins_pods_with_a_pmean(ref):
    """``optireduce_q`` is registered as the reference registers it:
    ``TarTopology(outer='pmean')``, the dequantized values averaged over the
    pods. The TAR join over two pods is a mean of two values too, so the
    ``outer='tar'`` form of the same codec lands on the same bits here: the
    outer mode names which collective crosses the pods, not another
    result."""
    spec = resolve_spec(_cfg("optireduce_q", RATE))
    assert spec.topology == TarTopology(outer="pmean")
    draws = RecordedDraws(ref, "optireduce_q", 4)
    got, _ = _run(ref["arena"], _cfg("optireduce_q", RATE), draws, 2)
    tar_form = CollectiveSpec(TarTopology(outer="tar"), Lossy(), HTQuant())
    other, _ = _run(ref["arena"], _cfg("optireduce_q", RATE), draws, 2,
                    spec=tar_form)
    assert torch.equal(got, other)
    _assert_matches(ref, "optireduce_q", other)


def test_grid_needs_the_pod_axis():
    cfg = OptiReduceConfig(hadamard_block=BLOCK)
    with pytest.raises(ValueError, match="pod_axis"):
        SyncContext(cfg=cfg, draws=ThreefryDraws(
            key=tkey(0), cfg=cfg, device=torch.device("cpu")),
            grid=collectives.Grid(pods=2))
