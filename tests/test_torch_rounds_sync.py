"""``sync_packed`` of the seven strategies this slice adds (``gloo_ring``,
``nccl_tree``, ``bcube``, ``tar_rounds``, ``optireduce_rounds``,
``tar_rounds_q``, ``ring_ht``) and of the participation policies
(``active_peers``, ``shard_weights``, ``dead_links``) against the JAX
package's ``sync_packed``, with the reference's draws injected.

The reference runs once for the file in a subprocess on 8 forced host
devices, each strategy at the knobs of ``tests/test_pipeline_parity.py``
(drop rate, blocks of 256, 8-bit codes, incast 3), on its jnp path (the
reference's own bit-parity oracle of its kernels, and what its launcher
runs), in ``scan`` mode (the reference pins ``pipelined`` to ``scan``
bitwise itself); the port runs both modes. The child also records the
draws the reference takes: each bucket's sign, each receiver's arrival
mask (drawn under the receiver's id, with the row it never drops at its
virtual position when a degraded round schedule renumbers the rows) and
both quantizer noises.

Tolerances:

* Identity codecs: bitwise where the schedule fixes the order of the adds
  (``gloo_ring``, ``nccl_tree``). Where the result is a plain mean of N
  rows, XLA's reduction may sum them in another order than the port's
  (``tar_rounds``' shard mean; ``bcube`` at 8 peers, which takes base 4,
  falls back to the plain mean since 8 is not a power of 4): within (N-1)
  2^-23 max|x|, the bound on two orders of a mean of N fp32 terms.
* Rotations (``optireduce*``, ``ring_ht``): 1e-5 absolute, the butterfly
  against the reference's Kronecker matmuls (as ``tests/test_torch_step.py``).
* ``tar_rounds_q``: as ``tests/test_torch_quant_sync.py``, a code whose
  floor sits on a boundary may differ by one; it moves its Hadamard block
  by at most one grid step / sqrt(block). So every block is within 1e-5,
  except at most 1e-4 of the codes + 2 blocks, and those within 1e-5 + two
  grid steps / sqrt(block).
* loss_frac: the same masks, 1e-7.

Semantics, on the port alone, where the reference pins bits: a full active
set with uniform weights and no dead link is the default trace bitwise;
every replica, ejected peers included, holds the same bits under degraded
participation, with and without drops; weighted shards equal uniform ones
at drop 0; a dead link equals none under drops. The degraded result is the
mean over the active peers (1e-4 relative, 5e-2 quantized, the reference's
bounds).
"""
import dataclasses
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
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed  # noqa: E402
from repro_torch.core.hadamard import ht_encode  # noqa: E402
from repro_torch.core.keys import key as tkey  # noqa: E402
from repro_torch.core.pipeline import (ThreefryDraws, SyncContext,  # noqa: E402
                                       strategy_names)
from repro_torch.core.tar import pad_for_tar  # noqa: E402

N = 8
BUCKETS = 3
E = 3000
BLOCK = 256
ROT_TOL = 1e-5
FLIP_RATE = 1e-4
ACTIVE = (0, 1, 2, 4, 5, 7)
DEAD = ((2, 5),)
WEIGHTS = (2,) * 7 + (1,)
ACTIVE_WEIGHTS = (2, 2, 2, 2, 2, 1)
KNOBS = {"gloo_ring": 0.0, "nccl_tree": 0.0, "bcube": 0.0, "tar_rounds": 0.0,
         "optireduce_rounds": 0.1, "tar_rounds_q": 0.05, "ring_ht": 0.0}
# name -> (strategy, drop rate, policy fields)
CASES = {s: (s, rate, {}) for s, rate in KNOBS.items()}
for _s in ("optireduce", "optireduce_rounds", "ring_ht", "tar_rounds_q"):
    CASES[f"degraded/{_s}"] = (_s, 0.0, {"active_peers": ACTIVE})
for _s, _rate in (("optireduce", 0.1), ("optireduce_rounds", 0.1),
                  ("tar_rounds_q", 0.05)):
    CASES[f"degraded_drops/{_s}"] = (_s, _rate, {"active_peers": ACTIVE})
for _s in ("tar_rounds", "optireduce_rounds"):
    CASES[f"weighted/{_s}"] = (_s, 0.0, {"shard_weights": WEIGHTS})
CASES["weighted_degraded/optireduce_rounds"] = (
    "optireduce_rounds", 0.0, {"active_peers": ACTIVE,
                               "shard_weights": ACTIVE_WEIGHTS})
CASES["dead/optireduce_rounds"] = ("optireduce_rounds", 0.1,
                                   {"dead_links": DEAD})
CASES["weighted_drops/optireduce_rounds"] = (
    "optireduce_rounds", 0.1, {"shard_weights": WEIGHTS})
CASES["weighted_dead/optireduce_rounds"] = (
    "optireduce_rounds", 0.1, {"shard_weights": WEIGHTS, "dead_links": DEAD})

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
from repro.core import tar as tar_lib
from repro.core.allreduce import OptiReduceConfig, SyncContext, sync_packed
from repro.core.bucket_plan import bucket_keys
from repro.core.hadamard import rademacher_sign
from repro.core.pipeline import HTQuant, TarTopology, resolve_spec

out_path, cases = sys.argv[1], eval(sys.argv[2])
n, B, E, block = 8, 3, 3000, 256
mesh = make_mesh((n,), ("data",))
rng = np.random.default_rng(0)
arena = (rng.standard_normal((n, B, E)) * 0.1).astype(np.float32)
save = {"arena": arena}
key = jax.random.PRNGKey(11)
bkeys = bucket_keys(key, B)
save["sign"] = np.stack([np.asarray(rademacher_sign(bkeys[b], block))
                         for b in range(B)])

def draws(name, cfg):
    # the masks and noises the reference draws for this geometry
    spec = resolve_spec(cfg)
    topo = spec.topology
    if not isinstance(topo, TarTopology):
        return
    active, n_shards, weights, _ = topo._participation(cfg, n)
    if weights is not None:
        plan = tar_lib.shard_plan(E, weights, block)
        length, s = plan.padded, plan.s_max
    else:
        length = E + (-E) % (n_shards * block)
        s = length // n_shards
    own = list(range(n))
    if topo.schedule == "rounds" and active is not None:
        vpos, _ = tar_lib.peer_lookup(active, n)
        own = [int(v) for v in np.asarray(vpos)]
    save[name + "/self"] = np.asarray(own)
    if cfg.drop_rate > 0:
        save[name + "/mask"] = np.stack([np.stack([np.asarray(
            drops.make_mask(cfg.drop_pattern, jax.random.fold_in(bkeys[b], r),
                            n_shards, s, rate=cfg.drop_rate,
                            packet_elems=cfg.packet_elems,
                            self_index=own[r])) for r in range(n)])
            for b in range(B)]).astype(np.uint8)
    if isinstance(spec.codec, HTQuant):
        for salt, rows in ((3, length // block), (4, s // block)):
            save[f"{name}/noise{salt}"] = np.stack([np.asarray(
                jax.random.uniform(jax.random.fold_in(bkeys[b], salt),
                                   (rows, block))) for b in range(B)])

for name, (strategy, rate, policy) in cases.items():
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                           hadamard_block=block, quant_bits=8, incast=3,
                           **policy)
    def body(batch, cfg=cfg):
        ctx = SyncContext(cfg=cfg, key=key)
        return sync_packed(batch[0], ctx, mode="scan")[None], \
            ctx.loss_fraction()
    g = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data", None, None),
                          out_specs=(P("data", None, None), P()),
                          check_vma=False))
    synced, frac = g(jnp.asarray(arena))
    save[name] = np.asarray(synced)
    save[name + "/loss_frac"] = np.asarray(frac)
    draws(name, cfg)
np.savez(out_path, **save)
print("child OK")
"""


class RecordedDraws:
    """Serves the reference's recorded draws of one case, and checks that
    the port asks for each receiver's mask at the row the reference never
    drops."""

    def __init__(self, ref, case):
        self._sign = torch.from_numpy(ref["sign"])
        self._self = ref.get(f"{case}/self")
        mask = ref.get(f"{case}/mask")
        self._mask = None if mask is None else torch.from_numpy(
            mask.astype(np.float32))
        self._noise = {salt: torch.from_numpy(ref[f"{case}/noise{salt}"])
                       for salt in (3, 4) if f"{case}/noise{salt}" in ref}

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s, self_index=None):
        got = receiver if self_index is None else self_index
        assert got == self._self[receiver], (receiver, got)
        out = self._mask[bucket, receiver]
        assert tuple(out.shape) == (n, s)
        return out.clone()

    def noise(self, bucket, salt, shape):
        out = self._noise[salt][bucket]
        assert tuple(out.shape) == tuple(shape)
        return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_rounds_sync") / "ref.npz"
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


def _cfg(strategy, rate, **policy):
    return OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            hadamard_block=BLOCK, quant_bits=8, incast=3,
                            **policy)


def _run(arena, cfg, draws, mode="scan"):
    ctx = SyncContext(cfg=cfg, draws=draws)
    out = sync_packed(torch.as_tensor(arena), ctx, mode=mode)
    return out, float(ctx.loss_fraction())


def _own_draws(cfg):
    return ThreefryDraws(key=tkey(3), cfg=cfg, device=torch.device("cpu"))


def _grid_steps(arena, sign, length):
    """Each bucket's per-block grid step, ``(B, length / BLOCK)``, from the
    port's own rotation (the grids both sides share agree to ~1e-7)."""
    steps = []
    for b in range(BUCKETS):
        x, _ = pad_for_tar(torch.from_numpy(arena[:, b]), 1, length)
        rot = ht_encode(x, torch.from_numpy(sign[b]), block=BLOCK)
        amax = rot.abs().view(N, -1, BLOCK).amax(dim=(0, 2))
        steps.append(2.0 * amax.clamp(min=1e-12) / 255)
    return torch.stack(steps).numpy()


def _assert_matches(ref, case, got):
    strategy = CASES[case][0]
    want = ref[case]
    got = got.numpy()
    assert got.shape == want.shape == (N, BUCKETS, E)
    if strategy in ("bcube", "tar_rounds"):
        tol = (N - 1) * 2.0 ** -23 * np.abs(ref["arena"]).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        return
    if strategy in ("gloo_ring", "nccl_tree"):
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got - want)
    if strategy != "tar_rounds_q":
        assert float(err.max()) <= ROT_TOL, float(err.max())
        return
    length = 8 * BLOCK * -(-E // (8 * BLOCK))       # padded for 8 or 6
    err_blocks = np.pad(err, ((0, 0), (0, 0), (0, length - E))).reshape(
        N, BUCKETS, -1, BLOCK).max(axis=3)
    steps = _grid_steps(ref["arena"], ref["sign"], length)
    off = err_blocks > ROT_TOL
    assert int(off.sum()) <= FLIP_RATE * N * BUCKETS * length + 2
    bound = ROT_TOL + 2 * steps[None] / np.sqrt(BLOCK)
    assert np.all(err_blocks <= bound[..., :err_blocks.shape[-1]])


@pytest.mark.parametrize("mode", ["scan", "pipelined"])
@pytest.mark.parametrize("case", list(CASES))
def test_sync_packed_matches_reference(ref, case, mode):
    strategy, rate, policy = CASES[case]
    got, frac = _run(ref["arena"], _cfg(strategy, rate, **policy),
                     RecordedDraws(ref, case), mode=mode)
    _assert_matches(ref, case, got)
    assert frac == pytest.approx(float(ref[f"{case}/loss_frac"]), abs=1e-7)
    if rate > 0:
        assert frac > 0


@pytest.mark.parametrize("strategy", strategy_names())
def test_full_policy_is_the_default_trace(strategy):
    """A full active set, uniform weights and no dead link normalise away:
    the result is the default's, bitwise."""
    rate = {"optireduce": 0.1, "optireduce_q": 0.05}.get(
        strategy, KNOBS.get(strategy, 0.0))
    arena = torch.randn((N, 2, 2000), generator=torch.Generator()
                        .manual_seed(1))
    cfg = _cfg(strategy, rate)
    full = dataclasses.replace(cfg, active_peers=tuple(range(N)),
                               shard_weights=(4,) * N, dead_links=())
    a, fa = _run(arena, cfg, _own_draws(cfg))
    b, fb = _run(arena, full, _own_draws(full))
    assert torch.equal(a, b) and fa == fb


def _replicas_equal(out):
    return all(torch.equal(out[p], out[0]) for p in range(1, N))


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("degraded")])
def test_degraded_replicas_hold_the_active_mean(ref, case):
    strategy, rate, policy = CASES[case]
    out, _ = _run(ref["arena"], _cfg(strategy, rate, **policy),
                  RecordedDraws(ref, case))
    assert _replicas_equal(out)                 # ejected peers included
    if rate == 0:
        want = ref["arena"][list(ACTIVE)].mean(axis=0)
        tol = 5e-2 if strategy == "tar_rounds_q" else 1e-4
        err = np.abs(out[0].numpy() - want).max() / np.abs(want).max()
        assert err < tol, err


def test_weighted_degraded_replicas_hold_the_active_mean(ref):
    case = "weighted_degraded/optireduce_rounds"
    strategy, rate, policy = CASES[case]
    out, _ = _run(ref["arena"], _cfg(strategy, rate, **policy),
                  RecordedDraws(ref, case))
    assert _replicas_equal(out)
    want = ref["arena"][list(ACTIVE)].mean(axis=0)
    assert np.abs(out[0].numpy() - want).max() / np.abs(want).max() < 1e-4


@pytest.mark.parametrize("strategy", ["tar_rounds", "optireduce_rounds"])
def test_weighted_shards_equal_uniform_at_drop_zero(ref, strategy):
    uniform, _ = _run(ref["arena"], _cfg(strategy, 0.0),
                      RecordedDraws(ref, strategy))
    weighted, _ = _run(ref["arena"], _cfg(strategy, 0.0,
                                          shard_weights=WEIGHTS),
                       RecordedDraws(ref, f"weighted/{strategy}"))
    assert torch.equal(uniform, weighted)


def test_dead_link_equals_none_under_drops(ref):
    """The relayed round is ``direct + relayed``, so the received matrix,
    and with it the result and the masks' loss count, are unchanged."""
    draws = RecordedDraws(ref, "optireduce_rounds")
    base, fb = _run(ref["arena"], _cfg("optireduce_rounds", 0.1), draws)
    dead, fd = _run(ref["arena"], _cfg("optireduce_rounds", 0.1,
                                       dead_links=DEAD), draws)
    assert torch.equal(base, dead) and fb == fd
    wdraws = RecordedDraws(ref, "weighted_drops/optireduce_rounds")
    w, _ = _run(ref["arena"], _cfg("optireduce_rounds", 0.1,
                                   shard_weights=WEIGHTS), wdraws)
    wd, _ = _run(ref["arena"], _cfg("optireduce_rounds", 0.1,
                                    shard_weights=WEIGHTS, dead_links=DEAD),
                 wdraws)
    assert torch.equal(w, wd)


@pytest.mark.parametrize("policy,want", [
    ({}, 14), ({"active_peers": ACTIVE}, 11), ({"dead_links": DEAD}, 18)])
def test_round_schedule_permutes_a_bucket(policy, want):
    """2(N-1) permutes a bucket at 8 peers, 2(A-1) + 1 graft at 6 active,
    and 2 relay hops more in each stage for a dead link: the reference's
    HLO counts (``tests/test_pipeline_parity.py``)."""
    cfg = _cfg("optireduce_rounds", 0.1, **policy)
    arena = torch.randn((N, BUCKETS, E), generator=torch.Generator()
                        .manual_seed(2))
    before = collectives.permutes
    _run(arena, dataclasses.replace(cfg, incast=1), _own_draws(cfg))
    assert collectives.permutes - before == want * BUCKETS


@pytest.mark.parametrize("strategy,policy,match", [
    ("psum", {"active_peers": ACTIVE}, "psum"),
    ("psum", {"shard_weights": WEIGHTS}, "psum"),
    ("nccl_tree", {"active_peers": ACTIVE}, "kind='ring'"),
    ("bcube", {"dead_links": DEAD}, "kind='ring'"),
    ("optireduce", {"shard_weights": WEIGHTS}, "rounds"),
    ("tar_rounds_q", {"shard_weights": WEIGHTS}, "linear codec"),
    ("optireduce_rounds", {"shard_weights": (1, 2)}, "do not match"),
    ("optireduce_rounds", {"active_peers": (0, 9)}, "outside"),
    ("optireduce_rounds", {"dead_links": ((3, 3),)}, "outside"),
])
def test_policies_the_topology_cannot_run_raise(strategy, policy, match):
    cfg = _cfg(strategy, 0.0, **policy)
    with pytest.raises(ValueError, match=match):
        _run(torch.zeros((N, 1, 2048)), cfg, _own_draws(cfg))
