"""The round schedules, rings and participation policies of the port
(``core/tar.py``, ``core/ring.py``, ``collectives.ppermute``) against the
JAX package's functions on the same inputs.

The pure policies (``shard_plan``, ``weighted_rows`` / ``weighted_flat``,
``ring_order``, ``relay_via``) run in-process, on the property cases of
``tests/test_weighted_schedule.py``, as equal outputs. The collectives run
once for the file in a subprocess on 8 forced host devices (4 and 6 of
them where a case needs that peer count), the reference's functions under
``shard_map``; the port runs the same inputs as ``(P, ...)`` stacks.

Tolerances: bitwise everywhere (copies, fp32 adds in the reference's
order, and divisions by the peer count rounded as XLA rounds a division by
a constant, a multiply by the fp32 reciprocal), except the plain-mean
fall-backs at a peer count that is not a power of 2, where the reference's
all-reduce may sum in another order: within 1 ulp (``ULP_CASES``).

Permute counts: the port counts ``collectives.ppermute`` calls; the
reference's ``collective_permute`` sites in the lowered HLO of one stage-1
exchange + stage-2 broadcast at incast 1 are 14 (8 peers), 11 (6 active:
2(6-1) rounds + 1 graft) and 18 (one dead link: a 2-hop relay in each
stage), and the port must count the same.
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

try:  # noqa: E402
    from hypothesis import given, strategies as st
except ImportError:
    from _hypothesis_fallback import given, strategies as st

from repro.core import tar as jtar  # noqa: E402
from repro_torch.core import collectives, ring, tar  # noqa: E402

N = 8
S = 512
INCAST = 3
ACTIVE = (0, 1, 2, 4, 5, 7)
DEAD = ((2, 5),)
WEIGHTS = (2,) * 7 + (1,)
UNIT = 64
ULP_CASES = {"tree/6", "bcube/b4_n6"}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core import ring as ring_lib
from repro.core import tar as tar_lib

out_path = sys.argv[1]
N, S, INCAST = 8, 512, 3
ACTIVE = (0, 1, 2, 4, 5, 7)
DEAD = ((2, 5),)
WEIGHTS = (2,) * 7 + (1,)
UNIT = 64
rng = np.random.default_rng(0)
save = {}

def normal(*shape):
    return rng.standard_normal(shape).astype(np.float32)

def sharded(fn, n, nargs):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    body = lambda *a: fn(*(x[0] for x in a))[None]
    return jax.jit(shard_map(body, mesh=mesh,
                             in_specs=tuple(P("data") for _ in range(nargs)),
                             out_specs=P("data"), check_vma=False))

def run(name, fn, *args, n=N):
    for i, a in enumerate(args):
        save[f"{name}/in{i}"] = a
    save[name] = np.asarray(sharded(fn, n, len(args))(*map(jnp.asarray, args)))

A = len(ACTIVE)
run("exchange/full", lambda s: tar_lib.tar_exchange_rounds(
    s, "data", incast=INCAST), normal(N, N, S))
run("exchange/active", lambda s: tar_lib.tar_exchange_rounds(
    s, "data", incast=INCAST, active=ACTIVE), normal(N, A, S))
run("exchange/dead", lambda s: tar_lib.tar_exchange_rounds(
    s, "data", incast=INCAST, dead_links=DEAD), normal(N, N, S))
run("broadcast/full", lambda o: tar_lib.tar_broadcast_rounds(
    o, "data", incast=INCAST), normal(N, S))
run("broadcast/active", lambda o: tar_lib.tar_broadcast_rounds(
    o, "data", incast=INCAST, active=ACTIVE), normal(N, S))
run("broadcast/dead", lambda o: tar_lib.tar_broadcast_rounds(
    o, "data", incast=INCAST, dead_links=DEAD), normal(N, S))
plan = tar_lib.shard_plan(sum(WEIGHTS) * UNIT, WEIGHTS)
run("broadcast/weighted", lambda o: tar_lib.tar_broadcast_rounds(
    o, "data", incast=INCAST, plan=plan), normal(N, plan.s_max))
run("graft", lambda f: tar_lib.graft_inactive(f, "data", ACTIVE),
    normal(N, N * S))
run("allreduce_rounds/plain", lambda x: tar_lib.tar_allreduce_rounds(
    x, "data", incast=INCAST), normal(N, N * S))
mask = (rng.random((N, N, S)) < 0.8).astype(np.float32)
run("allreduce_rounds/masked", lambda x, m: tar_lib.tar_allreduce_rounds(
    x, "data", incast=INCAST, mask=m), normal(N, N * S), mask)
run("ring/plain", lambda x: ring_lib.ring_allreduce(x, "data"),
    normal(N, N * S))
hops = (rng.random((N, 2 * N - 2, S)) < 0.9).astype(np.float32)
run("ring/hop_masks", lambda x, h: ring_lib.ring_allreduce(
    x, "data", hop_masks=h), normal(N, N * S), hops)
run("ring/active", lambda x: ring_lib.ring_allreduce(
    x, "data", active=ACTIVE), normal(N, A * S))
run("ring/weighted", lambda x: ring_lib.ring_allreduce(
    x, "data", weights=WEIGHTS), normal(N, sum(WEIGHTS) * UNIT))
wa = (2, 2, 2, 2, 2, 1)
run("ring/active_weighted", lambda x: ring_lib.ring_allreduce(
    x, "data", active=ACTIVE, weights=wa), normal(N, sum(wa) * UNIT))
for n in (8, 4, 6):
    run(f"tree/{n}", lambda x: ring_lib.tree_allreduce(x, "data"),
        normal(n, n * S), n=n)
for name, base, n in (("b2_n8", 2, 8), ("b4_n8", 4, 8), ("b4_n4", 4, 4),
                      ("b2_n4", 2, 4), ("b4_n6", 4, 6)):
    run(f"bcube/{name}", lambda x, base=base: ring_lib.bcube_allreduce(
        x, "data", base=base), normal(n, n * S), n=n)

# collective_permute sites of one exchange + mean + broadcast, incast 1
def schedule(active=None, dead=()):
    def fn(x):
        n_shards = N if active is None else len(active)
        got = tar_lib.tar_exchange_rounds(x.reshape(n_shards, -1), "data",
                                          active=active, dead_links=dead)
        out = tar_lib.tar_broadcast_rounds(jnp.mean(got, axis=0), "data",
                                           active=active, dead_links=dead)
        if active is not None:
            out = tar_lib.graft_inactive(out, "data", active)
        return out
    return fn
for name, kw in (("full", {}), ("active", {"active": ACTIVE}),
                 ("dead", {"dead": DEAD})):
    x = jnp.zeros((N, len(kw.get("active", range(N))) * S), jnp.float32)
    text = sharded(schedule(**kw), N, 1).lower(x).as_text()
    save[f"permutes/{name}"] = np.asarray(
        text.count("stablehlo.collective_permute"))
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_rounds") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _t(ref, name, i=0):
    return torch.from_numpy(ref[f"{name}/in{i}"])


def _check(name, got, want):
    got = got.numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if name in ULP_CASES:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


# ----------------------------------------------- the pure policies, in-process
def _weights(seed: int, n: int, lo: int = 1, hi: int = 5) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(int(w) for w in rng.integers(lo, hi + 1, size=n))


@given(st.integers(1, 9000), st.integers(2, 8), st.integers(1, 64),
       st.integers(0, 10_000))
def test_shard_plan_matches_reference(length, n, block, seed):
    w = _weights(seed, n)
    assert tar.shard_plan(length, w, block) == \
        tuple(jtar.shard_plan(length, w, block))


@given(st.integers(1, 5000), st.integers(2, 7), st.integers(0, 10_000))
def test_weighted_rows_and_flat_match_reference(length, n, seed):
    plan = tar.shard_plan(length, _weights(seed, n), block=4)
    x = np.random.default_rng(seed).normal(size=plan.padded) \
        .astype(np.float32)
    rows = tar.weighted_rows(torch.from_numpy(x), plan)
    want = np.asarray(jtar.weighted_rows(x, plan))
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(tar.weighted_flat(rows, plan).numpy(),
                                  np.asarray(jtar.weighted_flat(want, plan)))
    # a stack of peers rides along as a leading axis
    two = tar.weighted_rows(torch.from_numpy(np.stack([x, -x])), plan)
    assert torch.equal(two[1], -rows)


def test_weighted_plan_rejects_bad_weights():
    for bad in ((), (2, 0, 1)):
        with pytest.raises(ValueError):
            tar.shard_plan(100, bad)


@given(st.integers(3, 8), st.integers(0, 10_000))
def test_ring_order_matches_reference(n, seed):
    rng = np.random.default_rng(seed)
    active = tuple(range(n))
    dead = tuple(sorted({(int(i), int((i + 1) % n)) for i in rng.choice(
        n, size=min(2, n - 2), replace=False)}))
    assert tar.ring_order(active, dead) == jtar.ring_order(active, dead)
    assert tar.ring_order(active, ()) == active
    sub = (1, 3, 4, 6)
    assert tar.ring_order(sub, ((3, 4),)) == jtar.ring_order(sub, ((3, 4),))


def test_ring_order_raises_when_isolated():
    dead = tuple((0, j) for j in range(1, 4))
    with pytest.raises(ValueError):
        tar.ring_order((0, 1, 2, 3), dead)


@given(st.integers(3, 8), st.integers(0, 10_000))
def test_relay_via_matches_reference(n, seed):
    rng = np.random.default_rng(seed)
    src, dst = (int(x) for x in rng.choice(n, size=2, replace=False))
    def outcome(fn, dead):
        try:
            return fn(src, dst, tuple(range(n)), dead)
        except ValueError:
            return "isolated"

    for dead in (((src, dst),), ((src, dst), (src, (dst + 1) % n))):
        assert outcome(tar.relay_via, dead) == outcome(jtar.relay_via, dead)
    with pytest.raises(ValueError):
        tar.relay_via(0, 1, (0, 1, 2), ((0, 1), (0, 2)))


def test_peer_lookup_and_ring_perms_match_reference():
    vpos, ind = tar.peer_lookup(ACTIVE, N)
    jv, ji = jtar.peer_lookup(ACTIVE, N)
    assert list(vpos) == np.asarray(jv).tolist()
    assert list(ind) == np.asarray(ji).tolist()
    for r in range(1, len(ACTIVE)):
        assert tar._ring_perms(ACTIVE, N)(r) == \
            jtar._ring_perms(ACTIVE, N)(r)


# ------------------------------------------- the collectives, on 8 peers
def test_ppermute_semantics():
    x = torch.arange(12, dtype=torch.float32).view(4, 3)
    before = collectives.permutes
    full = collectives.ppermute(x, [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert torch.equal(full, x[[3, 0, 1, 2]])
    part = collectives.ppermute(x, [(2, 0)])
    assert torch.equal(part[0], x[2]) and not part[1:].any()
    assert collectives.permutes == before + 2
    for bad in ([(0, 1), (2, 1)], [(0, 4)]):
        with pytest.raises(ValueError):
            collectives.ppermute(x, bad)


@pytest.mark.parametrize("case", ["full", "active", "dead"])
def test_exchange_rounds_match_reference(ref, case):
    name = f"exchange/{case}"
    kw = {"active": ACTIVE} if case == "active" else \
        {"dead_links": DEAD} if case == "dead" else {}
    _check(name, tar.tar_exchange_rounds(_t(ref, name), incast=INCAST, **kw),
           ref[name])


def test_full_exchange_is_the_transpose(ref):
    """At full participation the schedule gives all_to_all's matrix (which
    it must reach by rounds, not by a transpose)."""
    x = _t(ref, "exchange/full")
    before = collectives.permutes
    got = tar.tar_exchange_rounds(x, incast=INCAST)
    assert collectives.permutes == before + N - 1
    assert torch.equal(got, collectives.all_to_all(x))


@pytest.mark.parametrize("case", ["full", "active", "dead", "weighted"])
def test_broadcast_rounds_match_reference(ref, case):
    name = f"broadcast/{case}"
    kw = {"active": ACTIVE} if case == "active" else \
        {"dead_links": DEAD} if case == "dead" else \
        {"plan": tar.shard_plan(sum(WEIGHTS) * UNIT, WEIGHTS)} \
        if case == "weighted" else {}
    _check(name, tar.tar_broadcast_rounds(_t(ref, name), incast=INCAST,
                                          **kw), ref[name])


def test_graft_inactive_matches_reference(ref):
    _check("graft", tar.graft_inactive(_t(ref, "graft"), ACTIVE),
           ref["graft"])


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_tar_allreduce_rounds_matches_reference(ref, case):
    name = f"allreduce_rounds/{case}"
    mask = _t(ref, name, 1) if case == "masked" else None
    _check(name, tar.tar_allreduce_rounds(_t(ref, name), incast=INCAST,
                                          mask=mask), ref[name])


@pytest.mark.parametrize("case", ["plain", "hop_masks", "active", "weighted",
                                  "active_weighted"])
def test_ring_allreduce_matches_reference(ref, case):
    name = f"ring/{case}"
    kw = {"plain": {}, "active": {"active": ACTIVE},
          "weighted": {"weights": WEIGHTS},
          "active_weighted": {"active": ACTIVE,
                              "weights": (2, 2, 2, 2, 2, 1)}}.get(case)
    if case == "hop_masks":
        kw = {"hop_masks": _t(ref, name, 1)}
    _check(name, ring.ring_allreduce(_t(ref, name), **kw), ref[name])


@pytest.mark.parametrize("n", [8, 4, 6])
def test_tree_allreduce_matches_reference(ref, n):
    name = f"tree/{n}"
    _check(name, ring.tree_allreduce(_t(ref, name)), ref[name])
    if n & (n - 1):                 # the fall-back is the plain mean
        assert torch.equal(ring.tree_allreduce(_t(ref, name)),
                           ring.psum_mean(_t(ref, name)))


@pytest.mark.parametrize("case,base", [("b2_n8", 2), ("b4_n8", 4),
                                       ("b4_n4", 4), ("b2_n4", 2),
                                       ("b4_n6", 4)])
def test_bcube_allreduce_matches_reference(ref, case, base):
    name = f"bcube/{case}"
    _check(name, ring.bcube_allreduce(_t(ref, name), base=base), ref[name])


@pytest.mark.parametrize("case,want", [("full", 14), ("active", 11),
                                       ("dead", 18)])
def test_permute_counts_match_reference_hlo(ref, case, want):
    assert int(ref[f"permutes/{case}"]) == want
    active = ACTIVE if case == "active" else None
    dead = DEAD if case == "dead" else ()
    n_shards = N if active is None else len(active)
    x = torch.zeros((N, n_shards, S))
    before = collectives.permutes
    got = tar.tar_exchange_rounds(x, active=active, dead_links=dead)
    out = tar.tar_broadcast_rounds(got.mean(dim=1), active=active,
                                   dead_links=dead)
    if active is not None:
        tar.graft_inactive(out, active)
    assert collectives.permutes - before == want


@pytest.mark.parametrize("incast,groups", [(1, 7), (2, 4), (3, 3), (7, 1),
                                           (9, 1)])
def test_incast_groups_the_rounds(incast, groups):
    """ceil((N-1)/I) groups a stage; the values do not depend on I."""
    x = torch.randn((N, N, 16), generator=torch.Generator().manual_seed(1))
    before = tar.round_groups
    got = tar.tar_exchange_rounds(x, incast=incast)
    assert tar.round_groups - before == groups
    assert torch.equal(got, tar.tar_exchange_rounds(x, incast=1))
