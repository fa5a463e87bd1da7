"""The port's time-to-accuracy harness (``repro_torch.sim.tta``) and momentum
SGD against the reference's, on the CPU, single-process.

The reference draws through ``jax.random``; the port's keys are integer
tuples (``core/keys.py``). A tuple key maps onto a JAX key by folding each
element into ``PRNGKey(first)``, so :class:`JaxDraws` hands the port the
reference's own ``rademacher_sign``, ``uniform`` and ``make_mask`` results
on the same key path (TernGrad's ``bernoulli(p)`` is ``uniform < p``).

Tolerances, and why:

* ``_flatten``: the same leaves in the same order: exact.
* Momentum SGD: ``0.9 m + g`` then ``p - lr m`` in fp32; XLA may contract
  each into one FMA where the port rounds twice, so fp32 values agree to
  3e-7 (about 2 ulp) of the leaf's largest value, which bounds the
  operands of the subtraction, and bf16 parameters to one bf16 ulp (2^-8)
  of it, where that fp32 ulp meets a bf16 rounding boundary.
* Top-K, TernGrad and the reliable mean: the same operations in the same
  order, a worker mean of 4 values: within 1e-7 of the values' scale.
* Paths with the Hadamard rotation: the port rotates with the butterfly,
  the reference with Kronecker matmuls (~1e-7 apart): within 1e-5 of the
  values' scale. Drop fractions are counts of the same masks: equal.
* THC: codes may differ by one where a floor sits on a boundary (see
  ``test_torch_compression.py``), and each such code moves its block by one
  grid step / (N sqrt(block)): held to that bound, with the flips counted
  against the reference's own per-worker codes.
* One ``ReplicaRun`` step on ``gpt2-smoke``: each worker's fp32 gradient
  within 2e-5 of the reference's (fp32 sums in other orders, as in
  ``test_torch_model.py``); from the buckets the port's collective produced,
  every replica's parameters and momentum after the step within the
  momentum-SGD tolerance above, for fp32 and bf16 parameters.
* ``run_training`` over 3 ``gpt2-smoke`` steps from the reference's
  initial parameters and draws: the drop fractions are equal, the
  accuracy (256 eval tokens) equal, the replica divergence within 1e-4
  relative for tail drops (fp32 gradients summed in other orders) and 0 on
  the port where every replica gets the same bucket (lossless, THC), where
  the reference's fp32 std of equal values is within 1e-9 of 0. For THC the
  accuracy may move by one eval token per flipped code; none flipped here.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import drops as jdrops  # noqa: E402
from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import SINGLE  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.optim.optimizers import OptimizerConfig as JOptCfg  # noqa: E402
from repro.optim.optimizers import make_optimizer as jmake_opt  # noqa: E402
from repro.optim.optimizers import momentum_sgd as jmomentum  # noqa: E402
from repro.sim import tta as jtta  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core.keys import fold_in  # noqa: E402
from repro_torch.optim.optimizers import (OptimizerConfig,  # noqa: E402
                                          make_optimizer, momentum_sgd)
from repro_torch.sim import tta  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

EXACT_TOL = 1e-7
ROT_TOL = 1e-5
GRAD_TOL = 2e-5
N = 4


def jkey(k):
    out = jax.random.PRNGKey(k[0])
    for d in k[1:]:
        out = jax.random.fold_in(out, d)
    return out


def _np(x):
    return np.array(x)


class JaxDraws:
    """The reference's draws on the port's key path, as CPU tensors."""

    def sign(self, k, block):
        return torch.from_numpy(_np(jsign(jkey(k), block)))

    def uniform(self, k, shape):
        return torch.from_numpy(_np(jax.random.uniform(jkey(k), shape)))

    def mask(self, k, pattern, n, elems, *, rate, self_index=None):
        si = None if self_index is None else jnp.int32(self_index)
        return torch.from_numpy(_np(jdrops.make_mask(
            pattern, jkey(k), n, elems, rate=rate, self_index=si)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke_params():
    return jinit(jax.random.PRNGKey(0), jget_smoke("gpt2-paper"))


# ---------------------------------------------------------------- layout
def test_flatten_reproduces_reference_layout(smoke_params):
    jflat, _ = jtta._flatten(smoke_params)
    params = params_from_jax(_np_tree(smoke_params))
    flat, meta = tta._flatten(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = tta._unflatten(flat, meta)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    stacked = tta._unflatten(torch.stack([flat, 2 * flat]), meta)
    for a, b in zip(tree_leaves(stacked), tree_leaves(params)):
        assert a.shape == (2, *b.shape)
        assert torch.equal(a[1], 2 * b)


# -------------------------------------------------------------- momentum
def _tree(rng, dtype):
    def leaf(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                           dtype)
    return {"w": leaf(3, 4), "stack": [leaf(2, 3, 4), leaf(5)]}


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = (2.0 ** -8 if got.dtype == torch.bfloat16 else 3e-7) \
        * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_momentum_sgd_matches_reference(dtype):
    """Two updates: from zero momentum, then from the reference's state
    (carried across by ``params_from_jax`` as a tree of m)."""
    rng = np.random.default_rng(0)
    jdtype = jnp.dtype(dtype)
    p0 = _tree(rng, jdtype)
    g1, g2 = _tree(rng, jdtype), _tree(rng, jdtype)
    jopt = jmomentum(JOptCfg(name="momentum", lr=0.1, momentum=0.9))
    s0 = jopt.init(p0)
    p1, s1 = jopt.update(g1, s0, p0, jnp.float32(0.1), jnp.int32(0))
    p2, s2 = jopt.update(g2, s1, p1, jnp.float32(0.1), jnp.int32(1))
    opt = make_optimizer(OptimizerConfig(name="momentum", lr=0.1))
    params = params_from_jax(_np_tree(p0))
    state = opt.init(params)
    assert all(m.dtype == torch.float32 and not m.any()
               for m in tree_leaves(state))
    got_p, got_s = opt.update(params_from_jax(_np_tree(g1)), state, params,
                              0.1, 0)
    for want, got in ((p1, got_p), (s1, got_s)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32 or str(a.dtype).endswith(dtype)
            _close(a, b)
    params, state = params_from_jax(_np_tree(p1), _np_tree(s1))
    assert isinstance(state, dict)
    got_p, got_s = momentum_sgd(OptimizerConfig(lr=0.1)).update(
        params_from_jax(_np_tree(g2)), state, params, 0.1, 1)
    for want, got in ((p2, got_p), (s2, got_s)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            _close(a, b)


def test_adafactor_is_not_ported():
    with pytest.raises(NotImplementedError, match="A10"):
        make_optimizer(OptimizerConfig(name="adafactor"))


# ------------------------------------------------------------- _aggregate
LENGTH = 3000          # pads to 3072 = 4 workers x 3 blocks of 256
BLOCK = 256
SKEY = (0, 5)


def _flats(seed=0, scale=1e-2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, LENGTH)) * scale).astype(np.float32)


def _rc(**kw):
    return tta.TrainRunConfig(n_workers=N, hadamard_block=BLOCK, **kw)


def _jrc(rc):
    return jtta.TrainRunConfig(**{f: getattr(rc, f) for f in
                                  rc.__dataclass_fields__})


def test_aggregate_topk_matches_reference():
    rc = _rc(compressor="topk", topk_frac=0.05)
    lp = LENGTH + (-LENGTH) % (N * BLOCK)
    jstate = {"topk": [jcomp.topk_init(lp) for _ in range(N)]}
    state = {}
    for seed in (1, 2):                 # the error memory carries over
        x = _flats(seed)
        want, _ = jtta._aggregate(jnp.asarray(x), jkey(SKEY), _jrc(rc),
                                  jstate)
        got, drop = tta._aggregate(torch.from_numpy(x), SKEY, rc, state,
                                   draws=JaxDraws())
        assert drop == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=EXACT_TOL * 1e-2, rtol=0)
        np.testing.assert_array_equal(
            state["topk"].error.numpy(),
            np.stack([np.asarray(s.error) for s in jstate["topk"]]))


def test_aggregate_terngrad_matches_reference():
    rc = _rc(compressor="terngrad")
    x = _flats(3)
    want, _ = jtta._aggregate(jnp.asarray(x), jkey(SKEY), _jrc(rc), {})
    got, _ = tta._aggregate(torch.from_numpy(x), SKEY, rc, {},
                            draws=JaxDraws())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=EXACT_TOL * 1e-2, rtol=0)
    assert got.shape == (LENGTH,)


@pytest.mark.parametrize("bits", [4, 8])
def test_aggregate_thc_matches_reference(bits):
    """The range from the padded, unrotated gradients; one sign and one
    noise for every worker."""
    rc = _rc(compressor="thc", thc_bits=bits)
    x = _flats(4 + bits)
    want, _ = jtta._aggregate(jnp.asarray(x), jkey(SKEY), _jrc(rc), {})
    draws = JaxDraws()
    got, _ = tta._aggregate(torch.from_numpy(x), SKEY, rc, {}, draws=draws)
    lp = LENGTH + (-LENGTH) % (N * BLOCK)
    g = np.pad(x, ((0, 0), (0, lp - LENGTH)))
    lohi = np.array([g.min() * np.float32(1.2) - np.float32(1e-3),
                     g.max() * np.float32(1.2) + np.float32(1e-3)],
                    np.float32)
    jcodes = sum(np.asarray(jcomp.thc_compress(
        jnp.asarray(g[i]), jkey(SKEY), jnp.asarray(lohi), bits=bits,
        block=BLOCK).codes).astype(np.int64) for i in range(N))
    # the port's summed codes, from the draws its aggregation took
    codes = comp.thc_compress(
        torch.from_numpy(g), draws.sign(SKEY, BLOCK),
        draws.uniform(fold_in(SKEY, 1), (lp // BLOCK, BLOCK)),
        torch.from_numpy(lohi), bits=bits, block=BLOCK).codes
    flips = np.abs(codes.to(torch.int64).sum(0).numpy() - jcodes)
    assert flips.sum() <= 1e-4 * N * lp
    step = (lohi[1] - lohi[0]) / ((1 << bits) - 1)
    bound = np.repeat(flips.sum(1) * step / (N * math.sqrt(BLOCK)),
                      BLOCK)[:LENGTH]
    tol = ROT_TOL * float(np.abs(lohi).max())
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound + tol)


@pytest.mark.parametrize("hadamard,compensate,rate", [
    (True, None, 0.05), (False, None, 0.05), (True, False, 0.05),
    (False, True, 0.05), (True, None, 0.0)])
def test_aggregate_single_mask_matches_reference(hadamard, compensate, rate):
    rc = _rc(drop_rate=rate, use_hadamard=hadamard, compensate=compensate)
    x = _flats(9)
    want, wdrop = jtta._aggregate(jnp.asarray(x), jkey(SKEY), _jrc(rc), {})
    got, drop = tta._aggregate(torch.from_numpy(x), SKEY, rc, {},
                               draws=JaxDraws())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ROT_TOL * 1e-2, rtol=0)
    assert drop == pytest.approx(wdrop, abs=1e-7)
    assert (drop > 0) == (rate > 0)


@pytest.mark.parametrize("hadamard,compensate,recovery", [
    (True, None, "none"), (False, None, "none"), (True, False, "none"),
    (False, True, "none"), (True, None, "stale"), (False, None, "stale"),
    (True, None, "ef"), (False, None, "ef")])
def test_aggregate_per_receiver_matches_reference(hadamard, compensate,
                                                  recovery):
    rc = _rc(drop_rate=0.05, use_hadamard=hadamard, compensate=compensate,
             recovery=recovery)
    x = _flats(11)
    stale = None
    if recovery != "none":
        stale = np.random.default_rng(12).standard_normal(LENGTH).astype(
            np.float32) * 1e-2
    want_resid = recovery == "ef"
    wout, wdrop, wext = jtta._aggregate_per_receiver(
        jnp.asarray(x), jkey(SKEY), _jrc(rc),
        stale=None if stale is None else jnp.asarray(stale),
        want_resid=want_resid)
    out, drop, ext = tta._aggregate_per_receiver(
        torch.from_numpy(x), SKEY, rc,
        stale=None if stale is None else torch.from_numpy(stale),
        want_resid=want_resid, draws=JaxDraws())
    tol = ROT_TOL * 1e-2
    assert out.shape == (N, LENGTH)
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), atol=tol,
                               rtol=0)
    assert drop == pytest.approx(wdrop, abs=1e-7) and drop > 0
    np.testing.assert_allclose(ext["stale"].numpy(), np.asarray(wext["stale"]),
                               atol=tol, rtol=0)
    if want_resid:
        np.testing.assert_allclose(ext["resid"].numpy(),
                                   np.asarray(wext["resid"]), atol=tol,
                                   rtol=0)
    else:
        assert ext["resid"] is None and wext["resid"] is None
    # receivers differ under stage-2 drops: the divergence Fig 14 measures
    assert float((out[0] - out[1]).abs().max()) > 0


def test_aggregate_per_receiver_without_drops_is_the_mean():
    rc = _rc(drop_rate=0.0, recovery="ef")
    x = torch.from_numpy(_flats(13))
    out, drop, ext = tta._aggregate_per_receiver(x, SKEY, rc, want_resid=True,
                                                 draws=JaxDraws())
    assert drop == 0.0 and not ext["resid"].any()
    for i in range(N):
        np.testing.assert_allclose(out[i].numpy(), x.mean(0).numpy(),
                                   atol=EXACT_TOL * 1e-2, rtol=0)


def test_unknown_modes_raise():
    with pytest.raises(ValueError, match="recovery"):
        tta.ReplicaRun(_rc(recovery="magic"), device="cpu")
    with pytest.raises(ValueError, match="TAR path"):
        tta.ReplicaRun(_rc(recovery="ef", compressor="thc"), device="cpu")
    with pytest.raises(ValueError, match="compressor"):
        tta._aggregate(torch.zeros(N, 8), SKEY, _rc(compressor="zip"), {},
                       draws=JaxDraws())


# ------------------------------------------------------------ run_training
RUNS = {"lossless": {}, "tail": {"drop_rate": 0.05},
        "thc": {"compressor": "thc"}}


def _run_rc(name, cls):
    return cls(n_workers=N, seq_len=16, steps=3, eval_every=1, lr=0.1,
               **RUNS[name])


@pytest.fixture(scope="module")
def reference_runs():
    return {name: jtta.run_training(_run_rc(name, jtta.TrainRunConfig))
            for name in RUNS}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_training_matches_reference(name, reference_runs, smoke_params):
    want = reference_runs[name]
    got = tta.run_training(_run_rc(name, tta.TrainRunConfig), device="cpu",
                           params=params_from_jax(_np_tree(smoke_params)),
                           draws=JaxDraws())
    assert got["steps"] == want["steps"] == [0, 1, 2]
    assert len(got["step_s"]) == 3
    np.testing.assert_allclose(got["drops"], want["drops"], atol=1e-7)
    assert got["mean_drop"] == pytest.approx(want["mean_drop"], abs=1e-7)
    assert got["acc"] == want["acc"]
    assert got["acc"][-1] > got["acc"][0]          # it learns
    if name == "tail":
        assert min(want["divergence"]) > 0
        np.testing.assert_allclose(got["divergence"], want["divergence"],
                                   rtol=1e-4)
    else:
        assert got["divergence"] == [0.0] * 3
        np.testing.assert_allclose(want["divergence"], 0.0, atol=1e-9)
    assert tta.steps_to_accuracy(got, got["acc"][-1]) == \
        jtta.steps_to_accuracy(want, want["acc"][-1])


def _reference_worker_grads(jparams, batch, rc, jcfg):
    """The reference's per-worker gradients as its ``run_training`` takes
    them (``jax.vmap`` of ``jax.grad`` of ``lm_loss``, each worker on its
    rows of the global batch), flattened in tree order: (N, L)."""
    n, b = rc.n_workers, rc.per_worker_batch

    def per_worker(p, tok, lab):
        return jax.grad(lambda pp: jlm_loss(
            pp, {"tokens": tok, "labels": lab}, jcfg, SINGLE,
            key=jax.random.PRNGKey(0), seq_chunk=rc.seq_len))(p)
    ps = jax.tree.map(lambda p: jnp.stack([p] * n), jparams)
    tok = jnp.asarray(batch["tokens"]).reshape(n, b, -1)
    lab = jnp.asarray(batch["labels"]).reshape(n, b, -1)
    gtree = jax.vmap(per_worker)(ps, tok, lab)
    return np.asarray(jax.vmap(lambda t: jtta._flatten(t)[0])(gtree))


def _reference_update(jparams, buckets, rc):
    """The reference's ``apply_updates`` from a fresh optimizer state: each
    replica's bucket unflattened, cast to its parameters' dtype, one
    update. Returns (params, optimizer state), stacked over replicas."""
    n = rc.n_workers
    _, meta = jtta._flatten(jparams)
    opt = jmake_opt(JOptCfg(name=rc.optimizer, lr=rc.lr, weight_decay=0.0))
    ps = jax.tree.map(lambda p: jnp.stack([p] * n), jparams)

    def one(p, o, gflat):
        g = jtta._unflatten(gflat, meta)
        g = jax.tree.map(lambda gg, pp: gg.astype(pp.dtype), g, p)
        return opt.update(g, o, p, jnp.float32(rc.lr), jnp.asarray(0))
    return jax.vmap(one)(ps, jax.vmap(opt.init)(ps), jnp.asarray(buckets))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RUNS))
def test_replica_step_matches_reference(name, dtype, smoke_params):
    """One :class:`ReplicaRun` step taken apart: each worker's gradient on
    its rows of the reference's batch (fp32 parameters), then every
    replica's parameters and momentum after the step against the
    reference's update on the buckets the port's collective produced, so
    the worker-to-rows map, the unflatten order and the cast to the
    parameters' dtype are each held to the reference."""
    rc = _run_rc(name, tta.TrainRunConfig)
    jcfg = jget_smoke(rc.arch)
    jparams = jax.tree.map(lambda p: p.astype(dtype), smoke_params)
    cfg = dataclasses.replace(get_smoke(rc.arch),
                              param_dtype=getattr(torch, dtype))
    run = tta.ReplicaRun(rc, device="cpu", cfg=cfg,
                         params=params_from_jax(_np_tree(jparams)),
                         draws=JaxDraws())
    batch = JSyntheticLM(JDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=rc.seq_len,
        global_batch=N * rc.per_worker_batch, seed=rc.seed,
        markov_weight=rc.markov_weight, n_succ=rc.n_succ)).global_batch(0)
    np.testing.assert_array_equal(run.data.global_batch(0)["tokens"],
                                  batch["tokens"])
    flats = run.worker_flats(batch)
    if dtype == "float32":
        np.testing.assert_allclose(
            flats.numpy(), _reference_worker_grads(jparams, batch, rc, jcfg),
            atol=GRAD_TOL, rtol=0)
    skey = fold_in(run.key, 0)
    if rc.compressor is not None:
        buckets = tta._aggregate(flats, skey, rc, {}, draws=run.draws)[0] \
            .expand(N, -1)
    else:
        buckets = tta._aggregate_per_receiver(flats, skey, rc,
                                              draws=run.draws)[0]
    run.step(0)
    want_p, want_s = _reference_update(jparams, buckets.numpy(), rc)
    for got, want in ((run.params, want_p), (run.opt_state, want_s)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
            assert a.shape == b.shape
            _close(a, b)
    assert all(p.dtype == getattr(torch, dtype)
               for p in tree_leaves(run.params))


def test_default_parameters_and_draws_are_the_ports_own():
    """Without injected parameters and draws the run is the port's: its
    own init from the seed's key and torch generators, deterministic."""
    rc = tta.TrainRunConfig(n_workers=2, per_worker_batch=2, seq_len=8,
                            steps=2, compressor="thc", hadamard_block=256)
    a = tta.run_training(rc, device="cpu")
    b = tta.run_training(rc, device="cpu")
    assert a["acc"] == b["acc"] and a["divergence"] == [0.0, 0.0]
    run = tta.ReplicaRun(rc, device="cpu")
    assert all(p.shape[0] == 2 for p in tree_leaves(run.params))
    assert all(torch.equal(p[0], p[1]) for p in tree_leaves(run.params))
    assert tree_map(lambda m: m.dtype, run.opt_state)["embed"] == \
        torch.float32
