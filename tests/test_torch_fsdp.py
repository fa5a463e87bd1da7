"""FSDP with OptiReduce's reduce-scatter: ``reduce_scatter_axis`` and the
``fsdp`` / ``pure_dp`` trainer against the JAX package's.

The reference runs once for the file in a subprocess on 8 forced host
devices:

* ``reduce_scatter_axis`` on a 4-peer data axis in its three codec forms:
  Identity (a bf16 wire, the mean taken in fp32 and rounded once; without
  drops, and with them when the rotation is off), the Hadamard rotation
  with tail drops 0.05 (a bf16 gradient promoted to fp32 by the sign) and
  the 8-bit wire (``rs_wire_bits=8``);
* the ``(pod 2, data 4)`` forms: the data-axis hop of
  ``tests/test_pipeline_parity.py::test_reduce_scatter_2d_replica_consistent``
  (pod-replicated input, 8-bit grids shared over both axes; and a
  pod-dependent input), and the two hops of the reference's FSDP gather,
  pod first (reliable) then data (drops), with and without the 8-bit wire;
* ``ParallelCtx``'s data-parallel half on the ``(pod 2, data 4)`` mesh;
* two AdamW steps of ``gpt2-smoke`` through ``build_train_step`` with
  ``dp_mode='fsdp'`` on 4 peers, one and two micro-batches, tail drops
  0.05; ``pure_dp`` on the ``(data 2, model 2)`` host mesh with
  ``optireduce_2d``, replicated and FSDP.

Every draw of the port comes from the reference's own keys through
:class:`JaxDraws` (the port's key path folded into ``PRNGKey``), so the
signs, masks and noises are the reference's. The trainer cases raise
``skip_threshold`` to 0.9: the norms' bucket of ``gpt2-smoke`` is one
packet a sender, so a timed-out receiver loses whole rows and the §3.4
guard would skip most steps, leaving nothing to compare.

Tolerances: Identity bitwise (a mean of 4 bf16 values in fp32 is exact
before its one rounding); rotations 1e-5 absolute (the butterfly against
the reference's Kronecker matmuls, as ``tests/test_torch_step.py``); the
8-bit wire as ``tests/test_torch_pod.py`` (a code on a floor boundary may
move its block by two grid steps / sqrt(block)), checked here as every
entry within 1e-5 except at most 1% of the blocks, and those within the
largest grid step. Trainer: loss and grad_norm 1e-5 relative, loss_frac
1e-7, the AdamW first moment 1e-6 absolute (the sharp check of the synced
gradient: 0.1 g within 1e-6 puts g within 1e-5) and the second moment
1e-7 (0.05 g^2 then moves by at most 0.1 |g| 1e-5 for |g| <= 0.1;
measured 1.7e-8 after the second step), parameters 1e-1 x lr: AdamW's first
update is lr g / (|g| + eps), whose slope near |g| = eps is lr / (4 eps),
so a rounding difference of 1e-10 in an embedding gradient that is within
a few eps of zero moves its entry by a few percent of lr (measured: up to
5.3e-2 x lr on one entry of 32,768, where ``tests/test_torch_step.py``'s
replicated runs measured 1.9e-2 and set 5e-2).
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import drops as jdrops  # noqa: E402
from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.allreduce import (OptiReduceConfig,  # noqa: E402
                                        reduce_scatter_axis, rs_spec)
from repro_torch.core.keys import key as torch_key  # noqa: E402
from repro_torch.core.pipeline import Reliable, SyncContext  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import ParallelCtx, init_params  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.train.trainer import TrainConfig, build_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

BLOCK = 256
RATE = 0.05
ROT_TOL = 1e-5
STEPS = 2
SEQ = 32
GLOBAL_BATCH = 8
BUCKET = 16_384
LR = 1e-2
SKIP = 0.9
PARAM_TOL = 1e-1 * LR
# rs case -> (pods, data, dtype, rate, rs_wire_bits, hops, dim, input,
#            use_hadamard)
RS_CASES = {
    "identity": (1, 4, "bfloat16", 0.0, 0, ("data",), 1, "peer", True),
    "identity_drops": (1, 4, "bfloat16", RATE, 0, ("data",), 1, "peer",
                       False),
    "hadamard": (1, 4, "bfloat16", RATE, 0, ("data",), 0, "peer", True),
    "quant": (1, 4, "float32", RATE, 8, ("data",), 1, "peer", True),
    "rs2d_replicated": (2, 4, "float32", RATE, 8, ("data",), 0, "pod_rep",
                        True),
    "rs2d_grids": (2, 4, "float32", RATE, 8, ("data",), 0, "pod_scaled",
                   True),
    "two_hop": (2, 4, "float32", RATE, 0, ("pod", "data"), 0, "peer", True),
    "two_hop_q": (2, 4, "float32", RATE, 8, ("pod", "data"), 0, "peer",
                  True),
}
# trainer case -> (mesh (data, model), dp_mode, pure_dp, microbatch, strategy)
STEP_CASES = {
    "fsdp": ((4, 1), "fsdp", False, None, "optireduce"),
    "fsdp_micro2": ((4, 1), "fsdp", False, 1, "optireduce"),
    "pure_dp": ((2, 2), "replicated", True, None, "optireduce_2d"),
    "pure_dp_fsdp": ((2, 2), "fsdp", True, None, "optireduce_2d"),
}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_smoke
from repro.core.allreduce import OptiReduceConfig, SyncContext, rs_spec
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, block, rate, seq, gb, lr, bucket, skip, steps = sys.argv[1:10]
block, rate, seq, gb = int(block), float(rate), int(seq), int(gb)
lr, bucket, skip, steps = float(lr), int(bucket), float(skip), int(steps)
rs_cases, step_cases = eval(sys.argv[10]), eval(sys.argv[11])
save = {}
rng = np.random.default_rng(0)
x = rng.standard_normal((8, 64, 48)).astype(np.float32)
save["x"] = x
for name, (g, n, dtype, r, bits, hops, dim, inp, ht) in rs_cases.items():
    axes = ("pod", "data") if g > 1 else ("data",)
    mesh = make_mesh((g, n) if g > 1 else (n,), axes)
    cfg = OptiReduceConfig(drop_rate=r, hadamard_block=block,
                           rs_wire_bits=bits, use_hadamard=ht,
                           pod_axis="pod" if g > 1 else None)
    def body(xs, cfg=cfg, hops=hops, dim=dim, inp=inp, dtype=dtype):
        ctx = SyncContext(cfg=cfg, key=jax.random.PRNGKey(1))
        local = xs[0]
        if inp == "pod_rep":
            local = jnp.take(xs, jax.lax.axis_index("data"), axis=0)
        elif inp == "pod_scaled":
            local = jnp.take(xs, jax.lax.axis_index("data"), axis=0) * (
                1.0 + jax.lax.axis_index("pod"))
        local = local.astype(dtype)
        for ax in hops:
            local = rs_spec(cfg, with_drops=ax == "data").reduce_scatter(
                local, ax, dim, ctx)
        return local[None]
    spec = P(axes if g > 1 else "data", None, None)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=spec,
                          out_specs=P(axes if g > 1 else "data", None, None),
                          check_vma=False))
    xin = x[:g * n] if inp == "peer" else x[:n]
    if inp != "peer":
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=P(None, None, None),
                              out_specs=P(axes, None, None),
                              check_vma=False))
    save["rs/" + name] = np.asarray(f(jnp.asarray(xin)).astype(jnp.float32))

from repro.models.parallel import ParallelCtx
mesh = make_mesh((2, 4), ("pod", "data"))
pctx = ParallelCtx(dp_axis="data", pod_axis="pod", fsdp=True)
def pbody(xs):
    local = xs[0, :6, :4]
    return (pctx.dp_shard_index()[None], pctx.psum_dp(local)[None],
            pctx.all_gather_dp(local, axis=1)[None])
f = jax.jit(shard_map(pbody, mesh=mesh, in_specs=P(("pod", "data")),
                      out_specs=(P(("pod", "data")),) * 3, check_vma=False))
for name, val in zip(("index", "psum", "gather"), f(jnp.asarray(x))):
    save["pctx/" + name] = np.asarray(val)

cfg_m = get_smoke("gpt2-paper")
data = SyntheticLM(DataConfig(vocab_size=cfg_m.vocab_size, seq_len=seq,
                              global_batch=gb, seed=0))
key = jax.random.PRNGKey(0)
params0 = init_params(key, cfg_m)
for i, leaf in enumerate(jax.tree.leaves(params0)):
    save[f"init/{i}"] = np.asarray(leaf)
for name, (shape, mode, pure, micro, strategy) in step_cases.items():
    mesh = make_mesh(shape, ("data", "model"))
    sync = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            hadamard_block=block, skip_threshold=skip)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=lr),
                     bucket_elems=bucket, seq_chunk=seq, dp_mode=mode,
                     pure_dp=pure, microbatch=micro)
    make_step, opt, _ = build_train_step(cfg_m, tc, mesh)
    step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                            data.host_batch(0, 0, 1))
    params = jax.device_put(params0, sh["params"])
    opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
    jf = jax.jit(step_fn)
    for step in range(steps):
        batch = jax.device_put(data.host_batch(step, 0, 1), sh["batch"])
        params, opt_state, m = jf(params, opt_state, batch,
                                  jnp.asarray(step, jnp.int32), key)
        for k, v in m.items():
            save[f"{name}/{step}/metric/{k}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            save[f"{name}/{step}/param/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(opt_state.m)):
            save[f"{name}/{step}/m/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(opt_state.v)):
            save[f"{name}/{step}/v/{i}"] = np.asarray(leaf)
np.savez(out_path, **save)
print("child OK")
"""


def jkey(k):
    out = jax.random.PRNGKey(k[0])
    for d in k[1:]:
        out = jax.random.fold_in(out, d)
    return out


class JaxDraws:
    """The reference's draws for the port's key path: ``key`` (a port key
    tuple) folded into ``PRNGKey``, then the site's path, as the reference
    folds ``fold_in(key, b)`` or ``fold_in(step_key, l)``."""

    def __init__(self, key, cfg):
        self.key, self.cfg = tuple(key), cfg

    def _site(self, bucket):
        path = bucket if isinstance(bucket, tuple) else (bucket,)
        return jkey(self.key + tuple(path))

    def sign(self, bucket, block):
        return torch.from_numpy(np.array(jsign(self._site(bucket), block)))

    def mask(self, bucket, receiver, n, s, self_index=None):
        k = jax.random.fold_in(self._site(bucket), receiver)
        si = jnp.int32(receiver if self_index is None else self_index)
        return torch.from_numpy(np.array(jdrops.make_mask(
            self.cfg.drop_pattern, k, n, s, rate=self.cfg.drop_rate,
            packet_elems=self.cfg.packet_elems, self_index=si)))

    def noise(self, bucket, salt, shape):
        k = jax.random.fold_in(self._site(bucket), salt)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke model is too small to gain from torch's intra-op threads,
    and under the suite's parallel workers those threads contend for the
    cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def child(tmp_path_factory):
    """The reference's runs, in a child started before the file's first
    test: it runs while the tests that need none of it do (they come
    first)."""
    out = tmp_path_factory.mktemp("torch_fsdp") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(out), str(BLOCK), str(RATE),
             str(SEQ), str(GLOBAL_BATCH), str(LR), str(BUCKET), str(SKIP),
             str(STEPS), repr(RS_CASES), repr(STEP_CASES)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(child):
    proc, out = child
    assert proc.wait(timeout=900) == 0, out.with_suffix(".log").read_text()
    with np.load(out) as z:
        return dict(z)


# ------------------------------------------ without the reference: first
def _tc(mode, pure, micro, strategy, rate=RATE):
    sync = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            hadamard_block=BLOCK, skip_threshold=SKIP)
    return TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=LR),
                       bucket_elems=BUCKET, seq_chunk=SEQ, dp_mode=mode,
                       pure_dp=pure, microbatch=micro)


def test_reduce_scatter_lossless_is_the_mean():
    """Without drops or rotation the reduce-scatter is the exact mean of the
    peers' slices, in the peers' own dtype."""
    g = torch.randn((4, 8, 12), generator=torch.Generator().manual_seed(0))
    cfg = OptiReduceConfig(hadamard_block=BLOCK)
    assert isinstance(rs_spec(cfg, with_drops=False).transport, Reliable)
    ctx = SyncContext(cfg=cfg, draws=JaxDraws((1,), cfg), bucket=())
    out = reduce_scatter_axis(g, collectives.DATA, 1, ctx)
    want = g.mean(0).reshape(8, 4, 3).permute(1, 0, 2)
    torch.testing.assert_close(out, want, atol=1e-7, rtol=0)


def test_lossless_fsdp_equals_replicated():
    """Lossless, the FSDP path is the replicated path: the same losses and
    parameters up to the rotation's rounding (the replicated sync rotates
    every bucket, the lossless reduce-scatter rotates nothing)."""
    cfg = get_smoke("gpt2-paper")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    runs = {}
    for mode in ("replicated", "fsdp"):
        step_fn, opt = build_train_step(cfg, _tc(mode, False, None,
                                                 "optireduce", rate=0.0),
                                        peers=4, device="cpu")
        params = init_params(torch_key(0), cfg,
                             device="cpu")
        state = opt.init(params)
        losses = []
        for step in range(3):
            params, state, m = step_fn(params, state,
                                       data.host_batch(step, 0, 1), step,
                                       torch_key(0))
            losses.append(float(m["loss"]))
        runs[mode] = (losses, tree_leaves(params))
    assert runs["fsdp"][0][-1] < runs["fsdp"][0][0]
    np.testing.assert_allclose(runs["fsdp"][0], runs["replicated"][0],
                               rtol=1e-5)
    for a, b in zip(runs["fsdp"][1], runs["replicated"][1]):
        torch.testing.assert_close(a, b, atol=5e-2 * LR, rtol=0)


def test_fsdp_loss_frac_counts_only_the_replicated_bucket():
    """As the reference's (its gather VJP throws its stats away, ROADMAP
    C), ``loss_frac`` under FSDP is the loss of the norms' bucket alone:
    ``gpt2-smoke``'s 320 replicated entries, padded to 4 x 256."""
    from repro_torch.core.keys import fold_in
    from repro_torch.core.pipeline import ThreefryDraws
    cfg = get_smoke("gpt2-paper")
    tc = _tc("fsdp", False, None, "optireduce")
    step_fn, opt = build_train_step(cfg, tc, peers=4, device="cpu")
    params = init_params(torch_key(0), cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    fracs = []
    for step in range(3):
        params, state, m = step_fn(params, opt.init(params),
                                   data.host_batch(step, 0, 1), step,
                                   torch_key(0))
        draws = ThreefryDraws(key=fold_in(fold_in(torch_key(0), step), 7),
                               cfg=tc.sync, device=torch.device("cpu"))
        masks = torch.stack([draws.mask(0, r, 4, 256) for r in range(4)])
        want = ((1.0 - masks).sum(dim=(1, 2)) / (4 * 256)).mean()
        assert float(m["loss_frac"]) == pytest.approx(float(want), abs=1e-7)
        fracs.append(float(want))
    assert max(fracs) > 0


@pytest.mark.parametrize("what", ["recovery_fsdp", "recovery_pod",
                                  "transport_fsdp"])
def test_reference_refusals(what):
    cfg = get_smoke("gpt2-paper")
    if what == "recovery_fsdp":
        tc, mesh, match = (_tc("fsdp", False, None, "optireduce"),
                           make_host_mesh(4), "dp_mode='replicated'")
        tc = dataclasses.replace(tc, sync=dataclasses.replace(
            tc.sync, recovery="stale"))
    elif what == "recovery_pod":
        tc, mesh, match = (_tc("replicated", True, None, "optireduce_2d"),
                           make_host_mesh(2, 2), "2D")
        tc = dataclasses.replace(tc, sync=dataclasses.replace(
            tc.sync, recovery="stale"))
    else:
        tc, mesh, match = (_tc("fsdp", False, None, "optireduce"),
                           make_host_mesh(4), "transport_override")
        tc = dataclasses.replace(tc, transport_override=Reliable())
    with pytest.raises(ValueError, match=match):
        build_train_step(cfg, tc, mesh, device="cpu")


def test_tensor_parallel_mesh_names_a15b():
    """A ``model`` axis of size > 1 without ``pure_dp`` is tensor
    parallelism (A15b): the step trains the tp-padded global parameters,
    FSDP x TP included (``tests/test_torch_tp_step.py`` holds both to the
    reference)."""
    cfg = get_smoke("gpt2-paper")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    for mode in ("replicated", "fsdp"):
        step_fn, opt = build_train_step(
            cfg, _tc(mode, False, None, "optireduce"), make_host_mesh(2, 2),
            device="cpu")
        params = init_params(torch_key(0), cfg,
                             device="cpu", tp=2)
        state = opt.init(params)
        _, _, m = step_fn(params, state, data.host_batch(0, 0, 1), 0,
                          torch_key(0))
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# ------------------------------------------------------------ reduce-scatter
def _rs_input(x, g, n, inp, dtype):
    x = torch.from_numpy(x)
    if inp == "peer":
        local = x[:g * n]
    else:
        local = torch.cat([x[:n]] * g)
        if inp == "pod_scaled":
            scale = torch.arange(g, dtype=torch.float32).repeat_interleave(n)
            local = local * (1.0 + scale)[:, None, None]
    return local.to(getattr(torch, dtype))


def _port_rs(ref, case):
    g, n, dtype, rate, bits, hops, dim, inp, ht = RS_CASES[case]
    cfg = OptiReduceConfig(drop_rate=rate, hadamard_block=BLOCK,
                           rs_wire_bits=bits, use_hadamard=ht,
                           pod_axis="pod" if g > 1 else None)
    ctx = SyncContext(cfg=cfg, draws=JaxDraws((1,), cfg), bucket=(),
                      grid=collectives.Grid(pods=g))
    out = _rs_input(ref["x"], g, n, inp, dtype)
    for ax in hops:
        axis = collectives.DATA if ax == "data" else collectives.POD
        out = reduce_scatter_axis(out, axis, dim, ctx,
                                  with_drops=ax == "data")
    return out, cfg


@pytest.mark.parametrize("case", list(RS_CASES))
def test_reduce_scatter_matches_reference(ref, case):
    got, cfg = _port_rs(ref, case)
    want = ref["rs/" + case]
    bits = RS_CASES[case][4]
    identity = case.startswith("identity")
    assert tuple(got.shape) == want.shape
    # the wire dtype: Identity keeps bf16, a rotation promotes to fp32
    assert got.dtype == (torch.bfloat16 if identity else torch.float32)
    got = got.to(torch.float32).numpy()
    if identity:
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got - want)
    if not bits:
        assert float(err.max()) <= ROT_TOL, float(err.max())
        return
    # the 8-bit wire: a code on a floor boundary moves its block
    blocks = err.reshape(err.shape[0], -1)
    off = blocks > ROT_TOL
    assert off.mean() <= 0.01, off.mean()
    scale = np.abs(want).max()
    assert float(err.max()) <= 2 * scale / 255 + ROT_TOL


def test_parallel_ctx_dp_half_matches_reference(ref):
    """``ParallelCtx``'s data-parallel collectives on the (pod 2, data 4)
    grid: each peer's pod-major index, the sum over both axes, and the
    FSDP gather over the data axis (each pod its own 4 shards)."""
    pctx = ParallelCtx(dp_axis="data", pod_axis="pod", fsdp=True,
                       sizes={"pod": 2, "data": 4})
    assert pctx.dp_axes() == ("pod", "data") and pctx.dp_size() == 8
    local = torch.from_numpy(ref["x"][:, :6, :4])
    np.testing.assert_array_equal(pctx.dp_shard_index().numpy(),
                                  ref["pctx/index"])
    np.testing.assert_allclose(pctx.psum_dp(local).numpy(),
                               ref["pctx/psum"], atol=7 * 2.0 ** -23 * 4,
                               rtol=0)
    np.testing.assert_array_equal(pctx.all_gather_dp(local, 1).numpy(),
                                  ref["pctx/gather"])
    # the tp half rides along: no tp axis, no tp collective
    assert pctx.tp_size() == 1 and pctx.psum_tp(local) is local


def test_reduce_scatter_2d_replica_consistent(ref):
    """The port's form of the reference's test of the same name: with a
    pod-replicated gradient the data-axis hop gives both pods the same
    bits, the 8-bit grids being shared over both axes."""
    got, _ = _port_rs(ref, "rs2d_replicated")
    assert torch.equal(got[:4], got[4:])
    grids, _ = _port_rs(ref, "rs2d_grids")
    assert not torch.equal(grids[:4], grids[4:])   # the scale reaches out


# ------------------------------------------------------------------ trainer
def _port_params(ref):
    like = init_params(torch_key(0), get_smoke("gpt2-paper"),
                       device="cpu")
    n = len([k for k in ref if k.startswith("init/")])
    return params_from_jax(tree_unflatten(
        like, [ref[f"init/{i}"] for i in range(n)]))


def _run_port(ref, case):
    shape, mode, pure, micro, strategy = STEP_CASES[case]
    cfg = get_smoke("gpt2-paper")
    tc = _tc(mode, pure, micro, strategy)
    step_fn, opt = build_train_step(cfg, tc, make_host_mesh(*shape),
                                    device="cpu")
    params = _port_params(ref)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    sync = dataclasses.replace(tc.sync, pod_axis="model" if pure else None)
    history = []
    for step in range(STEPS):
        params, state, m = step_fn(
            params, state, data.host_batch(step, 0, 1), step, torch_key(0),
            draws=JaxDraws((0, step, 7), sync),
            site_draws=JaxDraws((0, step), sync))
        history.append(({k: float(v) for k, v in m.items()},
                        [p.detach().clone() for p in tree_leaves(params)],
                        [x.clone() for x in tree_leaves(state.m)],
                        [x.clone() for x in tree_leaves(state.v)]))
    return history


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_reference(ref, case):
    for step, (metrics, leaves, ms, vs) in enumerate(_run_port(ref, case)):
        pre = f"{case}/{step}"
        for k in ("loss", "grad_norm"):
            want = float(ref[f"{pre}/metric/{k}"])
            assert metrics[k] == pytest.approx(want, rel=1e-5), (step, k)
        assert metrics["loss_frac"] == pytest.approx(
            float(ref[f"{pre}/metric/loss_frac"]), abs=1e-7)
        assert metrics["skipped"] == float(ref[f"{pre}/metric/skipped"])
        for i, (p, m, v) in enumerate(zip(leaves, ms, vs)):
            np.testing.assert_allclose(m.numpy(), ref[f"{pre}/m/{i}"],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{pre} moment {i}")
            np.testing.assert_allclose(v.numpy(), ref[f"{pre}/v/{i}"],
                                       atol=1e-7, rtol=0,
                                       err_msg=f"{pre} second moment {i}")
            np.testing.assert_allclose(p.numpy(), ref[f"{pre}/param/{i}"],
                                       atol=PARAM_TOL, rtol=0,
                                       err_msg=f"{pre} leaf {i}")
