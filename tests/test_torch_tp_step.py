"""The tensor-parallel trainer at ``(data 2, model 2)`` against the JAX
package: each tp group's sync, two whole steps, and the recovery refusal.

The reference runs once for the file in a subprocess on 4 forced host
devices:

* ``sync_packed`` under ``shard_map`` on the ``(data 2, model 2)`` mesh,
  every device handed its own local arena, for ``optireduce`` (tail drops
  0.05, Hadamard blocks of 256) and ``optireduce_q``: each tp rank syncs
  over ``data`` alone, with the same key on every tp rank;
* two AdamW steps of ``gpt2-smoke`` at drop 0 through ``build_train_step``
  at ``tp = 1`` on ``(data 2, model 1)``, replicated and FSDP, and on
  ``(pod 2, data 2, model 1)`` with ``optireduce_2d``; for the record of
  its fault, the first two also at ``(data 2, model 2)``;
* its launcher with ``--tp 2 --recovery stale``, which fails.

The port's sync is handed the reference's draws (``JaxDraws``: the port's
key path folded into ``PRNGKey``). Its steps at ``tp = 2`` are held to the
reference's at ``tp = 1`` on the same global weights (``gpt2-smoke`` pads
nothing at tp = 2): the math of tensor parallelism does not change a step,
where the reference's ``tp = 2`` step does (ROADMAP C).

Tolerances: ``optireduce`` 1e-5 absolute (the butterfly against the
reference's Kronecker rotation, as ``tests/test_torch_fsdp.py``). The 8-bit
wire: a stage-2 quotient is the mean of dequantized codes over the grid
step, which sits on an integer wherever the codes' sum is even, so its
floor follows the last bit of the arithmetic and many stage-2 codes differ
by one from the reference's (with the arenas here, in 0.5% of the blocks of
one tp group and 57% of the other's, which is 3x larger; each such code
moves its block by one grid step / sqrt(block)). So each tp group's rows
are held bitwise to the port's own one-group sync of that group's arenas
(which ``tests/test_torch_quant_sync.py`` holds to the reference code by
code), and to the reference within 2 amax / 255 an entry, as
``tests/test_torch_pod.py`` bounds it. ``loss_frac`` 1e-7 (the same
masks). Steps:
loss and grad_norm 1e-5 relative, the AdamW moments 1e-6 and 1e-7
absolute, parameters 1e-1 x lr, as ``tests/test_torch_fsdp.py`` states
and argues.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

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
                                        reduce_scatter_axis, sync_packed)
from repro_torch.core.pipeline import SyncContext, strategy_names  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.core.keys import key as torch_key  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.mesh import HostMesh, make_host_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.train.trainer import (TrainConfig,  # noqa: E402
                                       build_train_step)
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

BLOCK = 256
SYNC_RATE = 0.05
ARENA = (6, 16_384)              # (buckets, bucket_elems) of a tp rank
ROT_TOL = 1e-5
SEQ = 32
GLOBAL_BATCH = 4
BUCKET = 16_384
LR = 1e-2
STEPS = 2
PARAM_TOL = 1e-1 * LR
SYNC_CASES = ("optireduce", "optireduce_q")
# step case -> (mesh shape, its axes, dp_mode, strategy)
DM = ("data", "model")
PDM = ("pod", "data", "model")
STEP_CASES = {
    "replicated_tp1": ((2, 1), DM, "replicated", "optireduce"),
    "fsdp_tp1": ((2, 1), DM, "fsdp", "optireduce"),
    "replicated_tp2": ((2, 2), DM, "replicated", "optireduce"),
    "fsdp_tp2": ((2, 2), DM, "fsdp", "optireduce"),
    "pod_tp1": ((2, 2, 1), PDM, "replicated", "optireduce_2d"),
}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_smoke
from repro.core.allreduce import OptiReduceConfig, SyncContext, sync_packed
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, block, rate, nb, elems, seq, gb, lr, bucket, steps = sys.argv[1:11]
block, rate, nb, elems = int(block), float(rate), int(nb), int(elems)
seq, gb, lr, bucket, steps = int(seq), int(gb), float(lr), int(bucket), \
    int(steps)
sync_cases, step_cases = eval(sys.argv[11]), eval(sys.argv[12])
save = {}
rng = np.random.default_rng(0)
x = rng.standard_normal((2, 2, nb, elems)).astype(np.float32)
x[:, 1] *= 3.0                      # the tp ranks' arenas differ in scale
save["x"] = x
mesh = make_mesh((2, 2), ("data", "model"))
for strategy in sync_cases:
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                           hadamard_block=block)
    def body(xs, cfg=cfg):
        ctx = SyncContext(cfg=cfg, key=jax.random.PRNGKey(5))
        out = sync_packed(xs[0, 0], ctx, mode="pipelined")
        return out[None, None], ctx.loss_fraction()[None, None]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data", "model"),
                          out_specs=(P("data", "model"),
                                     P("data", "model")),
                          check_vma=False))
    out, frac = f(jnp.asarray(x))
    save[f"sync/{strategy}"] = np.asarray(out)
    save[f"sync/{strategy}/frac"] = np.asarray(frac)

cfg_m = get_smoke("gpt2-paper")
data = SyntheticLM(DataConfig(vocab_size=cfg_m.vocab_size, seq_len=seq,
                              global_batch=gb, seed=0))
key = jax.random.PRNGKey(0)
params0 = init_params(key, cfg_m)
for i, leaf in enumerate(jax.tree.leaves(params0)):
    save[f"init/{i}"] = np.asarray(leaf)
for name, (shape, axes, mode, strategy) in step_cases.items():
    tc = TrainConfig(sync=OptiReduceConfig(strategy=strategy,
                                           hadamard_block=block),
                     optimizer=OptimizerConfig(lr=lr), bucket_elems=bucket,
                     seq_chunk=seq, dp_mode=mode)
    make_step, opt, _ = build_train_step(cfg_m, tc, make_mesh(shape, axes))
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

from repro.launch import train as ref_launcher
try:
    ref_launcher.main(["--smoke", "--dp", "2", "--tp", "2", "--steps", "1",
                       "--seq-len", "16", "--recovery", "stale"])
    save["launcher_error"] = np.asarray("")
except ValueError as e:
    save["launcher_error"] = np.asarray(str(e))
np.savez(out_path, **save)
print("child OK")
"""


def jkey(k):
    out = jax.random.PRNGKey(k[0])
    for d in k[1:]:
        out = jax.random.fold_in(out, d)
    return out


class JaxDraws:
    """The reference's draws for the port's key path (``key`` folded into
    ``PRNGKey``, then the bucket), as ``tests/test_torch_fsdp.py``."""

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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_tp_step") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), str(BLOCK), str(SYNC_RATE),
         str(ARENA[0]), str(ARENA[1]), str(SEQ), str(GLOBAL_BATCH), str(LR),
         str(BUCKET), str(STEPS), repr(SYNC_CASES), repr(STEP_CASES)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


# ------------------------------------------------------------------- sync
@pytest.mark.parametrize("strategy", SYNC_CASES)
def test_tp_group_sync_matches_reference(ref, strategy):
    """The ``(T * N, B, E)`` arena of a ``(data 2, model 2)`` grid, model
    outermost: each tp group's synced rows equal the reference's
    ``sync_packed`` on the same local arenas, and the two groups never
    mix (each keeps its own scale, and under ``optireduce_q`` its own
    grids)."""
    x = ref["x"]                                    # (data, model, B, E)
    arena = torch.from_numpy(np.ascontiguousarray(
        x.transpose(1, 0, 2, 3))).reshape(4, *x.shape[2:])
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=SYNC_RATE,
                           hadamard_block=BLOCK)
    ctx = SyncContext(cfg=cfg, draws=JaxDraws((5,), cfg),
                      grid=collectives.Grid(tp=2))
    got = sync_packed(arena, ctx, mode="pipelined").reshape(2, 2, *x.shape[2:])
    want = ref[f"sync/{strategy}"].transpose(1, 0, 2, 3)
    frac = float(ctx.loss_fraction())
    assert frac == pytest.approx(float(ref[f"sync/{strategy}/frac"].mean()),
                                 abs=1e-7)
    assert frac > 0
    err = np.abs(got.numpy() - want)
    if strategy == "optireduce":
        assert float(err.max()) <= ROT_TOL, float(err.max())
        return
    for t in range(2):
        scale = np.abs(want[t]).max()
        assert float(err[t].max()) <= 2 * scale / 255 + ROT_TOL
        alone = SyncContext(cfg=cfg, draws=JaxDraws((5,), cfg))
        one = sync_packed(arena[2 * t:2 * t + 2].clone(), alone,
                          mode="pipelined")
        assert torch.equal(got[t], one)


@pytest.mark.parametrize("strategy", strategy_names())
def test_tp_groups_sync_as_one_group_each(strategy):
    """Every strategy on a ``(data 4, model 2)`` grid: each tp group's rows
    are, bit for bit, that group's arenas synced as a grid of one group
    with the same draws (the groups never mix, one call serves both)."""
    cfg = OptiReduceConfig(strategy=strategy, drop_rate=0.05,
                           hadamard_block=BLOCK, incast=2)
    arena = torch.randn((8, 2, 8192), generator=torch.Generator()
                        .manual_seed(3))
    arena[4:] *= 3.0
    got = sync_packed(arena, SyncContext(cfg=cfg, draws=JaxDraws((6,), cfg),
                                         grid=collectives.Grid(tp=2)),
                      mode="pipelined")
    for t in range(2):
        one = sync_packed(arena[4 * t:4 * t + 4].clone(), SyncContext(
            cfg=cfg, draws=JaxDraws((6,), cfg)), mode="pipelined")
        assert torch.equal(got[4 * t:4 * t + 4], one), t


RS_TP_CASES = {                   # case -> (pods, rs_wire_bits)
    "hadamard": (1, None),
    "8bit": (1, 8),
    "hadamard/pods": (2, None),
}


@pytest.mark.parametrize("case", list(RS_TP_CASES))
def test_tp_groups_reduce_scatter_as_one_group_each(case):
    """FSDP x TP's gradient reduction with drops 0.05: ``reduce_scatter_axis``
    over the trainer's hops (the pod hop reliable, then the data hop lossy)
    on a ``(pods, data 4, model 2)`` stack. Each tp group's reduced rows
    are, bit for bit, that group's stack reduce-scattered as a grid of one
    group with the same draws, the form ``tests/test_torch_fsdp.py`` holds
    to the reference: the masks, shard indices and (8-bit wire) grids are
    laid out per tp group and never cross them."""
    pods, bits = RS_TP_CASES[case]
    cfg = OptiReduceConfig(drop_rate=0.05, hadamard_block=BLOCK,
                           rs_wire_bits=bits,
                           pod_axis="pod" if pods > 1 else None)
    hops = [(collectives.POD, False)] * (pods > 1) + [(collectives.DATA,
                                                       True)]
    n = 4 * pods
    g = torch.randn((2 * n, 8, 3, BLOCK),
                    generator=torch.Generator().manual_seed(4))
    g[n:] *= 3.0

    def reduce(x, grid):
        ctx = SyncContext(cfg=cfg, draws=JaxDraws((7,), cfg), bucket=(),
                          grid=grid)
        for axis, with_drops in hops:
            x = reduce_scatter_axis(x, axis, 0, ctx, with_drops=with_drops)
        return x, float(ctx.loss_fraction())

    got, frac = reduce(g, collectives.Grid(pods, 2))
    assert frac > 0
    assert got.shape == (2 * n, 8 // n, 3, BLOCK)
    for t in range(2):
        one, one_frac = reduce(g[n * t:n * (t + 1)].clone(),
                               collectives.Grid(pods))
        assert one_frac == frac
        assert torch.equal(got[n * t:n * (t + 1)], one), t


# ----------------------------------------------------------------- trainer
def _port_params(ref):
    like = init_params(torch_key(0), get_smoke("gpt2-paper"),
                       device="cpu", tp=2)
    n = len(tree_leaves(like))
    return params_from_jax(tree_unflatten(
        like, [ref[f"init/{i}"] for i in range(n)]))


def _run_port(ref, mode, mesh=None, strategy="optireduce"):
    cfg = get_smoke("gpt2-paper")
    tc = TrainConfig(sync=OptiReduceConfig(strategy=strategy,
                                           hadamard_block=BLOCK),
                     optimizer=OptimizerConfig(lr=LR), bucket_elems=BUCKET,
                     seq_chunk=SEQ, dp_mode=mode)
    step_fn, opt = build_train_step(cfg, tc, mesh or make_host_mesh(2, 2),
                                    device="cpu")
    params = _port_params(ref)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    history = []
    for step in range(STEPS):
        params, state, m = step_fn(
            params, state, data.host_batch(step, 0, 1), step, torch_key(0),
            draws=JaxDraws((0, step, 7), tc.sync),
            site_draws=JaxDraws((0, step), tc.sync))
        history.append(({k: float(v) for k, v in m.items()},
                        [p.detach().clone() for p in tree_leaves(params)],
                        [x.clone() for x in tree_leaves(state.m)],
                        [x.clone() for x in tree_leaves(state.v)]))
    return history


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "pod"])
def test_tp_steps_match_reference_tp1(ref, mode):
    """Two steps at ``tp = 2`` (replicated, FSDP x TP, and on a ``(pod 2,
    data 2, model 2)`` grid with ``optireduce_2d``) equal the reference's
    two steps at ``tp = 1`` on the same global weights: loss, grad_norm,
    the AdamW moments and the parameters."""
    if mode == "pod":
        run = _run_port(ref, "replicated", HostMesh(PDM, (2, 2, 2)),
                        "optireduce_2d")
    else:
        run = _run_port(ref, mode)
    for step, (metrics, leaves, ms, vs) in enumerate(run):
        pre = f"{mode}_tp1/{step}"
        for k in ("loss", "grad_norm"):
            assert metrics[k] == pytest.approx(
                float(ref[f"{pre}/metric/{k}"]), rel=1e-5), (step, k)
        assert metrics["loss_frac"] == pytest.approx(
            float(ref[f"{pre}/metric/loss_frac"]), abs=1e-7)
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


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_reference_tp_step_norm_differs_from_tp1(ref, mode):
    """Records the reference's fault on whole steps (ROADMAP C): its
    ``tp = 2`` step reads the same loss as its ``tp = 1`` step but another
    grad_norm (replicated: the sharded leaves' gradients doubled, the
    replicated ones partial; FSDP x TP likewise through the gather's
    VJP). The port's ``tp = 2`` grad_norm is the ``tp = 1`` one (above)."""
    loss1 = float(ref[f"{mode}_tp1/0/metric/loss"])
    loss2 = float(ref[f"{mode}_tp2/0/metric/loss"])
    assert loss2 == pytest.approx(loss1, rel=1e-5)
    g1 = float(ref[f"{mode}_tp1/0/metric/grad_norm"])
    g2 = float(ref[f"{mode}_tp2/0/metric/grad_norm"])
    assert abs(g2 - g1) > 1e-2 * g1, (g1, g2)


def test_recovery_with_tp_raises_as_the_reference_fails(ref):
    """``--recovery stale --tp 2``: the reference's launcher sizes the
    stale cache from the global parameters and its trainer packs the local
    ones, so it fails (ROADMAP C); the port refuses the combination up
    front, naming that failure."""
    msg = str(ref["launcher_error"])
    assert "stale cache" in msg and "longer than the padded bucket" in msg
    tc = TrainConfig(sync=OptiReduceConfig(recovery="stale"))
    with pytest.raises(ValueError, match="longer than the"):
        build_train_step(get_smoke("gpt2-paper"), tc, make_host_mesh(2, 2),
                         device="cpu")
    with pytest.raises(ValueError, match="tensor parallelism"):
        launcher.run(["--smoke", "--device", "cpu", "--steps", "1",
                      "--dp", "2", "--tp", "2", "--seq-len", "16",
                      "--recovery", "stale"])
