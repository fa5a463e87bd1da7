"""The whole slice: two OptiReduce training steps of the port against two of
the JAX ``build_train_step`` on the same parameters, batches and draws.

The reference runs on 4 forced host devices in one subprocess (once for the
file, results handed over as an ``.npz``): ``gpt2-smoke``, 4 data ranks,
``optireduce`` with ``hadamard_block=256`` and ``bucket_elems=16384`` (8
buckets, so the pipelined steady state runs), AdamW, for a drop rate of
0.05 under the ``tail`` and ``bernoulli`` patterns and for no drops, and
``optireduce_rounds`` (the paper's round schedule, incast 2) with tail drops
at 0.05. The child also records the reference's own draws — each bucket's Hadamard sign
and each receiver's arrival mask, derived from its keys exactly as the
step derives them — and the port's run is handed those
(:class:`InjectedDraws`). Without drops the synced gradient does not depend
on the sign (decode(mean(encode)) == mean), so that case runs on the port's
own generators.

Tolerances, set from fp32 rounding: the port rotates with the butterfly
where the reference's jnp path uses the Kronecker matmuls, and sums run in
other orders. Loss and grad_norm agree to 1e-5 relative and loss_frac to
1e-7 (the same masks). The AdamW first moment, 0.1 x the synced and clipped
gradient (largest entry ~3e-2), agrees to 1e-6 absolute: the sharp check of
the whole sync path (measured: ~4e-9 after step 0, ~2e-7 after step 1,
once the parameters differ as below). The parameters agree to 5e-2 x lr:
AdamW divides each update by sqrt(v) + eps, so on an entry whose synced
gradient is within a few eps of zero a 1e-10 rounding difference moves the
update by a few percent of lr (measured: up to 1.9e-2 x lr).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
from repro_torch.core.keys import key as torch_key
from repro_torch.core.pipeline import ThreefryDraws, SyncContext
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, build_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import params_from_jax

STEPS = 2
PEERS = 4
BLOCK = 256
BUCKET = 16_384
SEQ = 32
GLOBAL_BATCH = 8
LR = 1e-2
M_TOL = 1e-6        # AdamW first moment (largest entry ~3e-2)
PARAM_TOL = 5e-2 * LR
# name -> (strategy, drop pattern, drop rate, incast)
CASES = {"tail": ("optireduce", "tail", 0.05, 1),
         "bernoulli": ("optireduce", "bernoulli", 0.05, 1),
         "nodrop": ("optireduce", "tail", 0.0, 1),
         "rounds": ("optireduce_rounds", "tail", 0.05, 2)}

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.core import drops
from repro.core.allreduce import OptiReduceConfig
from repro.core.bucket_plan import BucketPlan, bucket_keys
from repro.core.hadamard import rademacher_sign
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, steps, peers, block, bucket, seq, gb, lr = sys.argv[1:9]
steps, peers, block, bucket = int(steps), int(peers), int(block), int(bucket)
seq, gb, lr = int(seq), int(gb), float(lr)
cases = eval(sys.argv[9])
cfg = get_smoke("gpt2-paper")
mesh = make_mesh((peers,), ("data",))
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=gb, seed=0))
key = jax.random.PRNGKey(0)
params0 = init_params(key, cfg)
save = {}
for i, leaf in enumerate(jax.tree.leaves(params0)):
    save[f"init/{i}"] = np.asarray(leaf)
for name, (strategy, pattern, rate, incast) in cases.items():
    sync = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=block,
                            incast=incast)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=lr),
                     bucket_elems=bucket, seq_chunk=seq)
    make_step, opt, _ = build_train_step(cfg, tc, mesh)
    step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                            data.host_batch(0, 0, 1))
    params = jax.device_put(params0, sh["params"])
    opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
    jf = jax.jit(step_fn)
    plan = BucketPlan.for_tree(params0, bucket)
    n = peers
    s = (plan.bucket_elems + (-plan.bucket_elems) % (n * block)) // n
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
        # the step's draws, derived exactly as the step derives them
        skey = jax.random.fold_in(key, step)
        sync_key = jax.random.fold_in(skey, 7)
        bkeys = bucket_keys(sync_key, plan.num_buckets)
        save[f"{name}/{step}/sign"] = np.stack(
            [np.asarray(rademacher_sign(bkeys[b], block))
             for b in range(plan.num_buckets)])
        if rate > 0:
            masks = np.stack([np.stack([np.asarray(drops.make_mask(
                pattern, jax.random.fold_in(bkeys[b], r), n, s, rate=rate,
                packet_elems=sync.packet_elems, self_index=r))
                for r in range(n)]) for b in range(plan.num_buckets)])
            save[f"{name}/{step}/mask"] = masks.astype(np.uint8)
np.savez(out_path, **save)
print("child OK")
"""


class InjectedDraws:
    """Serves the reference's recorded draws for one step."""

    def __init__(self, sign: np.ndarray, mask: np.ndarray | None):
        self._sign = torch.from_numpy(sign)
        self._mask = None if mask is None else torch.from_numpy(
            mask.astype(np.float32))

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s):
        return self._mask[bucket, receiver].clone()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_step") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), str(STEPS), str(PEERS),
         str(BLOCK), str(BUCKET), str(SEQ), str(GLOBAL_BATCH), str(LR),
         repr(CASES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _ref_init_leaves(ref):
    n = len([k for k in ref if k.startswith("init/")])
    return [ref[f"init/{i}"] for i in range(n)]


def _port_params(ref):
    """The reference's initial parameters, in the port's tree."""
    like = init_params(torch_key(0), get_smoke("gpt2-paper"),
                       device="cpu")
    return params_from_jax(tree_unflatten(like, _ref_init_leaves(ref)))


def _run_port(ref, case, *, sync_mode="pipelined", inject=True):
    strategy, pattern, rate, incast = CASES[case]
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=BLOCK,
                            incast=incast)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=LR),
                     bucket_elems=BUCKET, seq_chunk=SEQ, sync_mode=sync_mode)
    step_fn, opt = build_train_step(cfg, tc, peers=PEERS, device="cpu")
    params = _port_params(ref)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    history = []
    for step in range(STEPS):
        draws = None
        if inject:
            draws = InjectedDraws(ref[f"{case}/{step}/sign"],
                                  ref.get(f"{case}/{step}/mask"))
        params, state, m = step_fn(params, state, data.host_batch(step, 0, 1),
                                   step, torch_key(0), draws=draws)
        history.append(({k: float(v) for k, v in m.items()},
                        [p.detach().clone() for p in tree_leaves(params)],
                        [x.clone() for x in tree_leaves(state.m)]))
    return history


@pytest.mark.parametrize("case", ["tail", "bernoulli", "nodrop", "rounds"])
def test_step_matches_reference(ref, case):
    history = _run_port(ref, case, inject=case != "nodrop")
    for step, (metrics, leaves, moments) in enumerate(history):
        for k in ("loss", "grad_norm"):
            want = float(ref[f"{case}/{step}/metric/{k}"])
            assert metrics[k] == pytest.approx(want, rel=1e-5), (step, k)
        want_frac = float(ref[f"{case}/{step}/metric/loss_frac"])
        if case == "nodrop":
            assert metrics["loss_frac"] == 0.0 == want_frac
        else:
            assert want_frac > 0
            assert metrics["loss_frac"] == pytest.approx(want_frac,
                                                         abs=1e-7)
        assert metrics["skipped"] == float(
            ref[f"{case}/{step}/metric/skipped"])
        for i, (leaf, m1) in enumerate(zip(leaves, moments)):
            np.testing.assert_allclose(m1.numpy(),
                                       ref[f"{case}/{step}/m/{i}"],
                                       atol=M_TOL, rtol=0,
                                       err_msg=f"step {step} moment {i}")
            np.testing.assert_allclose(leaf.numpy(),
                                       ref[f"{case}/{step}/param/{i}"],
                                       atol=PARAM_TOL, rtol=0,
                                       err_msg=f"step {step} leaf {i}")


def test_scan_and_pipelined_agree_exactly(ref):
    piped = _run_port(ref, "tail", sync_mode="pipelined")
    scanned = _run_port(ref, "tail", sync_mode="scan")
    for (m_a, p_a, _), (m_b, p_b, _) in zip(piped, scanned):
        assert m_a == m_b
        for a, b in zip(p_a, p_b):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["scan", "pipelined"])
def test_synced_arena_identical_across_peers(ref, mode):
    """After stage 2 every peer holds the same synced arena, so the trainer
    may update the single parameter copy from peer 0's."""
    g = torch.Generator().manual_seed(3)
    arena = torch.randn((PEERS, 8, BUCKET), generator=g)
    sync = OptiReduceConfig(drop_rate=0.05, drop_pattern="tail",
                            hadamard_block=BLOCK)
    draws = InjectedDraws(ref["tail/0/sign"], ref["tail/0/mask"])
    synced = sync_packed(arena, SyncContext(cfg=sync, draws=draws),
                         mode=mode)
    for p in range(1, PEERS):
        assert torch.equal(synced[p], synced[0])
    # and it is the drop-compensated estimate of the mean, not garbage
    err = (synced[0] - arena.mean(0)).pow(2).mean().sqrt()
    assert 0 < float(err) < 0.5


def test_nodrop_sync_is_the_mean_for_any_sign():
    """decode(mean(encode)) == mean: without drops the sign cancels."""
    g = torch.Generator().manual_seed(5)
    arena = torch.randn((PEERS, 3, 4096), generator=g)
    sync = OptiReduceConfig(hadamard_block=BLOCK)
    outs = [sync_packed(arena, SyncContext(cfg=sync, draws=ThreefryDraws(
        key=torch_key(seed), cfg=sync, device=torch.device("cpu"))))
        for seed in (0, 1)]
    want = arena.mean(0)
    for out in outs:
        torch.testing.assert_close(out[0], want, atol=1e-5, rtol=0)


def test_tree_layout_matches_reference(ref):
    """The port packs in jax.tree.flatten order: the reference's initial
    leaves, taken in order, have the port's leaf shapes."""
    params = _port_params(ref)
    leaves = tree_leaves(params)
    assert [tuple(p.shape) for p in leaves] == \
        [a.shape for a in _ref_init_leaves(ref)]
    assert tree_map(lambda p: p.dtype, params)["embed"] == torch.float32
