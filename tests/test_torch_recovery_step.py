"""Three training steps with loss recovery (``--recovery stale|ef``) of the
port against three of the JAX ``build_train_step``, on the same parameters,
batches and draws, recovery state included.

The reference runs on 4 forced host devices in one subprocess (once for the
file, results handed over as an ``.npz``): ``gpt2-smoke``, 4 data ranks,
``hadamard_block=256`` and ``bucket_elems=16384`` (8 buckets, so the
pipelined steady state runs), AdamW, lr 1e-2, drop rate 0.05, for
``optireduce`` with ``recovery="stale"`` under ``tail`` drops, with
``recovery="ef"`` under ``burst`` and under ``tail`` drops, and
``optireduce_rounds`` (incast 2) with ``ef`` under ``tail`` drops. Three
steps, so that steps 1 and 2 consume the stale cache and the residual of
the step before. The child records each step's draws (each bucket's sign,
each receiver's arrival mask), which the port's run is handed; the port's
error feedback redraws the masks through the same provider.

Tolerances, as ``tests/test_torch_step.py`` states them (the butterfly
against the reference's Kronecker matmuls, sums in other orders): loss and
grad_norm 1e-5 relative, loss_frac 1e-7 (the same masks), the AdamW first
moment 1e-6 absolute, the parameters 5e-2 x lr. The recovery state carries
the gradient before the clip, ten times the moment's scale: the stale cache
(the synced arena) and the residuals within 1e-5 absolute.

The port runs on one torch thread, and each of its runs once for the file
(:func:`port_runs`): the exact comparison of ``scan`` with ``pipelined``
reuses the pipelined run the reference comparison holds.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import recovery
from repro_torch.core.allreduce import OptiReduceConfig
from repro_torch.core.bucket_plan import BucketPlan
from repro_torch.core.keys import key as torch_key
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, build_train_step
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax

STEPS = 3
PEERS = 4
BLOCK = 256
BUCKET = 16_384
SEQ = 32
GLOBAL_BATCH = 8
LR = 1e-2
M_TOL = 1e-6
PARAM_TOL = 5e-2 * LR
REC_TOL = 1e-5
# name -> (strategy, drop pattern, recovery, incast)
CASES = {"stale": ("optireduce", "tail", "stale", 1),
         "ef_burst": ("optireduce", "burst", "ef", 1),
         "ef_tail": ("optireduce", "tail", "ef", 1),
         "rounds_ef": ("optireduce_rounds", "tail", "ef", 2)}
RATE = 0.05

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.core import drops, recovery
from repro.core.allreduce import OptiReduceConfig
from repro.core.bucket_plan import BucketPlan, bucket_keys
from repro.core.hadamard import rademacher_sign
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, steps, peers, block, bucket, seq, gb, lr, rate = sys.argv[1:10]
steps, peers, block, bucket = int(steps), int(peers), int(block), int(bucket)
seq, gb, lr, rate = int(seq), int(gb), float(lr), float(rate)
cases = eval(sys.argv[10])
cfg = get_smoke("gpt2-paper")
mesh = make_mesh((peers,), ("data",))
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=gb, seed=0))
key = jax.random.PRNGKey(0)
params0 = init_params(key, cfg)
save = {}
for i, leaf in enumerate(jax.tree.leaves(params0)):
    save[f"init/{i}"] = np.asarray(leaf)
plan = BucketPlan.for_tree(params0, bucket)
n = peers
s = (plan.bucket_elems + (-plan.bucket_elems) % (n * block)) // n
for name, (strategy, pattern, mode, incast) in cases.items():
    sync = OptiReduceConfig(strategy=strategy, drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=block,
                            incast=incast, recovery=mode)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=lr),
                     bucket_elems=bucket, seq_chunk=seq)
    make_step, opt, _ = build_train_step(cfg, tc, mesh)
    step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                            data.host_batch(0, 0, 1))
    params = jax.device_put(params0, sh["params"])
    opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
    rec = jax.device_put(recovery.init_state(
        recovery.parse(mode), plan.num_buckets, plan.bucket_elems,
        n_dp=peers), sh["rec"])
    jf = jax.jit(step_fn)
    for step in range(steps):
        batch = jax.device_put(data.host_batch(step, 0, 1), sh["batch"])
        params, opt_state, rec, m = jf(params, opt_state, rec, batch,
                                       jnp.asarray(step, jnp.int32), key)
        for k, v in m.items():
            save[f"{name}/{step}/metric/{k}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            save[f"{name}/{step}/param/{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(opt_state.m)):
            save[f"{name}/{step}/m/{i}"] = np.asarray(leaf)
        for k, v in rec.items():
            save[f"{name}/{step}/rec/{k}"] = np.asarray(v)
        skey = jax.random.fold_in(key, step)
        bkeys = bucket_keys(jax.random.fold_in(skey, 7), plan.num_buckets)
        save[f"{name}/{step}/sign"] = np.stack(
            [np.asarray(rademacher_sign(bkeys[b], block))
             for b in range(plan.num_buckets)])
        save[f"{name}/{step}/mask"] = np.stack([np.stack([np.asarray(
            drops.make_mask(pattern, jax.random.fold_in(bkeys[b], r), n, s,
                            rate=rate, packet_elems=sync.packet_elems,
                            self_index=r))
            for r in range(n)]) for b in range(plan.num_buckets)]
            ).astype(np.uint8)
np.savez(out_path, **save)
print("child OK")
"""


class InjectedDraws:
    """Serves the reference's recorded draws for one step, to the exchange
    and to the error feedback's redraw alike."""

    def __init__(self, sign: np.ndarray, mask: np.ndarray):
        self._sign = torch.from_numpy(sign)
        self._mask = torch.from_numpy(mask.astype(np.float32))

    def sign(self, bucket, block):
        return self._sign[bucket]

    def mask(self, bucket, receiver, n, s, self_index=None):
        assert self_index in (None, receiver)
        return self._mask[bucket, receiver].clone()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_recovery_step") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), str(STEPS), str(PEERS),
         str(BLOCK), str(BUCKET), str(SEQ), str(GLOBAL_BATCH), str(LR),
         str(RATE), repr(CASES)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(autouse=True)
def one_thread():
    """gpt2-smoke is too small to gain from torch's intra-op threads, and
    under the suite's parallel workers those threads contend for the
    cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_runs(ref):
    """``(case, sync_mode) -> _run_port(ref, case, sync_mode=...)``, each
    run once for the file."""
    runs = {}

    def run(case, sync_mode="pipelined"):
        if (case, sync_mode) not in runs:
            runs[case, sync_mode] = _run_port(ref, case, sync_mode=sync_mode)
        return runs[case, sync_mode]
    return run


def _port_params(ref):
    like = init_params(torch_key(0), get_smoke("gpt2-paper"),
                       device="cpu")
    n = len([k for k in ref if k.startswith("init/")])
    return params_from_jax(tree_unflatten(
        like, [ref[f"init/{i}"] for i in range(n)]))


def _run_port(ref, case, *, sync_mode="pipelined"):
    strategy, pattern, mode, incast = CASES[case]
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(strategy=strategy, drop_rate=RATE,
                            drop_pattern=pattern, hadamard_block=BLOCK,
                            incast=incast, recovery=mode)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=LR),
                     bucket_elems=BUCKET, seq_chunk=SEQ, sync_mode=sync_mode)
    step_fn, opt = build_train_step(cfg, tc, peers=PEERS, device="cpu")
    params = _port_params(ref)
    state = opt.init(params)
    plan = BucketPlan.for_tree(params, BUCKET)
    rec = recovery.init_state(recovery.parse(mode), plan.num_buckets,
                              plan.bucket_elems, peers=PEERS)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    history = []
    for step in range(STEPS):
        draws = InjectedDraws(ref[f"{case}/{step}/sign"],
                              ref[f"{case}/{step}/mask"])
        old = rec
        params, state, rec, m = step_fn(
            params, state, data.host_batch(step, 0, 1), step, torch_key(0),
            draws=draws, rec_state=rec)
        for k in rec:                    # a new state, not the old storage
            assert rec[k].untyped_storage().data_ptr() != \
                old[k].untyped_storage().data_ptr()
        history.append(({k: float(v) for k, v in m.items()},
                        [p.detach().clone() for p in tree_leaves(params)],
                        [x.clone() for x in tree_leaves(state.m)],
                        {k: v.clone() for k, v in rec.items()}))
    return history


@pytest.mark.parametrize("case", list(CASES))
def test_recovery_steps_match_reference(ref, port_runs, case):
    history = port_runs(case)
    mode = CASES[case][2]
    for step, (metrics, leaves, moments, rec) in enumerate(history):
        for k in ("loss", "grad_norm"):
            want = float(ref[f"{case}/{step}/metric/{k}"])
            assert metrics[k] == pytest.approx(want, rel=1e-5), (step, k)
        want_frac = float(ref[f"{case}/{step}/metric/loss_frac"])
        assert want_frac > 0
        assert metrics["loss_frac"] == pytest.approx(want_frac, abs=1e-7)
        assert metrics["skipped"] == float(
            ref[f"{case}/{step}/metric/skipped"])
        # every lost entry was filled (the cache is zero at step 0)
        lost = (1 - ref[f"{case}/{step}/mask"].astype(np.float64)).sum()
        assert metrics["filled"] == lost > 0
        assert sorted(rec) == (["stale"] if mode == "stale"
                               else ["ef", "stale"])
        for k, v in rec.items():
            want = ref[f"{case}/{step}/rec/{k}"]
            assert v.shape == want.shape
            np.testing.assert_allclose(v.numpy(), want, atol=REC_TOL,
                                       rtol=0, err_msg=f"step {step} {k}")
        if "ef" in rec:
            assert float(np.abs(ref[f"{case}/{step}/rec/ef"]).max()) > 0
        for i, (leaf, m1) in enumerate(zip(leaves, moments)):
            np.testing.assert_allclose(m1.numpy(),
                                       ref[f"{case}/{step}/m/{i}"],
                                       atol=M_TOL, rtol=0,
                                       err_msg=f"step {step} moment {i}")
            np.testing.assert_allclose(leaf.numpy(),
                                       ref[f"{case}/{step}/param/{i}"],
                                       atol=PARAM_TOL, rtol=0,
                                       err_msg=f"step {step} leaf {i}")


def test_scan_and_pipelined_agree_exactly_with_stale(port_runs):
    piped = port_runs("ef_burst", sync_mode="pipelined")
    scanned = port_runs("ef_burst", sync_mode="scan")
    for (m_a, p_a, _, r_a), (m_b, p_b, _, r_b) in zip(piped, scanned):
        assert m_a == m_b
        for a, b in zip(p_a, p_b):
            assert torch.equal(a, b)
        for k in r_a:
            assert torch.equal(r_a[k], r_b[k])


def test_step_requires_the_state_its_config_arms():
    cfg = get_smoke("gpt2-paper")
    params = init_params(torch_key(0), cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    for mode, rec in (("ef", None), ("none", {"stale": torch.zeros(1)})):
        tc = TrainConfig(sync=OptiReduceConfig(recovery=mode,
                                               hadamard_block=BLOCK),
                         bucket_elems=BUCKET, seq_chunk=SEQ)
        step_fn, opt = build_train_step(cfg, tc, peers=PEERS, device="cpu")
        with pytest.raises(ValueError, match="rec_state"):
            step_fn(params, opt.init(params), data.host_batch(0, 0, 1), 0,
                    torch_key(0), rec_state=rec)
