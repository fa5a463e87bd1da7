"""The whole slice on the quantized exchange: two ``optireduce_q`` training
steps of the port against two of the JAX ``build_train_step`` on the same
parameters, batches and draws.

The reference runs on 4 forced host devices in one subprocess (once for the
file, results handed over as an ``.npz``): ``gpt2-smoke``, 4 data ranks,
``optireduce_q`` (8-bit codes) with ``hadamard_block=256`` and
``bucket_elems=16384`` (8 buckets, so the pipelined steady state runs),
AdamW, under ``tail`` drops at 0.05 and without drops. The child records the
reference's draws — each bucket's sign, each receiver's arrival mask, and
the stage-1 and stage-2 quantization noises (``fold_in(bucket_key, 3)`` and
``fold_in(bucket_key, 4)``) — derived from its keys as the step derives
them, and the port is handed those (:class:`InjectedDraws`). Quantization
is not linear, so the sign matters here even without drops.

Each port step starts from the reference's state before it (the shared
initial parameters, then the reference's parameters and AdamW moments after
step 0). A code may differ by one where ``floor`` sits on a boundary
(``test_torch_quant_sync.py``: 2 of 163,840 there), and on a free run one
such code at step 0 moves a few parameters by up to lr, which makes every
gradient of step 1 differ: starting each step from the same state keeps the
comparison sharp.

Tolerances. Loss agrees to 1e-5 relative and loss_frac to 1e-7 (the same
masks). A differing code moves the decoded gradient of its Hadamard block
by one grid step / sqrt(block), and a grid step is at most 2 x (the block's
L2 norm) / 255, at most 2 x the clipped gradient norm / 255. So:

* the AdamW first moment (0.1 x the synced, clipped gradient, plus 0.9 x
  the shared moment before) agrees to 1e-6 (fp32 rounding, as for
  ``optireduce``) except on at most four blocks' worth of entries a step,
  which agree to 0.1 x four such steps;
* grad_norm agrees to 1e-5 relative, plus 2 / 255 for every block whose
  moment moved;
* the parameters agree to what AdamW makes of the moments' difference.
  With u = m_hat / (sqrt(v_hat) + eps) and |u| <= 1.0003 for either run
  (at most two steps at these betas), |u_port - u_ref| <= (|dm_hat| +
  1.0003 |d sqrt(v_hat)|) / max(sqrt(v_hat) + eps), and the parameters
  differ by lr times that, within 5e-2 x lr of fp32 rounding. On entries
  whose gradient is quantization noise around zero (embedding rows no
  token of the batch touched) that is large: sqrt(v_hat) is ~1e-10 there,
  below eps, so a 1e-10 rounding difference moves the update by ~1e-2 of
  lr and more. Everywhere the difference is at most 2.01 x lr.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.allreduce import OptiReduceConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, build_train_step
from repro_torch.core.keys import key as torch_key
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax

STEPS = 2
PEERS = 4
BLOCK = 256
BUCKET = 16_384
SEQ = 32
GLOBAL_BATCH = 8
LR = 1e-2
M_TOL = 1e-6
PARAM_TOL = 5e-2 * LR
FLIP_BLOCKS = 4
CASES = {"tail": ("tail", 0.05), "nodrop": ("tail", 0.0)}

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
cases = {"tail": ("tail", 0.05), "nodrop": ("tail", 0.0)}
cfg = get_smoke("gpt2-paper")
mesh = make_mesh((peers,), ("data",))
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=gb, seed=0))
key = jax.random.PRNGKey(0)
params0 = init_params(key, cfg)
save = {}
for i, leaf in enumerate(jax.tree.leaves(params0)):
    save[f"init/{i}"] = np.asarray(leaf)
for name, (pattern, rate) in cases.items():
    sync = OptiReduceConfig(strategy="optireduce_q", drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=block)
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
    lpad = plan.bucket_elems + (-plan.bucket_elems) % (n * block)
    s = lpad // n
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
        # the step's draws, derived exactly as the step derives them
        skey = jax.random.fold_in(key, step)
        sync_key = jax.random.fold_in(skey, 7)
        bkeys = bucket_keys(sync_key, plan.num_buckets)
        nb = plan.num_buckets
        save[f"{name}/{step}/sign"] = np.stack(
            [np.asarray(rademacher_sign(bkeys[b], block)) for b in range(nb)])
        save[f"{name}/{step}/noise3"] = np.stack([np.asarray(
            jax.random.uniform(jax.random.fold_in(bkeys[b], 3),
                               (lpad // block, block))) for b in range(nb)])
        save[f"{name}/{step}/noise4"] = np.stack([np.asarray(
            jax.random.uniform(jax.random.fold_in(bkeys[b], 4),
                               (s // block, block))) for b in range(nb)])
        if rate > 0:
            masks = np.stack([np.stack([np.asarray(drops.make_mask(
                pattern, jax.random.fold_in(bkeys[b], r), n, s, rate=rate,
                packet_elems=sync.packet_elems, self_index=r))
                for r in range(n)]) for b in range(nb)])
            save[f"{name}/{step}/mask"] = masks.astype(np.uint8)
np.savez(out_path, **save)
print("child OK")
"""


class InjectedDraws:
    """Serves the reference's recorded draws for one step."""

    def __init__(self, ref, prefix: str):
        self._sign = torch.from_numpy(ref[f"{prefix}/sign"])
        self._noise = {3: torch.from_numpy(ref[f"{prefix}/noise3"]),
                       4: torch.from_numpy(ref[f"{prefix}/noise4"])}
        mask = ref.get(f"{prefix}/mask")
        self._mask = None if mask is None else torch.from_numpy(
            mask.astype(np.float32))

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
    out = tmp_path_factory.mktemp("torch_quant_step") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), str(STEPS), str(PEERS),
         str(BLOCK), str(BUCKET), str(SEQ), str(GLOBAL_BATCH), str(LR)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _leaves(ref, prefix):
    n = len([k for k in ref if k.startswith(prefix + "/")])
    return [ref[f"{prefix}/{i}"] for i in range(n)]


def _like():
    return init_params(torch.Generator(), get_smoke("gpt2-paper"),
                       device="cpu")


def _state_before(ref, case, step, opt):
    """The parameters and AdamW state a step starts from: the shared
    initial parameters, or the reference's after the previous step."""
    like = _like()
    if step == 0:
        params = params_from_jax(tree_unflatten(like, _leaves(ref, "init")))
        return params, opt.init(params)
    prev = f"{case}/{step - 1}"
    return params_from_jax(
        tree_unflatten(like, _leaves(ref, f"{prev}/param")),
        (tree_unflatten(like, _leaves(ref, f"{prev}/m")),
         tree_unflatten(like, _leaves(ref, f"{prev}/v"))))


def _step_fn(case, sync_mode="pipelined"):
    pattern, rate = CASES[case]
    cfg = get_smoke("gpt2-paper")
    sync = OptiReduceConfig(strategy="optireduce_q", drop_rate=rate,
                            drop_pattern=pattern, hadamard_block=BLOCK)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=LR),
                     bucket_elems=BUCKET, seq_chunk=SEQ, sync_mode=sync_mode)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH, seed=0))
    step_fn, opt = build_train_step(cfg, tc, peers=PEERS, device="cpu")
    return step_fn, opt, data


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("case", list(CASES))
def test_quant_step_matches_reference(ref, case, step):
    step_fn, opt, data = _step_fn(case)
    params, state = _state_before(ref, case, step, opt)
    params, state, metrics = step_fn(
        params, state, data.host_batch(step, 0, 1), step, torch_key(0),
        draws=InjectedDraws(ref, f"{case}/{step}"))
    metrics = {k: float(v) for k, v in metrics.items()}
    want = {k: float(ref[f"{case}/{step}/metric/{k}"])
            for k in ("loss", "grad_norm", "loss_frac", "skipped")}
    assert metrics["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert metrics["loss_frac"] == pytest.approx(want["loss_frac"],
                                                 abs=1e-7)
    assert (want["loss_frac"] > 0) == (case != "nodrop")
    assert metrics["skipped"] == want["skipped"]
    clip = min(want["grad_norm"], OptimizerConfig().grad_clip)
    flip = 2 * clip / 255 / math.sqrt(BLOCK)
    ocfg = OptimizerConfig()
    bc1 = 1 - ocfg.beta1 ** (step + 1)
    bc2 = 1 - ocfg.beta2 ** (step + 1)
    moved = 0
    for i, (leaf, m1, v1) in enumerate(zip(tree_leaves(params),
                                           tree_leaves(state.m),
                                           tree_leaves(state.v))):
        m_ref = ref[f"{case}/{step}/m/{i}"]
        v_ref = ref[f"{case}/{step}/v/{i}"]
        m_err = np.abs(m1.numpy() - m_ref)
        off = m_err > M_TOL
        moved += int(np.count_nonzero(off))
        assert np.all(m_err <= M_TOL + 0.1 * FLIP_BLOCKS * flip), i
        sv_port = np.sqrt(v1.numpy() / bc2)
        sv_ref = np.sqrt(v_ref / bc2)
        du = (m_err / bc1 + 1.0003 * np.abs(sv_port - sv_ref)) / (
            np.maximum(sv_port, sv_ref) + ocfg.eps)
        p_err = np.abs(leaf.detach().numpy()
                       - ref[f"{case}/{step}/param/{i}"])
        assert np.all(p_err <= LR * du + PARAM_TOL), i
        assert np.all(p_err <= 2.01 * LR), i
    assert moved <= FLIP_BLOCKS * BLOCK
    g_tol = 1e-5 + 2 / 255 * math.ceil(moved / BLOCK)
    assert metrics["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=g_tol)


def _run_port(ref, case, *, sync_mode):
    step_fn, opt, data = _step_fn(case, sync_mode)
    params, state = _state_before(ref, case, 0, opt)
    history = []
    for step in range(STEPS):
        params, state, m = step_fn(
            params, state, data.host_batch(step, 0, 1), step, torch_key(0),
            draws=InjectedDraws(ref, f"{case}/{step}"))
        history.append(({k: float(v) for k, v in m.items()},
                        [p.detach().clone() for p in tree_leaves(params)]))
    return history


def test_quant_scan_and_pipelined_agree_exactly(ref):
    piped = _run_port(ref, "tail", sync_mode="pipelined")
    scanned = _run_port(ref, "tail", sync_mode="scan")
    for (m_a, p_a), (m_b, p_b) in zip(piped, scanned):
        assert m_a == m_b
        for a, b in zip(p_a, p_b):
            assert torch.equal(a, b)
