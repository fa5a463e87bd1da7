"""One OptiReduce training step of the MoE, SSM, hybrid and dense-residual
MoE families through ``build_train_step`` against the JAX package's, both
data-parallel modes, and the FSDP path of a leaf no gather site reaches.

The reference runs once for the file in a subprocess on 4 forced host
devices (results handed over as an ``.npz``): one AdamW step of
qwen2-moe-smoke, mamba2-smoke, jamba-smoke and arctic-smoke, 4 data
peers, ``optireduce`` with tail drops 0.05, replicated and
``dp_mode='fsdp'``, and llava-smoke under FSDP without a prefix (its
``frontend_proj``, a sharded leaf no gather site reaches, gets a zero
gradient; AdamW's decay still moves it), all from ``init_params(PRNGKey(0),
...)``. The port's step gets the reference's draws (:class:`JaxDraws`, the
port's key path folded into ``PRNGKey`` in this process), as
``tests/test_torch_fsdp.py`` does. ``skip_threshold`` is 0.9, as there: a
smoke model's small buckets lose whole rows to a timed-out receiver, and
the guard would skip the step. The child writes the initial parameters
first and goes on with its steps while the port's steps run.

Tolerances: loss and grad_norm 1e-5 relative, loss_frac 1e-7 (the same
masks); the AdamW moments within 1e-4 of each leaf's largest magnitude
(fp32 sums in other orders) plus 1e-9 (m) and 1e-12 (v) absolute for an
all-zero leaf; the parameters within 1e-1 x lr, the bound
``tests/test_torch_fsdp.py`` sets and explains (AdamW's first update is lr
g / (|g| + eps), steep near |g| = eps), or, where an entry's gradient is
that close to zero, within what the first update makes of the two runs'
measured moments, lr (|dm_hat| + |d sqrt(v_hat)|) / (min sqrt(v_hat) +
eps), plus 1e-6 (the update's own fp32 rounding).
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import drops as jdrops  # noqa: E402
from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.allreduce import OptiReduceConfig  # noqa: E402
from repro_torch.core.keys import key as torch_key  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import abstract_params  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402
from repro_torch.train.trainer import TrainConfig, build_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

REL_TOL = 1e-4
STEP_ARCHS = ("qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-v0.1-52b",
              "arctic-480b")
MODES = ("replicated", "fsdp")
# (arch, dp_mode) of the trainer steps: the four families both ways, and
# llava-smoke under FSDP, whose frontend_proj no gather site reaches
STEP_CASES = [(a, m) for a in STEP_ARCHS for m in MODES] + [
    ("llava-next-mistral-7b", "fsdp")]
PEERS, BLOCK, BUCKET, RATE, SKIP, LR = 4, 256, 16_384, 0.05, 0.9, 1e-2
STEP_SEQ, STEP_BATCH = 16, 8
PARAM_TOL = 1e-1 * LR

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.core.allreduce import OptiReduceConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

out_path, init_path = sys.argv[1], sys.argv[11]
step_cases = eval(sys.argv[2])
peers, block, bucket = (int(v) for v in sys.argv[3:6])
rate, skip, lr = (float(v) for v in sys.argv[6:9])
step_seq, step_batch = int(sys.argv[9]), int(sys.argv[10])
key = jax.random.PRNGKey(0)
save = {}
mesh = make_mesh((peers,), ("data",))
for arch in sorted({a for a, _ in step_cases}):
    for i, leaf in enumerate(jax.tree.leaves(init_params(key,
                                                        get_smoke(arch)))):
        save[f"init/{arch}/{i}"] = np.asarray(leaf)
np.savez(out_path + ".tmp.npz", **save)
os.replace(out_path + ".tmp.npz", init_path)     # the port starts from it
for arch, mode in step_cases:
    cfg = get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=step_seq,
                                  global_batch=step_batch, seed=0))
    params0 = init_params(key, cfg)
    sync = OptiReduceConfig(drop_rate=rate, hadamard_block=block,
                            skip_threshold=skip)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=lr),
                     bucket_elems=bucket, seq_chunk=step_seq,
                     dp_mode=mode)
    make_step, opt, _ = build_train_step(cfg, tc, mesh)
    step_fn, sh = make_step(jax.eval_shape(opt.init, params0),
                            data.host_batch(0, 0, 1))
    params = jax.device_put(params0, sh["params"])
    opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
    batch = jax.device_put(data.host_batch(0, 0, 1), sh["batch"])
    params, opt_state, m = jax.jit(step_fn)(
        params, opt_state, batch, jnp.asarray(0, jnp.int32), key)
    pre_ = f"step/{arch}/{mode}"
    for k, v in m.items():
        save[f"{pre_}/metric/{k}"] = np.asarray(v)
    for part, tree in (("param", params), ("m", opt_state.m),
                       ("v", opt_state.v)):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            save[f"{pre_}/{part}/{i}"] = np.asarray(leaf)
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
    folds ``fold_in(key, b)`` for bucket b or ``fold_in(step_key, l)`` for
    layer l's gather sites."""

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


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """The reference's child, started first: ``(proc, out)``."""
    out = tmp_path_factory.mktemp("torch_families_step")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "child.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, str(out / "ref.npz"),
             repr(STEP_CASES),
             *(str(v) for v in (PEERS, BLOCK, BUCKET, RATE, SKIP, LR,
                                STEP_SEQ, STEP_BATCH)),
             str(out / "init.npz")],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finished(proc, out) -> None:
    assert proc.wait(timeout=900) == 0, (out / "child.log").read_text()


@pytest.fixture(scope="module")
def port(child):
    """The port's step of every case, from the reference's initial
    parameters, while the child runs its steps."""
    proc, out = child
    t0 = time.monotonic()
    while not (out / "init.npz").exists():
        if proc.poll() is not None:
            _finished(proc, out)
        assert time.monotonic() - t0 < 900, "no initial parameters"
        time.sleep(0.2)
    with np.load(out / "init.npz") as z:
        init = dict(z)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {case: _run_step(init, *case) for case in STEP_CASES}, init
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(child, port):
    proc, out = child
    _finished(proc, out)
    with np.load(out / "ref.npz") as z:
        return dict(z)


def _port_params(ref, arch):
    like = abstract_params(get_smoke(arch))
    n = len(tree_leaves(like))
    return params_from_jax(tree_unflatten(
        like, [ref[f"init/{arch}/{i}"] for i in range(n)]))


def _close(got: torch.Tensor, want: np.ndarray, what: str,
           floor: float = 0.0) -> None:
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().to(torch.float32).numpy() - want).max())
    assert err <= REL_TOL * scale + floor, (what, err, scale)


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke models are too small to gain from torch's intra-op
    threads, and under the suite's parallel workers those threads contend
    for the cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_step(ref, arch, mode):
    cfg = get_smoke(arch)
    sync = OptiReduceConfig(drop_rate=RATE, hadamard_block=BLOCK,
                            skip_threshold=SKIP)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=LR),
                     bucket_elems=BUCKET, seq_chunk=STEP_SEQ, dp_mode=mode)
    step_fn, opt = build_train_step(cfg, tc, peers=PEERS, device="cpu")
    params = _port_params(ref, arch)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=STEP_SEQ, global_batch=STEP_BATCH,
                                  seed=0))
    sync = dataclasses.replace(tc.sync, pod_axis=None)
    params, state, m = step_fn(params, state, data.host_batch(0, 0, 1), 0,
                               torch_key(0),
                               draws=JaxDraws((0, 0, 7), sync),
                               site_draws=JaxDraws((0, 0), sync))
    return {k: float(v) for k, v in m.items()}, params, state


@pytest.mark.parametrize("arch,mode", STEP_CASES)
def test_train_step_matches_reference(ref, port, arch, mode):
    (metrics, params, state), init = port[0][arch, mode], port[1]
    pre = f"step/{arch}/{mode}"
    for k in ("loss", "grad_norm"):
        assert metrics[k] == pytest.approx(float(ref[f"{pre}/metric/{k}"]),
                                           rel=1e-5), k
    assert metrics["loss_frac"] == pytest.approx(
        float(ref[f"{pre}/metric/loss_frac"]), abs=1e-7)
    assert metrics["skipped"] == float(ref[f"{pre}/metric/skipped"])
    assert math.isfinite(metrics["loss"])
    ocfg = OptimizerConfig(lr=LR)
    bc1, bc2 = 1 - ocfg.beta1, 1 - ocfg.beta2          # after one step
    for i, (p, m, v) in enumerate(zip(*(tree_leaves(t) for t in (
            params, state.m, state.v)))):
        m_ref, v_ref = ref[f"{pre}/m/{i}"], ref[f"{pre}/v/{i}"]
        _close(m, m_ref, f"m {i}", floor=1e-9)
        _close(v, v_ref, f"v {i}", floor=1e-12)
        # what AdamW's first update makes of the moments' difference: with
        # m_hat = g and sqrt(v_hat) = |g|, |du| <= (|dm_hat| + |ds|) /
        # (min s + eps)
        s_p, s_r = np.sqrt(v.numpy() / bc2), np.sqrt(v_ref / bc2)
        du = (np.abs(m.numpy() - m_ref) / bc1 + np.abs(s_p - s_r)) / (
            np.minimum(s_p, s_r) + ocfg.eps)
        err = np.abs(p.detach().numpy() - ref[f"{pre}/param/{i}"])
        ok = (err <= PARAM_TOL) | (err <= LR * du + 1e-6)
        assert ok.all(), (f"{pre} leaf {i}", float(err.max()))
    if "frontend_proj" in params:
        # no gradient reaches it; AdamW's decoupled decay still moves it
        w0 = _port_params(init, arch)["frontend_proj"]
        assert not state.m["frontend_proj"].any()
        torch.testing.assert_close(params["frontend_proj"],
                                   w0 * (1 - LR * ocfg.weight_decay))
