"""Adafactor under FSDP: what the reference does, and both forms of the port
held to it.

The reference's FSDP step updates each device's shard inside ``shard_map``
but declares Adafactor's factored statistics replicated (``P()``: its
optimizer's state is not shaped like the parameters), so each device's row
and column statistics keep the global shapes while its gradient has the
shard's. One child process runs the reference's FSDP step with Adafactor
on gpt2-smoke over 4 host devices and reports how it ends: it fails as it
traces, with a broadcasting ``TypeError`` (ROADMAP C). So the port refuses
FSDP with Adafactor, in the stacked form, over a process group and in the
launcher, with a ``ValueError`` that names the reference's failure.
"""
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_smoke
from repro_torch.core.pipeline import OptiReduceConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, build_train_step

CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.compat import make_mesh
from repro.configs import get_smoke
from repro.core.allreduce import OptiReduceConfig
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import init_params
from repro.optim.optimizers import OptimizerConfig
from repro.train.trainer import TrainConfig, build_train_step

cfg = get_smoke("gpt2-paper")
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=8, seed=0))
key = jax.random.PRNGKey(0)
params = init_params(key, cfg)
tc = TrainConfig(sync=OptiReduceConfig(drop_rate=0.01, hadamard_block=256),
                 optimizer=OptimizerConfig(name="adafactor"),
                 bucket_elems=16384, seq_chunk=32, dp_mode="fsdp")
make_step, opt, _ = build_train_step(cfg, tc, make_mesh((4, 1),
                                                        ("data", "model")))
step_fn, sh = make_step(jax.eval_shape(opt.init, params),
                        data.host_batch(0, 0, 1))
params = jax.device_put(params, sh["params"])
opt_state = jax.jit(opt.init, out_shardings=sh["opt"])(params)
batch = jax.device_put(data.host_batch(0, 0, 1), sh["batch"])
try:
    out = jax.jit(step_fn)(params, opt_state, batch,
                           jnp.asarray(0, jnp.int32), key)
    jax.block_until_ready(out)
    print("RESULT ran")
except Exception as e:
    print("RESULT failed", type(e).__name__, str(e).splitlines()[0])
"""


@pytest.fixture(scope="module")
def reference():
    """How the reference's FSDP step with Adafactor ends: ``("ran",)`` or
    ``("failed", error type, first line of its message)``."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env,
                          capture_output=True, text=True, timeout=600)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, proc.stdout[-2000:] + proc.stderr[-4000:]
    word, _, rest = line[len("RESULT "):].partition(" ")
    if word == "ran":
        return ("ran",)
    kind, _, message = rest.partition(" ")
    return ("failed", kind, message)


def test_reference_fsdp_adafactor_fails_on_the_shard_shapes(reference):
    """The factored statistics (global shapes) meet a shard's row or
    column means: the reference's step does not trace."""
    assert reference[:2] == ("failed", "TypeError")
    assert "incompatible shapes for broadcasting" in reference[2]


def _tc():
    return TrainConfig(sync=OptiReduceConfig(drop_rate=0.01,
                                             hadamard_block=256),
                       optimizer=OptimizerConfig(name="adafactor"),
                       dp_mode="fsdp", bucket_elems=16_384, seq_chunk=32)


def _names_the_reference_failure(err, reference):
    text = str(err.value)
    assert reference[1] in text and reference[2].split(":")[0] in text
    assert "ROADMAP C" in text


def test_stacked_form_refuses_fsdp_adafactor(reference):
    with pytest.raises(ValueError) as err:
        build_train_step(get_smoke("gpt2-paper"), _tc(),
                         make_host_mesh(dp=4), device="cpu")
    _names_the_reference_failure(err, reference)


def test_rank_form_refuses_fsdp_adafactor(reference, tmp_path):
    """Over a process group (a world of one gloo rank in this process)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError) as err:
            build_train_step(get_smoke("gpt2-paper"), _tc(),
                             make_host_mesh(dp=1), device="cpu",
                             group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    _names_the_reference_failure(err, reference)


def test_launcher_refuses_fsdp_adafactor(reference):
    with pytest.raises(ValueError) as err:
        launch_train.run(["--smoke", "--device", "cpu", "--steps", "1",
                          "--seq-len", "32", "--dp-mode", "fsdp",
                          "--optimizer", "adafactor"])
    _names_the_reference_failure(err, reference)


def test_replicated_adafactor_still_builds():
    """Only the FSDP combination is refused."""
    tc = TrainConfig(optimizer=OptimizerConfig(name="adafactor"))
    step_fn, opt = build_train_step(get_smoke("gpt2-paper"), tc,
                                    make_host_mesh(dp=4), device="cpu")
    assert not opt.state_like_params
