"""The port's launcher with its default draws against the reference's
launcher: nothing injected.

The port draws the reference's threefry bits (``repro_torch/core/keys.py``),
so ``python -m repro_torch.launch.train --smoke --device cpu --steps 3
--drop-rate 0.05`` must drop the same packets, and initialise the same
weights, as the reference's launcher on 4 host devices. The reference runs
once, in one child, for ``optireduce``, ``optireduce_q``, ``--sync-mode
vmap`` and ``--optimizer adafactor``; the child wraps its ``jax.jit`` to
record each step's metrics before they are rounded for the log; the
port's four runs go on in this process meanwhile, on one torch thread.
Per step: ``loss_frac`` exactly, the loss and the gradient norm
within ``REL`` (fp32 arithmetic in another order, over three updates).
``init_params`` (in process, every family): the uniform ``a_log`` leaves
bit for bit; normal leaves are a draw within 2 ulp times a std, so within
3 ulp, and almost all equal.
"""
import json
import os
import subprocess
import sys

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.keys import key as tkey  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import param_table  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REL = 2e-4
COMMON = ["--smoke", "--steps", "3", "--drop-rate", "0.05", "--seq-len",
          "32", "--log-every", "1"]
RUNS = {"optireduce": [],
        "optireduce_q": ["--strategy", "optireduce_q"],
        "vmap": ["--sync-mode", "vmap"],
        "adafactor": ["--optimizer", "adafactor"]}

CHILD = r"""
import contextlib, io, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.launch import train

out = sys.argv[1]
runs, common = json.loads(sys.argv[2]), json.loads(sys.argv[3])
records = []


class RecordingJax:
    # the launcher's ``jax`` with ``jit`` wrapped: a step's metrics are
    # recorded before the launcher rounds them for its log line
    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jf = jax.jit(fn, **kw)

        def call(*a, **k):
            res = jf(*a, **k)
            if isinstance(res, tuple) and isinstance(res[-1], dict) \
                    and "loss_frac" in res[-1]:
                records.append({n: float(v) for n, v in res[-1].items()})
            return res
        return call


train.jax = RecordingJax()
res = {}
for name, extra in runs.items():
    records.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        assert train.main([*common, *extra]) == 0
    res[name] = list(records)
with open(out, "w") as f:
    json.dump(res, f)
print("child OK")
"""


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
    test: it runs while the init checks and the port's runs do."""
    out = tmp_path_factory.mktemp("torch_draws_launch") / "ref.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", CHILD, str(out),
                                 json.dumps(RUNS), json.dumps(COMMON)],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def port(child):
    """The port's launcher runs, while the reference's child runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: train.run([*COMMON, "--device", "cpu", *extra])
                for name, extra in RUNS.items()}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(child, port):
    proc, out = child
    assert proc.wait(timeout=900) == 0, out.with_suffix(".log").read_text()
    with open(out) as f:
        return json.load(f)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _inits(table):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node.init)
    walk(table)
    return out


@pytest.mark.parametrize("arch", ["gpt2-paper", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "qwen2-moe-a2.7b"])
def test_init_params_match_reference(arch):
    jp = jax.tree.leaves(jinit(jax.random.PRNGKey(0), jget_smoke(arch)))
    cfg = get_smoke(arch)
    got = tree_leaves(init_params(tkey(0), cfg, device="cpu"))
    inits = _inits(param_table(cfg))
    assert len(got) == len(jp) == len(inits)
    for g, w, init in zip(got, jp, inits):
        g32 = g.float().numpy()
        w32 = np.asarray(w, np.float32)
        assert g32.shape == w32.shape
        if init in ("zeros", "ones"):
            np.testing.assert_array_equal(g32, w32)
        elif init == "alog":
            # log(U[1, 16)): the uniform and XLA's log, bit for bit
            np.testing.assert_array_equal(g32, w32)
        else:
            # the normal draw within 2 ulp (test_torch_threefry), then
            # scaled by std: one more rounding, so 3 ulp of the leaf
            assert _ulp(g32, w32).max() <= 3, init
            assert np.mean(g32 != w32) < 1e-3


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_matches_reference_without_injection(ref, port, name):
    records = port[name]
    want = ref[name]
    assert len(records) == len(want) == 3
    assert any(w["loss_frac"] > 0 for w in want)
    for got, w in zip(records, want):
        assert got["loss_frac"] == w["loss_frac"]
        assert got["skipped"] == w["skipped"]
        assert got["loss"] == pytest.approx(w["loss"], rel=REL)
        assert got["grad_norm"] == pytest.approx(w["grad_norm"], rel=REL)
