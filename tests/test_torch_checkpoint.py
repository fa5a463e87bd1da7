"""Checkpoints of the port (``train/checkpoint.py``, the launcher's
``--ckpt-dir`` / ``--ckpt-every`` / ``--resume``) and their place beside
the JAX package's.

The reference runs once for the file in a subprocess on 4 forced host
devices. It writes a checkpoint of fp32, bfloat16 and int32 leaves with its
own ``save`` and tries its own ``restore`` of it, which cannot hand the
bfloat16 leaf to JAX (numpy reads it back as ``|V2`` bytes: a fault of the
reference, ROADMAP C). Then its launcher runs ``--smoke --steps 3
--ckpt-every 2 --ckpt-dir D`` (4 peers, drop 0, seq 16), which saves the
state after step 2 under the label 2 and after step 3 under 3; a copy of D
is taken, and the launcher runs ``--resume --steps 5`` on D (steps 3 and 4)
and, on a copy without ``step_00000003`` (a run cut after its periodic
save), ``--resume --steps 4``, which starts at step 2 and so runs step 2 a
second time (the other ROADMAP C fault, mirrored by the port).

The port restores the reference's files, so its launcher resumes from the
reference's state: the same two resumes on copies of D must end within the
step test's tolerances (``tests/test_torch_step.py``: AdamW moment 1e-6,
parameters 5e-2 x lr). At drop 0 the synced gradient does not depend on the
sign, so the port's own draws serve.
"""
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import recovery
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.optim.optimizers import AdamState, OptimizerConfig, \
    make_optimizer
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import tree_leaves
from repro_torch.core.keys import key as tkey

LR = 3e-4                       # the launcher's default
M_TOL = 1e-6
PARAM_TOL = 5e-2 * LR
COMMON = ["--smoke", "--dp", "4", "--seq-len", "16", "--global-batch", "8",
          "--log-every", "100"]

CHILD = r"""
import os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.launch import train as launch
from repro.train import checkpoint as ckpt

root, common = sys.argv[1], eval(sys.argv[2])
rng = np.random.default_rng(0)
tree = {"w": jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32)),
        "b": jnp.asarray(rng.standard_normal(7).astype(np.float32)
                         ).astype(jnp.bfloat16),
        "n": [jnp.arange(4, dtype=jnp.int32)]}
ckpt.save(os.path.join(root, "leaves"), 7, tree)
save = {"w": np.asarray(tree["w"]), "n": np.asarray(tree["n"][0]),
        "b_bits": np.asarray(tree["b"]).view(np.uint16)}
_, back, _ = ckpt.restore(os.path.join(root, "leaves"), tree)
save["b_restored_dtype"] = np.asarray(str(back["b"].dtype))
try:
    jnp.asarray(back["b"])
    save["b_error"] = np.asarray("")
except TypeError as e:
    save["b_error"] = np.asarray(str(e))

d = os.path.join(root, "D")
assert launch.main(common + ["--steps", "3", "--ckpt-every", "2",
                             "--ckpt-dir", d]) == 0
save["labels"] = np.asarray(sorted(os.listdir(d)))
shutil.copytree(d, os.path.join(root, "D_first"))
shutil.copytree(d, os.path.join(root, "D_cut"))
shutil.rmtree(os.path.join(root, "D_cut", "step_00000003"))
assert launch.main(common + ["--steps", "5", "--resume", "--ckpt-dir",
                             d]) == 0
assert launch.main(common + ["--steps", "4", "--resume", "--ckpt-dir",
                             os.path.join(root, "D_cut")]) == 0
np.savez(os.path.join(root, "ref.npz"), **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_checkpoint")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root),
                           repr(COMMON)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(root / "ref.npz") as z:
        return root, dict(z), proc.stdout


def _tree():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 5), generator=g),
              "b": torch.randn(7, generator=g).to(torch.bfloat16),
              "blocks": [{"k": torch.randn(4, generator=g)}]}
    opt = make_optimizer(OptimizerConfig())
    state = opt.init(params)
    state.m["w"].normal_(generator=g)
    rec = recovery.init_state(recovery.parse("ef"), 2, 8, peers=4)
    rec["ef"].normal_(generator=g)
    return params, state, rec


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def test_roundtrip_is_bitwise(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree, meta={"note": "x"})
    step, back, meta = ckpt.restore(str(tmp_path), _tree())
    assert (step, meta) == (3, {"note": "x"})
    assert isinstance(back[1], AdamState)
    assert sorted(back[2]) == ["ef", "stale"]
    _assert_bitwise(back, tree)
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == len(tree_leaves(tree))
    dtypes = [leaf["dtype"] for leaf in manifest["leaves"]]
    assert "bfloat16" in dtypes and "float32" in dtypes


def test_latest_step_and_gc(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nowhere")) is None
    tree = {"x": torch.arange(3.0)}
    for step in (1, 5, 2, 8, 9):
        ckpt.save(str(tmp_path), step, tree, keep=3)
    os.makedirs(tmp_path / "step_00000099.tmp")     # a write cut short
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert sorted(p.name for p in tmp_path.iterdir()
                  if not p.name.endswith(".tmp")) == \
        ["step_00000005", "step_00000008", "step_00000009"]


def test_async_save_copies_before_returning(tmp_path):
    """The next step updates the state in place: the checkpoint must hold
    the values of the moment ``save`` was called."""
    tree = _tree()
    want = [t.clone() for t in tree_leaves(tree)]
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(4, tree)
    for t in tree_leaves(tree):                  # the next step, in place
        t.add_(1)
    saver.wait()
    _, back, _ = ckpt.restore(str(tmp_path), _tree())
    for got, w in zip(tree_leaves(back), want):
        assert torch.equal(got, w)
    assert len(saver.copy_s) == len(saver.write_s) == 1


def test_async_write_error_raises_from_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncCheckpointer(str(blocker))
    saver.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                                  # the error is handed once


def test_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nowhere"), {"x": torch.zeros(1)})


def test_restores_onto_the_named_device(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.arange(4.0)})
    _, back, _ = ckpt.restore(str(tmp_path), {"x": torch.zeros(4)},
                              device=torch.device("cpu"))
    assert back["x"].device.type == "cpu"
    assert torch.equal(back["x"], torch.arange(4.0))


def test_reference_checkpoint_restores_bitwise(ref):
    root, z, _ = ref
    like = {"w": torch.zeros((3, 5)), "b": torch.zeros(7, dtype=torch.bfloat16),
            "n": [torch.zeros(4, dtype=torch.int32)]}
    step, back, _ = ckpt.restore(str(root / "leaves"), like)
    assert step == 7
    assert torch.equal(back["w"], torch.from_numpy(z["w"]))
    assert back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["b"].view(torch.int16).numpy()
                                  .view(np.uint16), z["b_bits"])
    assert torch.equal(back["n"][0], torch.from_numpy(z["n"]))


def test_reference_cannot_restore_its_bf16_leaves(ref):
    """ROADMAP C: the reference's restore hands back ``|V2`` bytes for a
    bfloat16 leaf, which JAX refuses."""
    _, z, _ = ref
    assert str(z["b_restored_dtype"]) == "|V2"
    assert "V2" in str(z["b_error"])


def _port_run(argv):
    return train.run([*COMMON, "--device", "cpu", *argv])


def _final_state(d, step):
    like = init_params(tkey(0), get_smoke("gpt2-paper"),
                       device="cpu")
    opt = make_optimizer(OptimizerConfig(lr=LR))
    got_step, (params, state), _ = ckpt.restore(str(d), (like,
                                                         opt.init(like)),
                                                step=step)
    assert got_step == step
    return params, state


@pytest.mark.parametrize("cut,steps,start", [(False, 5, 3), (True, 4, 2)])
def test_resume_matches_reference_launcher(ref, tmp_path, capsys, cut,
                                           steps, start):
    """The port resumes from the reference's files with the reference's
    numbering: from the final save (label 3) it runs steps 3 and 4; from
    the periodic save alone (label 2) it runs step 2 again, then 3."""
    root, _, _ = ref
    d = tmp_path / "D"
    shutil.copytree(root / "D_first", d)
    if cut:
        shutil.rmtree(d / "step_00000003")
    records = _port_run(["--steps", str(steps), "--resume", "--ckpt-dir",
                         str(d)])
    assert len(records) == steps - start
    assert f"resumed from step {start}" in capsys.readouterr().out
    p_got, s_got = _final_state(d, steps)
    p_want, s_want = _final_state(root / ("D_cut" if cut else "D"), steps)
    for a, b in zip(tree_leaves(s_got.m), tree_leaves(s_want.m)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=M_TOL, rtol=0)
    for a, b in zip(tree_leaves(p_got), tree_leaves(p_want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARAM_TOL,
                                   rtol=0)
    assert sorted(os.listdir(d)) == sorted(
        os.listdir(root / ("D_cut" if cut else "D")))


def test_launcher_writes_the_reference_labels(ref, tmp_path):
    _, z, _ = ref
    records = _port_run(["--steps", "3", "--ckpt-every", "2", "--ckpt-dir",
                         str(tmp_path)])
    assert len(records) == 3
    assert sorted(os.listdir(tmp_path)) == list(z["labels"]) == \
        ["step_00000002", "step_00000003"]


def test_resume_rejects_a_changed_recovery(tmp_path):
    """The manifest's leaf count guards the tree: a resume with another
    ``--recovery`` than the checkpoint's fails instead of misreading; the
    same ``--recovery`` resumes with the carried state."""
    def run(steps, *flags):
        return _port_run(["--steps", str(steps), "--drop-rate", "0.05",
                          "--ckpt-dir", str(tmp_path), *flags])

    first = run(1, "--recovery", "ef")
    assert math.isfinite(first[0]["loss"]) and first[0]["filled"] > 0
    for other in ("none", "stale"):
        with pytest.raises(ValueError, match="leaves"):
            run(2, "--resume", "--recovery", other)
    assert len(run(2, "--resume", "--recovery", "ef")) == 1
