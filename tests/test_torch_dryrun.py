"""``repro_torch.launch.dryrun`` against the reference's dry run: every
arch x shape cell of the 16 x 16 production mesh, the exact affine fit of
the cost model, and ``matmul_flops`` against a count from the layer
shapes.

The reference runs once for the file in a subprocess with 512 forced host
devices (as ``src/repro/launch/dryrun.py`` forces them), compiling
nothing: for each cell its fields that need no XLA (``params``,
``active_params``, ``status`` and ``reason`` from ``shape_applicable``,
``dp_mode`` and ``microbatch`` from its ``make_train_cell``, ``serve_plan``
from ``plan_serving``) and one device's bytes of the cell's state: the
abstract parameters and optimizer moments (``abstract_params``,
its ``make_train_cell``'s) under the shardings its ``build_train_step`` hands
out, and for decode the parameters and ``abstract_state`` under
``build_serve_step``'s, each leaf's bytes over ``NamedSharding.shard_shape``
(prefill: the parameters under ``param_specs``). The bytes are equal
exactly; ``matmul_flops`` is an exact count (integers in fp64).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ARCHS, SHAPES, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HostMesh, make_production_mesh

CELLS = [(a, s) for a in ARCHS for s in SHAPES]

CHILD = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from jax.sharding import NamedSharding
from repro.configs import SHAPES, get_config, shape_applicable
from repro.launch import dryrun as jd
from repro.models import abstract_params, active_params, count_params
from repro.models import param_specs
from repro.serve.engine import abstract_state, build_serve_step, plan_serving
from repro.train.trainer import build_train_step

out_path = sys.argv[1]
cells = eval(sys.argv[2])
mesh = jd.make_production_mesh()
dp_axes = ("data",)


def nbytes(tree, shardings):
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs), (len(leaves), len(shs))
    return int(sum(np.prod(s.shard_shape(a.shape), dtype=np.int64)
                   * np.dtype(a.dtype).itemsize
                   for a, s in zip(leaves, shs)))


out = {}
for arch, sname in cells:
    cfg, shape = get_config(arch), SHAPES[sname]
    plan = dict(jd.PLAN[arch])
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": sname, "kind": shape.kind,
           "mesh": "x".join(str(s) for s in mesh.devices.shape),
           "params": count_params(cfg), "active_params": active_params(cfg),
           "strategy": "optireduce", "drop_rate": 0.01}
    if not ok:
        rec.update(status="skipped", reason=why)
        out[f"{arch}/{sname}"] = rec
        continue
    rec["status"] = "ok"
    b = {"params": 0, "opt_state": 0, "decode_state": 0}
    if shape.kind == "train":
        _, args, tc = jd.make_train_cell(cfg, shape, mesh,
                                         strategy="optireduce",
                                         drop_rate=0.01, plan=plan)
        rec["dp_mode"], rec["microbatch"] = tc.dp_mode, tc.microbatch
        a_params, a_opt, a_batch = args[:3]
        make_step, opt, _ = build_train_step(cfg, tc, mesh)
        _, sh = make_step(a_opt, a_batch)
        b["params"] = nbytes(a_params, sh["params"])
        b["opt_state"] = nbytes(a_opt, sh["opt"])
    elif shape.kind == "decode":
        splan = plan_serving(mesh, shape.global_batch)
        rec["serve_plan"] = dataclasses.asdict(splan)
        fsdp = plan.get("serve_fsdp", False)
        a_state = abstract_state(cfg, shape, splan)
        _, sh = build_serve_step(cfg, mesh, splan, weight_fsdp=fsdp,
                                 moe_stationary=plan.get("moe_stationary",
                                                         False))(a_state)
        a_params = abstract_params(cfg, tp=16,
                                   fsdp_axes=dp_axes if fsdp else None)
        b["params"] = nbytes(a_params, sh["params"])
        b["decode_state"] = nbytes(a_state, sh["state"])
    else:
        fx = dp_axes if plan.get("serve_fsdp", False) else None
        specs = param_specs(cfg, tp=16, fsdp_axes=fx)
        b["params"] = nbytes(
            abstract_params(cfg, tp=16, fsdp_axes=fx),
            jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    b["total"] = sum(b.values())
    rec["state_bytes_per_device"] = b
    out[f"{arch}/{sname}"] = rec
with open(out_path, "w") as f:
    json.dump(out, f)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dryrun") / "ref.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), repr(CELLS)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_fields_and_state_bytes_match_reference(ref, arch, shape):
    """Every cell of the 16 x 16 mesh runs on ``meta`` (skips as the
    reference's ``shape_applicable`` gives them), its plan fields equal the
    reference's, and one device's bytes of parameters, optimizer moments
    and decode state equal the reference's shardings' shard shapes."""
    rec = dryrun.run_cell(arch, shape, make_production_mesh(),
                          with_cost_model=False)
    want = ref[f"{arch}/{shape}"]
    assert rec["status"] == want["status"], rec.get("error")
    got = {k: rec[k] for k in want}
    if "serve_plan" in got:
        got["serve_plan"] = json.loads(json.dumps(got["serve_plan"]))
    assert got == want


def test_cost_model_fit_is_exact():
    """The four-point fit recovers an affine metric exactly (the
    reference's ``tests/test_dryrun_tools.py`` case), and the cost model
    of a 4-layer gpt2-smoke cell of each kind, fitted at 1 and 2 layers,
    equals ``matmul_flops`` counted directly at that depth and batch."""
    def m(d, b):
        return 5.0 + b * 3.0 + d * (7.0 + b * 11.0)
    meas = {(d, b): {"x": m(d, b)} for d in (1, 2) for b in (16, 32)}
    assert dryrun.fit_affine(meas, (1, 2), (16, 32), 64, 256)["x"] == \
        pytest.approx(m(64, 256))
    mesh = HostMesh(("data", "model"), (2, 2))
    cfg = dataclasses.replace(get_smoke("gpt2-paper"), n_layers=4,
                              attn_chunk=0)
    plan = {"dp_mode": "replicated", "microbatch": 4, "mom": "f32"}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", 32, 6, kind)
        fitted = dryrun.cost_model(cfg, shape, mesh, plan)
        assert fitted["_model"] == {"depths": [1, 2], "batches": [2, 4],
                                    "eval_at": [4, 6]}
        assert fitted["matmul_flops"] == dryrun.matmul_flops(
            cfg, shape, mesh, plan), kind


def _dense_flops(cfg, kind, b, s):
    """GEMM and attention FLOPs of a dense, tied-embedding model for ``b``
    sequences of ``s`` positions (decode: one token against ``s`` cached
    positions): 2 a multiply-add; training without recomputation counts
    the forward pass and the backward pass (two products a product), so
    three forwards' worth."""
    d, hq, hkv, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.dh, cfg.d_ff, cfg.vocab_size)
    proj = 2 * d * (hq + 2 * hkv) * dh + 2 * hq * dh * d + 3 * 2 * d * f
    if kind == "decode":
        attn = 2 * 2 * hq * dh * s
        return b * (cfg.n_layers * (proj + attn) + 2 * d * v)
    attn = 2 * 2 * hq * dh * s * s
    fwd = cfg.n_layers * (b * s * proj + b * attn)
    if kind == "prefill":
        return fwd + b * 2 * d * v
    return 3 * (fwd + b * s * 2 * d * v)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("tp", [1, 2])
def test_matmul_flops_of_a_dense_cell_equal_the_layer_count(kind, tp):
    """gpt2-smoke on a (data 2, model tp) mesh, global batch 4: one data
    peer's 2 sequences (decode: 2 rows against a 32-position cache) give
    the FLOPs counted from the layer shapes, at tp 1 and over tp 2 (the
    tp group's products together). Training recomputes each layer in its
    backward pass (``remat``, the plans' default) up to the last product
    the backward needs (torch's checkpoint stops early), so it counts
    between three and four forwards; without ``remat`` exactly three."""
    cfg = dataclasses.replace(get_smoke("gpt2-paper"), attn_chunk=0)
    mesh = HostMesh(("data", "model"), (2, tp))
    plan = {"dp_mode": "replicated", "microbatch": 2, "mom": "f32",
            "remat": False}
    shape = ShapeConfig("s", 32, 4, kind)
    want = _dense_flops(cfg, kind, 2, 32)
    assert dryrun.matmul_flops(cfg, shape, mesh, plan) == want
    if kind == "train":
        remat = dryrun.matmul_flops(cfg, shape, mesh, {**plan, "remat": True})
        assert want < remat < want * 4 / 3


def test_cli_runs_every_cell(tmp_path, capsys):
    """``--all --no-cost-model --out`` writes all 40 cells, 0 errors."""
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--all", "--no-cost-model", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 40
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    assert "done: 40 cells, 0 errors" in capsys.readouterr().out


def test_cli_refuses_bucket_elems(capsys):
    """``--bucket-elems`` sizes the reference's sync buckets for its
    collective bytes, which the port does not model: the flag is refused
    with a message, never silently ignored."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "glm4-9b", "--shape", "train_4k",
                     "--bucket-elems", "1048576"])
    assert e.value.code == 2
    assert "collective bytes" in capsys.readouterr().err
