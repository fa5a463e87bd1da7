"""Every architecture of the reference in the port: the configs, the
parameter layout, the forward loss and gradients of every ``SMOKE`` config,
the frontend prefix, and the launcher on every architecture (the trainer
steps against the reference's are ``tests/test_torch_families_step.py``).

The reference runs once for the file in a subprocess (results handed over
as an ``.npz``, the config tables as JSON):

* for all 11 architectures, ``CONFIG`` and ``SMOKE`` field for field,
  ``count_params`` and ``active_params`` of both, every parameter leaf's
  path and shape in tree order (``abstract_params``), and ``input_specs``
  for every arch x shape (``tests/test_configs.py``'s checks, held here to
  the reference's values);
* for every ``SMOKE`` config, the initial parameters (``PRNGKey(0)``) and
  ``lm_loss`` with its gradients on a numpy batch (seq 16, chunks of 8),
  the frontend archs with a 4-position ``prefix_embeds``, and llava-smoke
  again without it (the launcher's batches carry none).

Tolerances: the loss 1e-5 relative; every gradient leaf within 1e-4 of
that leaf's largest magnitude (fp32 sums in other orders; the SSD scan's
einsums run in another association).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, SHAPES, get_config, get_smoke,
                                 input_specs, shape_applicable)
from repro_torch.launch import train as launch_train
from repro_torch.models import (abstract_params, active_params,
                                count_params, init_params, lm_loss)
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import params_from_jax
from repro_torch.core.keys import key as tkey

ALL = list(ARCHS) + ["gpt2-paper"]
FRONTEND = ("llava-next-mistral-7b", "musicgen-medium")
# forward case -> (arch, with prefix)
FWD_CASES = {a: (a, a in FRONTEND) for a in ALL}
FWD_CASES["llava-noprefix"] = ("llava-next-mistral-7b", False)
BATCH, SEQ, PREFIX, SEQ_CHUNK = 2, 16, 4, 8
REL_TOL = 1e-4
MODES = ("replicated", "fsdp")

CHILD = r"""
import dataclasses, json, sys
import jax, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.configs import SHAPES, get_config, get_smoke, input_specs
from repro.models import (SINGLE, abstract_params, active_params,
                          count_params, init_params, lm_loss)

out_path = sys.argv[1]
archs, fwd_cases = eval(sys.argv[2]), eval(sys.argv[3])
b, s, pre, seq_chunk = (int(v) for v in sys.argv[4:8])

def fields(cfg):
    d = dataclasses.asdict(cfg)
    d["param_dtype"] = np.dtype(cfg.param_dtype).name
    return d

def leaf_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), list(leaf.shape)] for path, leaf in flat]

meta = {}
for arch in archs:
    entry = {}
    for kind, cfg in (("config", get_config(arch)), ("smoke", get_smoke(arch))):
        entry[kind] = {"fields": fields(cfg), "count": count_params(cfg),
                       "active": active_params(cfg),
                       "leaves": leaf_paths(abstract_params(cfg))}
    entry["specs"] = {sh: {k: [list(v.shape), np.dtype(v.dtype).name]
                           for k, v in input_specs(get_config(arch),
                                                   SHAPES[sh]).items()}
                      for sh in SHAPES}
    meta[arch] = entry
save = {"meta": np.array(json.dumps(meta))}

key = jax.random.PRNGKey(0)
for arch in archs:
    for i, leaf in enumerate(jax.tree.leaves(init_params(key,
                                                        get_smoke(arch)))):
        save[f"init/{arch}/{i}"] = np.asarray(leaf)
for ci, (name, (arch, with_prefix)) in enumerate(fwd_cases.items()):
    cfg = get_smoke(arch)
    rng = np.random.default_rng(ci)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if with_prefix:
        batch["prefix_embeds"] = rng.standard_normal(
            (b, pre, cfg.frontend_dim)).astype(np.float32)
    for k, v in batch.items():
        save[f"fwd/{name}/batch/{k}"] = v
    params = init_params(key, cfg)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: lm_loss(
        p, batch, cfg, SINGLE, key=jax.random.PRNGKey(1),
        seq_chunk=seq_chunk)))(params)
    save[f"fwd/{name}/loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        save[f"fwd/{name}/grad/{i}"] = np.asarray(g)

np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_families") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), repr(ALL), repr(FWD_CASES),
         *(str(v) for v in (BATCH, SEQ, PREFIX, SEQ_CHUNK))],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        data = dict(z)
    data["meta"] = json.loads(str(data["meta"]))
    return data


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["param_dtype"] = str(cfg.param_dtype).removeprefix("torch.")
    return d


def _paths(tree, prefix=""):
    """Each leaf's path ("stages/0/wq") and shape, in tree order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [[prefix[:-1], list(tree.shape)]]


def _port_params(ref, arch):
    like = abstract_params(get_smoke(arch))
    n = len(tree_leaves(like))
    return params_from_jax(tree_unflatten(
        like, [ref[f"init/{arch}/{i}"] for i in range(n)]))


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().to(torch.float32).numpy() - want).max())
    assert err <= REL_TOL * scale, (what, err, scale)


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke models are too small to gain from torch's intra-op
    threads, and under the suite's parallel workers those threads contend
    for the cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ALL)
def test_configs_equal_reference_field_for_field(ref, arch):
    meta = ref["meta"][arch]
    assert _fields(get_config(arch)) == meta["config"]["fields"]
    assert _fields(get_smoke(arch)) == meta["smoke"]["fields"]


@pytest.mark.parametrize("arch", ALL)
def test_param_counts_equal_reference(ref, arch):
    meta = ref["meta"][arch]
    for kind, cfg in (("config", get_config(arch)),
                      ("smoke", get_smoke(arch))):
        assert count_params(cfg) == meta[kind]["count"], kind
        assert active_params(cfg) == meta[kind]["active"], kind


@pytest.mark.parametrize("arch", ALL)
def test_param_table_shapes_and_tree_order(ref, arch):
    """Every leaf's path and shape in tree order: the arena's layout."""
    meta = ref["meta"][arch]
    for kind, cfg in (("config", get_config(arch)),
                      ("smoke", get_smoke(arch))):
        tree = abstract_params(cfg)
        assert _paths(tree) == meta[kind]["leaves"], kind
        assert all(t.device.type == "meta" and t.dtype == cfg.param_dtype
                   for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", ALL)
def test_input_specs_equal_reference(ref, arch):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        specs = input_specs(cfg, shape)
        want = ref["meta"][arch]["specs"][name]
        got = {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
               for k, v in specs.items()}
        assert got == want, name
        assert all(v.device.type == "meta" for v in specs.values())
    ok, why = shape_applicable(cfg, SHAPES["long_500k"])
    assert ok == cfg.sub_quadratic() and (ok or "sub-quadratic" in why)


def test_published_sizes():
    """The full-width counts this slice trains on the card."""
    assert count_params(get_config("smollm-360m")) == 361_821_120
    assert count_params(get_config("mamba2-1.3b")) == 1_343_286_272
    one = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=1)
    assert count_params(one) == 881_719_296
    period = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    assert count_params(period) == 12_997_268_800
    assert 1.5e9 < active_params(get_config("qwen2-moe-a2.7b")) < 3.5e9


def test_jamba_stages_carry_leaf_for_leaf(ref):
    """jamba-smoke's ``stages``: 4 period positions (attention every 4,
    MoE every 2), each stacked over 2 repeats; the full config's has 8."""
    params = _port_params(ref, "jamba-v0.1-52b")
    stages = params["stages"]
    assert isinstance(stages, list) and len(stages) == 4
    assert all(t.shape[0] == 2 for st in stages for t in st.values())
    assert ["wq" in st for st in stages] == [False, False, True, False]
    assert ["router" in st for st in stages] == [False, True, False, True]
    assert len(abstract_params(get_config("jamba-v0.1-52b"))["stages"]) == 8
    n = len(tree_leaves(params))
    for i, t in enumerate(tree_leaves(params)):
        np.testing.assert_array_equal(t.numpy(),
                                      ref[f"init/jamba-v0.1-52b/{i}"])
    assert n == len(ref["meta"]["jamba-v0.1-52b"]["smoke"]["leaves"])


def test_pure_ssm_layers_have_no_ffn():
    stage = abstract_params(get_smoke("mamba2-1.3b"))["stages"][0]
    assert "ln2" not in stage and "w_gate" not in stage
    assert {"wx", "conv_w", "a_log", "d_skip", "dt_bias"} <= set(stage)


# ------------------------------------------------------------ forward
def _fwd(ref, name):
    arch, _ = FWD_CASES[name]
    params = _port_params(ref, arch)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k[len(f"fwd/{name}/batch/"):]: torch.from_numpy(v)
             for k, v in ref.items() if k.startswith(f"fwd/{name}/batch/")}
    loss = lm_loss(params, batch, get_smoke(arch), seq_chunk=SEQ_CHUNK)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_loss_matches_reference(ref, name):
    loss, _ = _fwd(ref, name)
    assert float(loss) == pytest.approx(float(ref[f"fwd/{name}/loss"]),
                                        rel=1e-5)


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_grads_match_reference(ref, name):
    _, grads = _fwd(ref, name)
    for i, g in enumerate(grads):
        want = ref[f"fwd/{name}/grad/{i}"]
        if g is None:           # not reached: the reference's is all zero
            assert not want.any(), i
            continue
        _close(g, want, f"grad {i}")


def test_prefix_path_reaches_frontend_proj(ref):
    """With ``prefix_embeds`` the projection gets a gradient and the loss
    counts only token positions; without, it is untouched."""
    params = _port_params(ref, "llava-next-mistral-7b")
    order = [p for p, _ in _paths(params)]
    i = order.index("frontend_proj")
    _, with_prefix = _fwd(ref, "llava-next-mistral-7b")
    _, without = _fwd(ref, "llava-noprefix")
    assert float(with_prefix[i].abs().max()) > 0
    assert without[i] is None
    assert not ref[f"fwd/llava-noprefix/grad/{i}"].any()


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ALL)
def test_launcher_trains_every_arch(arch, mode):
    """``--arch <name> --smoke --device cpu --steps 2``, replicated and
    FSDP."""
    records = launch_train.run(["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", "2", "--seq-len", "16",
                                "--dp-mode", mode, "--drop-rate", "0.05",
                                "--log-every", "1"])
    assert len(records) == 2
    for rec in records:
        assert math.isfinite(rec["loss"]) and rec["loss"] > 0
        assert math.isfinite(rec["grad_norm"])


def test_init_params_inits_ssm_leaves():
    """The reference's inits: ``a_log`` in [0, log 16), ``dt_bias`` zeros,
    ``d_skip`` ones, ``conv_w`` of std 1/sqrt(kernel width)."""
    cfg = dataclasses.replace(get_smoke("mamba2-1.3b"), n_layers=4)
    st = init_params(tkey(0), cfg,
                     device="cpu")["stages"][0]
    assert float(st["a_log"].min()) >= 0 and \
        float(st["a_log"].max()) < math.log(16)
    assert not st["dt_bias"].any() and bool((st["d_skip"] == 1).all())
    std = float(st["conv_w"].std())
    assert 0.4 < std < 0.6, std        # 1/sqrt(4)
