"""Serving in the port against the reference: ``prefill_step``,
``forward_hidden(collect_state=True)``, ``decode_step``, ``generate`` and
the launcher (``src/repro_torch/models/transformer.py``,
``serve/engine.py``, ``launch/serve.py``); the peer-grid plans of
``build_serve_step`` are ``tests/test_torch_serve_grid.py``.

The reference runs once for the file in a subprocess (8 forced host
devices; results handed over as an ``.npz``):

* for gpt2-smoke, smollm-smoke (GQA 3:1), qwen2-moe-smoke, mamba2-smoke and
  jamba-smoke: the initial parameters (``PRNGKey(0)``); on a (2, 8) numpy
  prompt, ``forward_hidden(collect_state=True)``'s hidden states and
  states, ``prefill_step``'s first token and states; ``decode_step``
  teacher-forced over the prompt's 8 tokens from the zero state: each
  step's next tokens and, after the last step, every layer's K / V cache
  and SSM state;
* ``generate`` on gpt2-smoke and qwen2-moe-smoke, (2, 4) prompts, 4 new;
* its launcher's two lines on ``--smoke --batch 2 --prompt-len 4
  --max-new 4``.

At random init greedy decoding collapses onto one repeated token, so equal
tokens prove little: the caches, states and hidden states are compared
too. Tolerance (fp32 smoke configs, sums in other orders): every hidden
state and state leaf within ``TOL`` = 1e-5 of that leaf's largest magnitude
(measured: at most 7.8e-6 on the prefill's final SSD states, whose chunked
scan sums in another association; at most 3.4e-7 on every other leaf);
tokens equal.
"""
import collections
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_smoke
from repro_torch.core.keys import key
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (SINGLE, abstract_params, decode_step,
                                forward_hidden, init_decode_state,
                                init_params, prefill_step)
from repro_torch.models.layers import KVCache
from repro_torch.models.ssm import SSMState
from repro_torch.serve import generate
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import decode_state_from_jax, params_from_jax

ARCHS5 = ("gpt2-paper", "smollm-360m", "qwen2-moe-a2.7b", "mamba2-1.3b",
          "jamba-v0.1-52b")
GEN_ARCHS = ("gpt2-paper", "qwen2-moe-a2.7b")
B, S, GEN_PROMPT, GEN_NEW = 2, 8, 4, 4
TOL = 1e-5
CLI = ["--smoke", "--batch", "2", "--prompt-len", "4", "--max-new", "4"]

CHILD = r"""
import contextlib, io, sys
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.configs import get_smoke
from repro.launch import serve as launch_serve
from repro.models import (SINGLE, decode_step, forward_hidden,
                          init_decode_state, init_params, prefill_step)
from repro.serve.engine import generate

out_path = sys.argv[1]
archs, gen_archs, cli = eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4])
b, s, gp, gn = (int(v) for v in sys.argv[5:9])
key = jax.random.PRNGKey(0)
save = {}

def put(prefix, state):
    for p, st in enumerate(state):
        for name, leaf in zip(st._fields, st):
            save[f"{prefix}/{p}/{name}"] = np.asarray(leaf)

for ci, arch in enumerate(archs):
    cfg = get_smoke(arch)
    params = init_params(key, cfg)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        save[f"init/{arch}/{i}"] = np.asarray(leaf)
    toks = np.random.default_rng(ci).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    save[f"toks/{arch}"] = toks
    x, st = jax.jit(lambda p, t: forward_hidden(
        p, {"tokens": t}, cfg, SINGLE, key=key, remat=False,
        collect_state=True))(params, toks)
    save[f"hidden/{arch}"] = np.asarray(x)
    put(f"fh/{arch}", st)
    tok, st = jax.jit(lambda p, t: prefill_step(
        p, {"tokens": t}, cfg, SINGLE, key=key))(params, toks)
    save[f"prefill_tok/{arch}"] = np.asarray(tok)
    put(f"prefill/{arch}", st)
    state = init_decode_state(params, cfg, batch=b, max_seq=s,
                              dtype=cfg.param_dtype)
    step = jax.jit(lambda p, st, t, pos: decode_step(p, st, t, pos, cfg,
                                                     SINGLE, key=key))
    nxt = []
    for t in range(s):
        n, state = step(params, state, toks[:, t:t + 1], jnp.int32(t))
        nxt.append(np.asarray(n))
    save[f"decode_tok/{arch}"] = np.concatenate(nxt, axis=1)
    put(f"decode/{arch}", state)

for gi, arch in enumerate(gen_archs):
    cfg = get_smoke(arch)
    prompts = np.random.default_rng(100 + gi).integers(
        0, cfg.vocab_size, size=(b, gp)).astype(np.int32)
    save[f"gen_prompt/{arch}"] = prompts
    save[f"gen/{arch}"] = np.asarray(generate(
        init_params(key, cfg), cfg, jnp.asarray(prompts), max_new=gn,
        key=key))

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    launch_serve.main(cli)
save["cli"] = np.array(buf.getvalue())
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_serve") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out), repr(ARCHS5),
         repr(GEN_ARCHS), repr(CLI),
         *(str(v) for v in (B, S, GEN_PROMPT, GEN_NEW))],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke models are too small to gain from torch's intra-op
    threads, and under the suite's parallel workers those threads contend
    for the cores; one thread a test, the worker's setting restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(ref, arch):
    like = abstract_params(get_smoke(arch))
    n = len(tree_leaves(like))
    return params_from_jax(tree_unflatten(
        like, [ref[f"init/{arch}/{i}"] for i in range(n)]))


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.to(torch.float32).numpy() - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _states_close(ref, prefix: str, states) -> None:
    for p, st in enumerate(states):
        for name, leaf in zip(st._fields, st):
            _close(leaf, ref[f"{prefix}/{p}/{name}"], f"{prefix}/{p}/{name}")


def _teacher_forced(params, cfg, toks: torch.Tensor, state):
    nxt = []
    for t in range(toks.shape[1]):
        n, state = decode_step(params, state, toks[:, t:t + 1], t, cfg)
        nxt.append(n)
    return torch.cat(nxt, dim=1), state


# ------------------------------------------------------------ prefill
@pytest.mark.parametrize("arch", ARCHS5)
def test_forward_hidden_collects_the_reference_state(ref, arch):
    cfg = get_smoke(arch)
    x, states = forward_hidden(
        _params(ref, arch), {"tokens": torch.from_numpy(ref[f"toks/{arch}"])},
        cfg, remat=False, collect_state=True)
    _close(x, ref[f"hidden/{arch}"], "hidden")
    _states_close(ref, f"fh/{arch}", states)


@pytest.mark.parametrize("arch", ARCHS5)
def test_prefill_step_matches_reference(ref, arch):
    """The first token (fp32 head over the last position) and the states:
    the attention layers' post-RoPE K / V, the Mamba-2 layers' conv tail
    and final SSD state."""
    tok, states = prefill_step(
        _params(ref, arch), {"tokens": torch.from_numpy(ref[f"toks/{arch}"])},
        get_smoke(arch))
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), ref[f"prefill_tok/{arch}"])
    _states_close(ref, f"prefill/{arch}", states)


# ------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", ARCHS5)
def test_decode_teacher_forced_matches_reference(ref, arch):
    """8 teacher-forced steps from the zero state: every step's tokens,
    then every layer's K / V cache and SSM state."""
    cfg = get_smoke(arch)
    state = init_decode_state(None, cfg, batch=B, max_seq=S,
                              dtype=cfg.param_dtype)
    nxt, state = _teacher_forced(_params(ref, arch), cfg,
                                 torch.from_numpy(ref[f"toks/{arch}"]), state)
    np.testing.assert_array_equal(nxt.numpy(), ref[f"decode_tok/{arch}"])
    _states_close(ref, f"decode/{arch}", state)


@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_generate_matches_reference(ref, arch):
    out = generate(_params(ref, arch), get_smoke(arch),
                   torch.from_numpy(ref[f"gen_prompt/{arch}"]),
                   max_new=GEN_NEW)
    np.testing.assert_array_equal(out.numpy(), ref[f"gen/{arch}"])


@pytest.mark.parametrize("arch", list(ARCHS) + ["gpt2-paper"])
def test_decode_step_smoke(arch):
    """The port's counterpart of ``tests/test_models_smoke.py``'s: one
    decode step of every smoke config keeps the state's structure and
    gives an int32 token in range."""
    cfg = get_smoke(arch)
    params = init_params(key(0), cfg, device="cpu")
    state = init_decode_state(params, cfg, batch=2, max_seq=8,
                              dtype=cfg.param_dtype)
    shapes = [tuple(leaf.shape) for leaf in tree_leaves(state)]
    tok = torch.randint(0, cfg.vocab_size, (2, 1),
                        generator=torch.Generator().manual_seed(1))
    nxt, new_state = decode_step(params, state, tok, 0, cfg, SINGLE)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert 0 <= int(nxt.min()) and int(nxt.max()) < cfg.vocab_size
    assert [tuple(leaf.shape) for leaf in tree_leaves(new_state)] == shapes
    assert all(bool(torch.isfinite(leaf).all())
               for leaf in tree_leaves(new_state))


@pytest.mark.parametrize("arch", ["gpt2-paper", "mamba2-1.3b",
                                  "jamba-v0.1-52b"])
def test_prefill_then_decode_consistency(arch):
    """Greedy token after prefill == greedy token after teacher-forced
    step-by-step decoding of the same prompt (a 0-d tensor position)."""
    cfg = get_smoke(arch)
    params = init_params(key(1), cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(2))
    tok_pf, _ = prefill_step(params, {"tokens": prompt}, cfg, SINGLE)
    state = init_decode_state(params, cfg, batch=1, max_seq=8,
                              dtype=cfg.param_dtype)
    tok = prompt[:, :1]
    for t in range(8):
        nxt, state = decode_step(params, state, tok, torch.tensor(t), cfg,
                                 SINGLE)
        tok = prompt[:, t + 1:t + 2] if t + 1 < 8 else nxt
    assert int(tok_pf[0, 0]) == int(tok[0, 0])


# ------------------------------------------------------------ launcher
LINE = re.compile(r"^generated \((\d+), (\d+)\) in \d+\.\d\ds "
                  r"\(\d+\.\d tok/s\)\nsample: \[(\d+(?:, \d+)*)\]\n$")


def test_cli_on_cpu_prints_the_reference_lines(ref, capsys):
    assert launch_serve.main([*CLI, "--device", "cpu"]) == 0
    got = LINE.match(capsys.readouterr().out)
    want = LINE.match(str(ref["cli"]))
    assert got and want, (got, str(ref["cli"]))
    assert got.groups()[:2] == want.groups()[:2] == ("2", "8")
    assert len(got.group(3).split(", ")) == len(want.group(3).split(", "))


def test_cli_defaults_to_the_card(monkeypatch):
    """Without ``--device`` the launcher runs on the card, and raises
    where there is none instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(CLI)


def test_decode_state_from_jax_keeps_bf16_bits():
    """The reference's state (named tuples of numpy arrays, bf16 as
    ``ml_dtypes.bfloat16``) carries over leaf for leaf, bit for bit."""
    import ml_dtypes
    ref_kv = collections.namedtuple("KVCache", "k v")
    ref_ssm = collections.namedtuple("SSMState", "conv ssm")
    rng = np.random.default_rng(0)

    def bf16(shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    state = [ref_kv(bf16((2, 1, 4, 2, 8)), bf16((2, 1, 4, 2, 8))),
             ref_ssm(bf16((2, 1, 3, 16)),
                     rng.standard_normal((2, 1, 2, 8, 4)).astype(np.float32))]
    got = decode_state_from_jax(state)
    assert isinstance(got[0], KVCache) and isinstance(got[1], SSMState)
    for g, w in zip(tree_leaves(got), [a for st in state for a in st]):
        want_dtype = (torch.bfloat16 if w.dtype == ml_dtypes.bfloat16
                      else torch.float32)
        assert g.dtype == want_dtype
        bits = np.uint16 if want_dtype == torch.bfloat16 else np.uint32
        np.testing.assert_array_equal(
            g.view(torch.int16 if bits is np.uint16 else torch.int32)
            .numpy().view(bits), w.view(bits))
    with pytest.raises(TypeError):
        decode_state_from_jax([(np.zeros(2), np.zeros(2))])


# ----------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS5)
def test_decode_on_the_card_matches_cpu(card, arch):
    """8 teacher-forced steps and a prefill on the card against the CPU,
    same parameters (TF32 off): tokens equal, states within ``TOL`` of each
    leaf's largest magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(arch)
    params = init_params(key(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(3))
    res = {}
    for dev in (torch.device("cpu"), card):
        p = [t.to(dev) for t in tree_leaves(params)]
        p = tree_unflatten(params, p)
        state = init_decode_state(None, cfg, batch=B, max_seq=S,
                                  dtype=cfg.param_dtype, device=dev)
        nxt, state = _teacher_forced(p, cfg, toks.to(dev), state)
        tok_pf, pf = prefill_step(p, {"tokens": toks.to(dev)}, cfg)
        res[dev.type] = (nxt.cpu(), tok_pf.cpu(),
                         [t.cpu() for t in tree_leaves(state)],
                         [t.cpu() for t in tree_leaves(pf)])
    cpu, gpu = res["cpu"], res["cuda"]
    assert torch.equal(cpu[0], gpu[0]) and torch.equal(cpu[1], gpu[1])
    for a, g in zip(cpu[2] + cpu[3], gpu[2] + gpu[3]):
        _close(g, a.to(torch.float32).numpy(), "card")
