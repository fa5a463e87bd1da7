"""The port's dense transformer, layers and optimizer against the JAX
package on the same parameters (carried by ``weights.params_from_jax``) and
the same numpy inputs, in fp32.

Tolerance: fp32 rounding of sums taken in other orders — 1e-5 relative on
the loss, 2e-5 absolute on activations and gradients of unit-scale (or,
for gradients, 1e-2-scale) values, 1e-6 on one AdamW step.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import SINGLE  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro.optim.optimizers import OptimizerConfig as JOptCfg  # noqa: E402
from repro.optim.optimizers import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import count_params, init_params, lm_loss  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.core.keys import key as tkey  # noqa: E402

ACT_TOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_smoke("gpt2-paper")
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp


@pytest.mark.parametrize("seq_chunk", [32, 8])
def test_lm_loss_and_grads_match_reference(smoke, seq_chunk):
    jcfg, jp = smoke
    batch = _batch(jcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, batch, jcfg, SINGLE, key=jax.random.PRNGKey(1),
                           seq_chunk=seq_chunk))(jp)
    params = params_from_jax(_np_tree(jp))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm_loss(params, tb, get_smoke("gpt2-paper"), seq_chunk=seq_chunk)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ACT_TOL,
                                   rtol=0)


def test_forward_without_remat_is_the_same(smoke):
    jcfg, jp = smoke
    params = params_from_jax(_np_tree(jp))
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg.vocab_size).items()}
    cfg = get_smoke("gpt2-paper")
    with torch.no_grad():
        a = lm_loss(params, tb, cfg, remat=True)
        b = lm_loss(params, tb, cfg, remat=False)
    assert torch.equal(a, b)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rms_norm_matches_reference():
    x, s = _rand(2, 5, 64), _rand(64, seed=1)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jl.rms_norm(x, s)), atol=ACT_TOL)


def test_apply_rope_matches_reference():
    x = _rand(2, 7, 4, 16)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()))
        .numpy(), np.asarray(jl.apply_rope(x, pos)), atol=ACT_TOL)


@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2)])
def test_attention_matches_reference(heads, kv):
    d, dh, s = 32, 8, 9
    w = {"wq": _rand(d, heads * dh, seed=1), "wk": _rand(d, kv * dh, seed=2),
         "wv": _rand(d, kv * dh, seed=3), "wo": _rand(heads * dh, d, seed=4),
         "head_dim": dh, "attn_chunk": 0}
    x = _rand(2, s, d) * 0.3
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = np.asarray(jl.attention_train(x, w, SINGLE, positions=pos))
    tw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in w.items()}
    got = tl.attention_train(torch.from_numpy(x), tw,
                             positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_chunked_attention_is_not_ported_yet():
    """Chunked attention (ROADMAP A9, now ported): past ``attn_chunk`` the
    port's ``attention_train`` runs the flash-style path, within fp32
    rounding of the reference's at seq 16, chunk 4; a sequence that is no
    multiple of the chunk raises the port's ValueError (the reference's
    reshape fails; tests/test_torch_chunked.py holds the rest)."""
    w = {"wq": _rand(8, 16, seed=1), "wk": _rand(8, 16, seed=2),
         "wv": _rand(8, 16, seed=3), "wo": _rand(16, 8, seed=4),
         "head_dim": 8, "attn_chunk": 4}
    x = _rand(1, 16, 8, seed=5)
    pos = np.arange(16, dtype=np.int32)[None]
    want = np.asarray(jl.attention_train(x, w, SINGLE, positions=pos))
    tw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in w.items()}
    got = tl.attention_train(torch.from_numpy(x), tw,
                             positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="multiple of attn_chunk"):
        tl.attention_train(torch.zeros(1, 5, 8), tw,
                           positions=torch.zeros(1, 5, dtype=torch.int32))


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_gated_mlp_matches_reference(activation):
    w = {"w_gate": _rand(16, 32, seed=1), "w_up": _rand(16, 32, seed=2),
         "w_down": _rand(32, 16, seed=3)}
    x = _rand(2, 3, 16) * 0.5
    want = np.asarray(jl.gated_mlp(x, w, SINGLE, activation=activation))
    got = tl.gated_mlp(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in w.items()},
                       activation=activation)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_adamw_step_matches_reference(smoke):
    jcfg, jp = smoke
    rng = np.random.default_rng(3)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 1e-2), jp)
    opt = jadamw(JOptCfg(lr=1e-2))
    st = opt.init(jp)
    jp1, st1 = opt.update(jg, st, jp, jnp.float32(1e-2), jnp.int32(0))
    jp2, st2 = opt.update(jg, st1, jp1, jnp.float32(1e-2), jnp.int32(1))
    params, state = params_from_jax(_np_tree(jp), _np_tree(st))
    grads = params_from_jax(_np_tree(jg))
    topt = adamw(OptimizerConfig(lr=1e-2))
    for step in range(2):
        params, state = topt.update(grads, state, params, 1e-2, step)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(tree_leaves(state.v), jax.tree.leaves(st2.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-12)


def test_bf16_params_carry_bit_for_bit():
    a = jnp.asarray(_rand(3, 5)).astype(jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_gpt2_paper_is_full_width():
    cfg = get_config("gpt2-paper")
    assert count_params(cfg) == 151_862_784
    assert cfg.param_dtype == torch.bfloat16


def test_init_params_shapes_follow_reference_tree(smoke):
    _, jp = smoke
    params = init_params(tkey(0),
                         get_smoke("gpt2-paper"), device="cpu")
    assert [tuple(p.shape) for p in tree_leaves(params)] == \
        [tuple(p.shape) for p in jax.tree.leaves(jp)]


def test_other_families_are_not_ported_yet():
    """Every family is ported, over tensor-parallel ranks too (the name is
    kept from when they were not): mamba2-1.3b's SSM heads shard over tp,
    its ``wB``/``wC`` stay replicated (``tests/test_torch_tp_families.py``
    holds every family to the reference)."""
    from repro_torch.models import param_table
    assert get_config("mamba2-1.3b").family == "ssm"
    stage = param_table(get_config("mamba2-1.3b"), tp=2)["stages"][0]
    assert stage["wx"].tp_dim == 2 and stage["a_log"].tp_dim == 1
    assert stage["out_proj"].tp_dim == 1
    assert stage["wB"].tp_dim is None and stage["wC"].tp_dim is None


def test_warmup_cosine_schedule_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0) and lrs[3] == pytest.approx(0.1)
