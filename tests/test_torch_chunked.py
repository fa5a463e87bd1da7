"""Chunked (flash-style) causal attention and ``layer_norm`` of
``repro_torch/models/layers.py`` against the reference's (in-process, at
small sizes in fp32).

``attention_train`` takes the chunked path past ``attn_chunk``: at seq 64
with chunk 16 the forward and the gradients (of the input and of every
weight) match the reference's chunked path within fp32 rounding, with
multi-head and grouped KV heads; with tensor-parallel ``kv_heads`` the
chunked path matches the port's own dense path. Skipping the key blocks
above the diagonal gives the bits of visiting them all. A sequence that is
not a multiple of the chunk raises the port's ValueError; the reference
fails inside its reshape (shown). The whole model at ``attn_chunk`` 16:
``lm_loss`` and its gradients against the reference's.
"""
import dataclasses
import math

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import SINGLE  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm_loss as jlm_loss  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm_loss  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
D, DH, S, CHUNK = 32, 8, 64, 16


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _weights(heads, kv, chunk=CHUNK):
    return {"wq": _rand(D, heads * DH, seed=1, scale=0.3),
            "wk": _rand(D, kv * DH, seed=2, scale=0.3),
            "wv": _rand(D, kv * DH, seed=3, scale=0.3),
            "wo": _rand(heads * DH, D, seed=4, scale=0.3),
            "head_dim": DH, "attn_chunk": chunk}


def _torch_w(w, grad=False):
    return {k: torch.from_numpy(v).requires_grad_(grad)
            if isinstance(v, np.ndarray) else v for k, v in w.items()}


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2), (4, 1)])
def test_chunked_forward_and_grads_match_reference(heads, kv):
    w = _weights(heads, kv)
    x = _rand(2, S, D, seed=5)
    pos = _pos(2, S)
    names = ("wq", "wk", "wv", "wo")

    def jf(x, *ws):
        jw = dict(w, **dict(zip(names, ws)))
        out = jl.attention_train(x, jw, SINGLE, positions=pos)
        return (out * out).sum(), out
    (_, jout), jgrads = jax.value_and_grad(
        jf, argnums=tuple(range(5)), has_aux=True)(x, *[w[n] for n in names])
    tw = _torch_w(w, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tl.attention_train(tx, tw, positions=torch.from_numpy(pos))
    grads = torch.autograd.grad((out * out).sum(),
                                [tx] + [tw[n] for n in names])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=FWD_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL * max(1.0, float(
                                       np.abs(jg).max())))


def test_chunked_with_tp_kv_heads_matches_dense():
    """Tensor-parallel heads (``kv_heads`` names each q head's K / V head
    of the global, padded projection): the chunked path against the port's
    dense one, forward and input gradient."""
    w = _weights(4, 2)
    kv_heads = torch.tensor([0, 0, 1, 1], dtype=torch.int64)
    x = _rand(1, S, D, seed=6)
    pos = torch.from_numpy(_pos(1, S))
    outs, grads = [], []
    for chunk in (CHUNK, 0):
        tx = torch.from_numpy(x).requires_grad_(True)
        out = tl.attention_train(tx, _torch_w(dict(w, attn_chunk=chunk)),
                                 positions=pos, kv_heads=kv_heads)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * out).sum(), tx)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=GRAD_TOL * float(grads[1].abs().max()))


def _visit_every_block(q, k, v, *, scale, chunk):
    """The reference's loop as written: every query block visits every key
    block, the ones above the diagonal masked whole."""
    b, s, h, dh = q.shape
    idx = torch.arange(chunk)
    qf, kf = q.float(), k.float()
    outs = []
    for i in range(s // chunk):
        qi = qf[:, i * chunk:(i + 1) * chunk]
        o = torch.zeros((b, chunk, h, dh))
        m = torch.full((b, h, chunk), -1e30)
        l_sum = torch.zeros((b, h, chunk))
        for j in range(s // chunk):
            kj, vj = kf[:, j * chunk:(j + 1) * chunk], \
                v[:, j * chunk:(j + 1) * chunk]
            sc = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            mask = (i * chunk + idx)[:, None] >= (j * chunk + idx)[None, :]
            sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype),
                              vj).float()
            o = o * corr.transpose(1, 2)[..., None] + pv
            m = m_new
        outs.append(o / torch.clamp(l_sum.transpose(1, 2)[..., None],
                                    min=1e-30))
    return torch.cat(outs, dim=1).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipping_blocks_above_the_diagonal_is_bitwise(dtype):
    q, k, v = (torch.from_numpy(_rand(2, S, 4, DH, seed=i)).to(dtype)
               for i in (7, 8, 9))
    scale = 1.0 / math.sqrt(DH)
    got = tl.chunked_causal_attention(q, k, v, scale=scale, chunk=CHUNK)
    want = _visit_every_block(q, k, v, scale=scale, chunk=CHUNK)
    assert torch.equal(got, want)


def test_sequence_not_a_multiple_of_the_chunk():
    """seq 20 over chunk 8: the port refuses with the cause; the reference
    fails reshaping 20 positions into blocks of 8."""
    w = _weights(2, 2, chunk=8)
    x = _rand(1, 20, D, seed=10)
    pos = _pos(1, 20)
    with pytest.raises(ValueError, match="multiple of attn_chunk"):
        tl.attention_train(torch.from_numpy(x), _torch_w(w),
                           positions=torch.from_numpy(pos))
    with pytest.raises(TypeError, match="reshape"):
        jl.attention_train(x, w, SINGLE, positions=pos)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 48)])
def test_layer_norm_matches_reference(shape):
    x = _rand(*shape, seed=11, scale=2.0) + 0.5
    scale = _rand(shape[-1], seed=12)
    bias = _rand(shape[-1], seed=13)
    want = np.asarray(jl.layer_norm(x, scale, bias))
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tl.layer_norm(xb, torch.from_numpy(scale),
                         torch.from_numpy(bias)).dtype == torch.bfloat16


def test_model_loss_with_chunked_attention_matches_reference():
    jcfg = dataclasses.replace(jget_smoke("gpt2-paper"), attn_chunk=16)
    cfg = dataclasses.replace(get_smoke("gpt2-paper"), attn_chunk=16)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, batch, jcfg, SINGLE,
                           key=jax.random.PRNGKey(1)))(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm_loss(params, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL)
