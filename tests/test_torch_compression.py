"""The port's compression baselines (``repro_torch.core.compression``) and
its THC quantizer B7 (plain version) against the reference on the same
numpy inputs; the reference's Pallas kernel runs in interpret mode, as the
reference's own tests run it on the CPU.

Tolerances, and why:

* B7 codes (``uniform_quant_ref`` against ``uniform_quant_pallas``): the
  same IEEE operations in the same order, the step a true division of the
  range: bitwise, NaN included (code 0, as XLA's float-to-uint8 convert).
* Dequant: ``code * step + lo * nsum`` rounds twice in the port and may be
  one FMA in XLA: within 2 ulp of the largest value.
* THC codes: the port rotates with the butterfly, the reference's jnp path
  with two Kronecker matmuls (~1e-7 apart), so a code whose floor sits on a
  boundary may differ by one: codes agree except at most 1 in 10,000, each
  by exactly 1. The decoded mean of the same code sum agrees to 1e-5 of
  the range's scale max(|lo|, |hi|) (a rotation of values of that scale);
  end to end it agrees within that plus what the flips move: a code-sum
  difference d in a block moves each entry of the block by
  |d| x step / (nsum x sqrt(block)).
* Top-K: the data has no ties among the largest entries (``jax.lax.top_k``
  and ``torch.topk`` may order ties differently), so the kept set, the
  sparse vector and the error memory are exactly equal.
* TernGrad: the reference's uniform draw (``bernoulli(p)`` is ``u < p``) on
  both sides: exactly equal.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro.kernels.quant.quant import uniform_quant_pallas  # noqa: E402
from repro.kernels.quant.ref import \
    uniform_dequant_ref as j_dequant  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core.hadamard import rademacher_sign  # noqa: E402
from repro_torch.core.keys import generator, key  # noqa: E402
from repro_torch.kernels.quant import (uniform_dequant,  # noqa: E402
                                       uniform_quant)
from repro_torch.kernels.quant import ref as q_ref  # noqa: E402

FLIP_RATE = 1e-4
ROT_TOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _data(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _lohi(x):
    return np.array([x.min() * 1.2 - 1e-3, x.max() * 1.2 + 1e-3], np.float32)


# ------------------------------------------------------------ B7, plain
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_uniform_quant_plain_equals_pallas(bits):
    """200 rows: not a multiple of the Pallas kernel's 128-row tile."""
    x = _data((200, 256), bits)
    noise = np.random.default_rng(10 + bits).random((200, 256)) \
        .astype(np.float32)
    lohi = _lohi(x)
    want = np.asarray(uniform_quant_pallas(*map(jnp.asarray, (x, noise, lohi)),
                                           bits=bits, interpret=True))
    xt, nt, rt = _t(x, noise, lohi)
    got = q_ref.uniform_quant_ref(xt, nt, rt[0], rt[1], bits=bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(uniform_quant(xt, nt, rt, bits=bits), got)


def test_uniform_quant_shared_noise_equals_expanded():
    """One (R, C) noise copy for a (W, R, C) stack is the reference's
    function on the noise tiled W times."""
    x = _data((4, 50, 64), 1)
    noise = np.random.default_rng(2).random((50, 64)).astype(np.float32)
    lohi = _lohi(x)
    xt, nt, rt = _t(x, noise, lohi)
    got = uniform_quant(xt, nt, rt, bits=4)
    assert got.shape == (4, 50, 64)
    tiled = torch.from_numpy(np.tile(noise, (4, 1)))
    want = q_ref.uniform_quant_ref(xt.reshape(200, 64), tiled, rt[0], rt[1],
                                   bits=4)
    assert torch.equal(got.reshape(200, 64), want)
    with pytest.raises(ValueError, match="must divide"):
        uniform_quant(xt, nt[:7], rt, bits=4)


def test_uniform_quant_nan_gives_code_zero():
    x = _data((8, 16), 3)
    x[2, 5] = np.nan
    x[6, 0] = np.inf
    noise = np.random.default_rng(4).random((8, 16)).astype(np.float32)
    lohi = np.array([-3.0, 3.0], np.float32)
    want = np.asarray(uniform_quant_pallas(*map(jnp.asarray, (x, noise, lohi)),
                                           bits=8, interpret=True))
    got = uniform_quant(*_t(x, noise, lohi), bits=8).numpy()
    assert got[2, 5] == 0 and got[6, 0] == 255
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nsum", [1, 4, 7])
def test_uniform_dequant_matches_reference(nsum):
    rng = np.random.default_rng(nsum)
    codes = rng.integers(0, 16 * nsum, (32, 64)).astype(np.int32)
    lohi = np.array([-0.731, 0.912], np.float32)
    want = np.asarray(j_dequant(jnp.asarray(codes), jnp.float32(lohi[0]),
                                jnp.float32(lohi[1]), bits=4, nsum=nsum))
    got = uniform_dequant(*_t(codes, lohi), bits=4, nsum=nsum).numpy()
    tol = 2 * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_uniform_quant_byte_and_flop_counts():
    assert q_ref.uniform_quant_bytes(8 * 148_304, 1024, 148_304) == \
        44 * 148_304 * 1024 + 8
    assert q_ref.uniform_quant_flops(10, 4) == 162


# --------------------------------------------------------------------- THC
def _thc_reference(xs, jkey, lohi, bits, block):
    codes = [np.asarray(jcomp.thc_compress(jnp.asarray(x), jkey,
                                           jnp.asarray(lohi), bits=bits,
                                           block=block).codes)
             for x in xs]
    return np.stack(codes)


@pytest.mark.parametrize("bits", [4, 8])
def test_thc_matches_reference_with_its_sign_and_noise(bits):
    w, block, rows = 4, 1024, 16
    xs = _data((w, rows * block), 20 + bits, scale=1e-2)
    lohi = _lohi(xs)
    jkey = jax.random.PRNGKey(bits)
    want = _thc_reference(xs, jkey, lohi, bits, block)
    sign = np.asarray(jsign(jkey, block))
    noise = np.asarray(jax.random.uniform(jax.random.fold_in(jkey, 1),
                                          (rows, block)))
    xt, st, nt, rt = _t(xs, sign, noise, lohi)
    got = comp.thc_compress(xt, st, nt, rt, bits=bits, block=block)
    assert got.codes.shape == (w, rows, block)
    assert got.codes.dtype == torch.uint8 and got.lohi is rt
    diff = got.codes.numpy().astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= FLIP_RATE * diff.size

    # decode of one code sum: within a rotation's rounding
    jsum = want.astype(np.int32).sum(0)
    ref_out = np.asarray(jcomp.thc_decompress_sum(
        jnp.asarray(jsum), jkey, jnp.asarray(lohi), bits=bits, block=block,
        nsum=w))
    out = comp.thc_decompress_sum(torch.from_numpy(jsum), st, rt, bits=bits,
                                  block=block, nsum=w).numpy()
    assert out.shape == (rows * block,)
    tol = ROT_TOL * float(np.abs(lohi).max())
    np.testing.assert_allclose(out, ref_out, atol=tol, rtol=0)

    # end to end: within what the flipped codes move
    psum = got.codes.to(torch.int32).sum(0)
    out = comp.thc_decompress_sum(psum, st, rt, bits=bits, block=block,
                                  nsum=w).numpy()
    step = (lohi[1] - lohi[0]) / ((1 << bits) - 1)
    moved = np.abs(psum.numpy() - jsum).sum(1)             # per block
    bound = np.repeat(moved * step / (w * math.sqrt(block)), block)
    assert np.all(np.abs(out - ref_out) <= bound + tol)


def test_thc_roundtrip_error_bound():
    """The reference's RMS bound (tests/test_compression.py) on the port's
    own draws: the rotation spreads per-coordinate quantization noise."""
    n, block = 4, 1024
    xs = torch.from_numpy(_data((n, block), 99))
    lohi = torch.tensor([-8.0, 8.0])
    sign = rademacher_sign(generator(key(2)), block)
    noise = torch.rand((1, block), generator=generator(key(3)))
    c = comp.thc_compress(xs, sign, noise, lohi, bits=8, block=block)
    assert isinstance(c, comp.THCCompressed)
    out = comp.thc_decompress_sum(c.codes.to(torch.int32).sum(0), sign, lohi,
                                  bits=8, block=block, nsum=n)
    rms = float(torch.sqrt(torch.mean((out - xs.mean(0)) ** 2)))
    assert rms < 16.0 / 255, rms


def test_thc_rejects_unaligned_length():
    with pytest.raises(ValueError, match="multiple of block"):
        comp.thc_compress(torch.zeros(1000), torch.ones(256),
                          torch.zeros(1, 256), torch.tensor([-1.0, 1.0]),
                          block=256)


# ------------------------------------------------------------------- Top-K
def test_topk_matches_reference_on_tie_free_data():
    """Two rounds with error feedback, each worker separately in the
    reference and all four as one (W, L) call in the port."""
    w, length, k = 4, 512, 20
    rounds = [_data((w, length), s) for s in (30, 31)]
    jstates = [jcomp.topk_init(length) for _ in range(w)]
    state = comp.topk_init(w, length)
    assert state.error.shape == (w, length)
    for x in rounds:
        want = []
        for i in range(w):
            sp, jstates[i] = jcomp.topk_compress(jnp.asarray(x[i]),
                                                 jstates[i], k=k)
            want.append(np.asarray(sp))
        got, state = comp.topk_compress(torch.from_numpy(x), state, k=k)
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
        np.testing.assert_array_equal(
            state.error.numpy(), np.stack([np.asarray(s.error)
                                           for s in jstates]))
        assert (got != 0).sum(-1).tolist() == [k] * w


def test_topk_keeps_largest_and_feeds_back():
    x = torch.tensor([[0.1, -5.0, 0.2, 3.0, -0.05, 0.0]])
    sparse, state = comp.topk_compress(x, comp.topk_init(1, 6), k=2)
    assert set(torch.nonzero(sparse[0]).flatten().tolist()) == {1, 3}
    assert torch.equal(state.error, x - sparse)


# ---------------------------------------------------------------- TernGrad
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_terngrad_matches_reference_with_its_uniform_draw(seed):
    x = _data((777,), 40 + seed, scale=0.3)
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jcomp.terngrad_compress(jnp.asarray(x), jkey))
    u = np.asarray(jax.random.uniform(jkey, x.shape))
    got = comp.terngrad_compress(*_t(x, u)).numpy()
    np.testing.assert_array_equal(got, want)


def test_terngrad_worker_axis_and_zero_rows():
    """A (W, L) call scales each worker by its own max; an all-zero worker
    sends zeros."""
    x = torch.from_numpy(_data((3, 64), 5))
    x[1] = 0.0
    u = torch.rand((3, 64), generator=generator(key(6)))
    out = comp.terngrad_compress(x, u)
    for i in range(3):
        assert torch.equal(out[i], comp.terngrad_compress(x[i], u[i]))
    assert not out[1].any()
    s = x.abs().amax(-1, keepdim=True)
    assert torch.all((out == 0) | (out.abs() == s.expand_as(out)))


def test_terngrad_unbiased():
    x = torch.from_numpy(_data((64,), 7, scale=0.3))
    u = torch.rand((2000, 64), generator=generator(key(8)))
    mean = comp.terngrad_compress(x.expand(2000, 64), u).mean(0)
    assert float((mean - x).abs().max()) < 0.1
