"""The port's threefry keys and draws (``repro_torch/core/keys.py``, the
plain version of the draw kernel in ``kernels/threefry/ref.py``) against
``jax.random`` on the CPU, and the sync engine's default draws
(:class:`ThreefryDraws`) against the reference's own sign, masks and noise.

Keys, splits, folds, bits, uniforms, Bernoulli draws and ``randint`` are
held bit for bit, and so is the port's emulation of XLA's CPU ``log``.
``normal`` is held within 2 ulp: the port evaluates XLA's fp32 ``ErfInv``
polynomial over XLA's CPU ``log1p``, fused multiply-adds where XLA fuses
them, and about two values in 10^5 still differ (the test bounds how
many).
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.core import drops as jdrops  # noqa: E402
from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro_torch.core import drops, keys  # noqa: E402
from repro_torch.core.hadamard import rademacher_sign  # noqa: E402
from repro_torch.core.pipeline import (OptiReduceConfig,  # noqa: E402
                                       ThreefryDraws)
from repro_torch.kernels.threefry import ref as tf_ref  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 129), (1000,)]
NORMAL_ULP = 2
# spans up to 2^16, then past it (the multiplier's square wraps in uint32),
# a power of two, the full int32 span and an empty one
RANDINT_BOUNDS = ((0, 50257), (3, 10), (-7, 7), (0, 65_537), (0, 100_000),
                  (0, 100_352), (0, 151_552), (0, 151_936), (0, 256_000),
                  (0, 2 ** 20), (-2 ** 31, 2 ** 31 - 1), (5, 3))


def _jkey(k):
    return jnp.asarray(np.asarray(k, np.uint32))


def _pair(jk) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(jk)))


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(
                      np.int64))


@pytest.mark.parametrize("seed", SEEDS + [
    -5, 3 * 2 ** 32 + 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 40 + 5, -1,
    -2 ** 31, -2 ** 31 - 1, 2 ** 63 - 1, -2 ** 63, 2 ** 63, -2 ** 63 - 1])
def test_prng_key_is_the_seeds_two_words(seed):
    """``PRNGKey`` without x64 keeps the seed's low word; a seed past
    int64 raises ``OverflowError`` in both."""
    try:
        want = _pair(jax.random.PRNGKey(seed))
    except OverflowError:
        with pytest.raises(OverflowError):
            keys.key(seed)
        return
    assert keys.key(seed) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_match(seed):
    k, jk = keys.key(seed), jax.random.PRNGKey(seed)
    for d in (0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        assert keys.fold_in(k, d) == _pair(jax.random.fold_in(jk, d))
    for num in (1, 2, 5):
        want = [tuple(int(w) for w in row)
                for row in np.asarray(jax.random.split(jk, num))]
        assert list(keys.split(k, num)) == want
    for count in (9, 40):               # a Python loop, then numpy
        data = np.arange(count) * 1_000_003
        many = keys.fold_in_many(k, data)
        assert [tuple(r) for r in many.tolist()] == [
            keys.fold_in(k, int(d)) for d in data]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_uniform_bernoulli_randint_bitwise(seed, shape):
    k = keys.fold_in(keys.key(seed), 3)
    jk = _jkey(k)
    np.testing.assert_array_equal(keys.bits(k, shape),
                                  np.asarray(jax.random.bits(jk, shape)))
    for lo, hi in ((0.0, 1.0), (1.0, 16.0), (-3.0, 0.5)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        got = keys.uniform(k, shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    for p in (0.5, 0.3, 0.95):
        np.testing.assert_array_equal(
            keys.bernoulli(k, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))
    for lo, hi in RANDINT_BOUNDS:
        np.testing.assert_array_equal(
            keys.randint(k, shape, lo, hi),
            np.asarray(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("bounds", [(0, 2 ** 31), (-2 ** 31 - 1, 5),
                                    (0, 2 ** 40)])
def test_randint_bounds_past_int32_raise(bounds):
    k = keys.key(3)
    with pytest.raises(OverflowError):
        jax.random.randint(_jkey(k), (4,), *bounds)
    with pytest.raises(OverflowError):
        keys.randint(k, (4,), *bounds)


@pytest.mark.parametrize("arch", ["glm4-9b", "command-r-plus-104b"])
def test_serve_prompts_match_reference(arch):
    """``launch/serve.py``'s prompts, ``randint(key(seed), (batch,
    prompt_len), 0, vocab)``, are the reference launcher's for a
    vocabulary past 2^16 (the draw only, no model)."""
    from repro.configs import get_config as jconfig
    from repro_torch.configs import get_config
    vocab = get_config(arch).vocab_size
    assert vocab == jconfig(arch).vocab_size and vocab > 2 ** 16
    for seed in (0, 7):
        want = jax.random.randint(jax.random.PRNGKey(seed), (4, 16), 0, vocab)
        np.testing.assert_array_equal(
            keys.randint(keys.key(seed), (4, 16), 0, vocab),
            np.asarray(want))


def test_hi_counter_word_matches_threefry():
    """A flat index past 2^32 puts its high word in the first counter: the
    plain version's and the host's hash against jax's threefry2x32 on
    counters with a nonzero high word (no draw that long fits here)."""
    k = keys.fold_in(keys.key(9), 1)
    hi = np.array([1, 2, 7, 2 ** 31, 2 ** 32 - 1], np.uint32)
    lo = np.array([0, 5, 2 ** 32 - 1, 123, 77], np.uint32)
    out = np.asarray(jprng.threefry_2x32(_jkey(k), np.concatenate([hi, lo])))
    want0, want1 = out[:5], out[5:]
    x0, x1 = tf_ref.threefry2x32(
        torch.tensor(k[0]), torch.tensor(k[1]),
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(x0.numpy(), want0.astype(np.int64))
    np.testing.assert_array_equal(x1.numpy(), want1.astype(np.int64))
    h0, h1 = keys._hash_np(k[0], k[1], hi, lo)
    np.testing.assert_array_equal(h0, want0)
    np.testing.assert_array_equal(h1, want1)


@pytest.mark.parametrize("seed", [0, 11])
def test_normal_within_two_ulp(seed):
    k = keys.key(seed)
    n = 100_000
    want = np.asarray(jax.random.normal(_jkey(k), (n,)))
    got = keys.normal(k, (n,)).numpy()
    d = _ulp(got, want)
    i = int(d.argmax())
    assert d.max() <= NORMAL_ULP, (
        f"index {i}: port {got[i]!r} ({got.view(np.uint32)[i]:#010x}), "
        f"jax {want[i]!r} ({want.view(np.uint32)[i]:#010x}), {d[i]} ulp")
    # measured: 51 values in 3 * 10^6 differ at all, over 60 keys
    assert (d > 0).sum() <= 20, (d > 0).sum()
    small = np.asarray(jax.random.normal(_jkey(k), (3, 7)))
    assert _ulp(keys.normal(k, (3, 7)).numpy(), small).max() <= NORMAL_ULP


def test_log_matches_xla_bitwise():
    """``a_log``'s ``log(uniform(1, 16))`` and the normal's ``log1p`` rest on
    XLA's CPU ``log``, emulated to the bit."""
    v = np.exp(np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (50000,),
                                             minval=-80.0, maxval=80.0)))
    v = v.astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(v))
    got = tf_ref.log_xla(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_draw_batch_rows_are_per_key_draws():
    ks = [keys.fold_in(keys.key(2), i) for i in range(5)]
    batch = keys.uniform_batch(ks, 33)
    for i, k in enumerate(ks):
        assert torch.equal(batch[i], keys.uniform(k, (33,)))
    more = [keys.fold_in(keys.key(2), i) for i in range(300)]
    big = keys.bernoulli_batch(more, 0.5, 8)       # past one launch's keys
    assert big.shape == (300, 8)
    assert torch.equal(big[299], keys.bernoulli(more[299], 0.5, (8,)))


# ----------------------------------------- the sync engine's default draws
def test_sign_matches_reference():
    k = keys.fold_in(keys.key(4), 2)
    for block in (64, 1024):
        np.testing.assert_array_equal(
            rademacher_sign(k, block).numpy(),
            np.asarray(jsign(_jkey(k), block)))


@pytest.mark.parametrize("pattern", ["bernoulli", "tail", "straggler",
                                     "burst"])
@pytest.mark.parametrize("rate", [0.05, 0.3])
def test_masks_match_reference(pattern, rate):
    n, s, pkt = 4, 3000, 64
    for r in range(n):
        k = keys.fold_in(keys.key(6), r)
        want = np.asarray(jdrops.make_mask(pattern, _jkey(k), n, s,
                                           rate=rate, packet_elems=pkt,
                                           self_index=jnp.int32(r)))
        got = drops.make_mask(pattern, k, n, s, rate=rate, packet_elems=pkt,
                              self_index=r).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", ["tail", "burst"])
def test_threefry_draws_serve_the_reference_sites(pattern):
    """Bucket b's sign is the sign of ``fold_in(sync_key, b)``, receiver r's
    mask comes from ``fold_in(bucket_key, r)``, a noise is ``uniform(
    fold_in(bucket_key, salt))``; a gather site's path folds each element
    in; the batched forms equal the one-site draws."""
    cfg = OptiReduceConfig(drop_rate=0.1, drop_pattern=pattern,
                           packet_elems=32)
    skey = keys.fold_in(keys.key(0), 7)
    draws = ThreefryDraws(skey, cfg, torch.device("cpu"))
    for b in (0, 3):
        bkey = jax.random.fold_in(_jkey(skey), b)
        np.testing.assert_array_equal(draws.sign(b, 256).numpy(),
                                      np.asarray(jsign(bkey, 256)))
        for r in range(4):
            want = jdrops.make_mask(pattern, jax.random.fold_in(bkey, r), 4,
                                    500, rate=0.1, packet_elems=32,
                                    self_index=jnp.int32(r))
            np.testing.assert_array_equal(draws.mask(b, r, 4, 500).numpy(),
                                          np.asarray(want))
        for salt in (3, 4, 9):
            want = jax.random.uniform(jax.random.fold_in(bkey, salt), (5, 64))
            np.testing.assert_array_equal(draws.noise(b, salt, (5, 64))
                                          .numpy(), np.asarray(want))
    site = jax.random.fold_in(_jkey(skey), 2)
    np.testing.assert_array_equal(draws.sign((2,), 128).numpy(),
                                  np.asarray(jsign(site, 128)))
    assert torch.equal(draws.sign((), 128),
                       rademacher_sign(skey, 128))
    assert torch.equal(draws.signs([0, 3], 256)[1], draws.sign(3, 256))
    assert torch.equal(draws.noises([0, 3], 4, (2, 8))[1],
                       draws.noise(3, 4, (2, 8)))
    rows = [(b, r, r) for b in (0, 3) for r in range(4)]
    batch = draws.masks(rows, 4, 500)
    for i, (b, r, _) in enumerate(rows):
        assert torch.equal(batch[i], draws.mask(b, r, 4, 500))


def test_burst_chain_matches_a_packet_loop():
    """The Gilbert-Elliott mask without a loop equals the chain stepped
    packet by packet over the same uniforms (the reference's scan)."""
    k = keys.key(12)
    n, pkts, rate = 8, 400, 0.2
    p, r = drops.gilbert_elliott_params(rate)
    k0, k1 = keys.split(k)
    bad = (keys.uniform(k0, (n,)) < torch.tensor(min(rate, 0.999))).numpy()
    u = keys.uniform(k1, (pkts, n)).numpy()
    rows = []
    for t in range(pkts):
        bad = np.where(bad, u[t] >= np.float32(r), u[t] < np.float32(p))
        rows.append(bad)
    want = 1.0 - np.stack(rows).T.astype(np.float32)
    got = drops.burst_mask(k, n, pkts, rate=rate, packet_elems=1).numpy()
    np.testing.assert_array_equal(got, want)
