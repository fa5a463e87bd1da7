"""The port's plain versions of the quantized-exchange kernels B3-B6 against
the reference's Pallas kernels (run in interpret mode, as the reference's
own tests run them on the CPU) on the same numpy inputs.

Tolerances, and why:

* B3 amax: the port rotates with the butterfly, the Pallas kernel with two
  Kronecker matmuls; they differ by fp32 rounding, so amax (~3 at unit
  scale) is held to 1e-5 absolute.
* B4 codes: the reference's grids are fed to both sides. A code can still
  differ by one where ``floor`` sits on a boundary and the two rotations
  round to either side of it: codes agree except at most 1 in 10,000, and
  each of those by exactly 1.
* B5: the dequant ``code * step + lo`` rounds twice in the port and may be
  one FMA in XLA; the mean of 4 values of magnitude <= 3 is held to 1e-6.
* B6 codes: no rotation, the same IEEE ops in the same order: bitwise.

The CUDA kernels themselves only run on the card: ``test_torch_cuda.py``
(marked ``cuda``) and ``chip_smoke.py`` hold them bitwise against these
plain versions there.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.dequant_reduce.dequant_reduce import \
    dequant_masked_mean_pallas  # noqa: E402
from repro.kernels.ht_quant.ht_quant import (ht_amax_pallas,  # noqa: E402
                                             ht_quant_pallas)
from repro.kernels.quant.quant import grid_quant_pallas  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.dequant_reduce import dequant_masked_mean  # noqa: E402
from repro_torch.kernels.dequant_reduce import ops as dq_ops  # noqa: E402
from repro_torch.kernels.dequant_reduce import ref as dq_ref  # noqa: E402
from repro_torch.kernels.fwht import randomized_fwht  # noqa: E402
from repro_torch.kernels.ht_quant import (ht_amax, ht_encode_fused,  # noqa: E402
                                          ht_quant, ht_rotate_ref)
from repro_torch.kernels.ht_quant import ops as hq_ops  # noqa: E402
from repro_torch.kernels.ht_quant import ref as hq_ref  # noqa: E402
from repro_torch.kernels.quant import grid_quant  # noqa: E402
from repro_torch.kernels.quant import ops as gq_ops  # noqa: E402
from repro_torch.kernels.quant import ref as gq_ref  # noqa: E402

AMAX_TOL = 1e-5
MEAN_TOL = 1e-6
FLIP_RATE = 1e-4


def _rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    noise = rng.random((rows, n)).astype(np.float32)
    return x, sign, noise


def _grids(amax, bits):
    amax = np.maximum(amax, np.float32(1e-12)).astype(np.float32)
    step = (np.float32(2.0) * amax / np.float32((1 << bits) - 1))
    return (-amax).astype(np.float32), step.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ----------------------------------------------------------------- B3, B4
@pytest.mark.parametrize("n", [16, 256, 1024])
def test_ht_amax_plain_matches_pallas(n):
    x, sign, _ = _rows(7, n, n)                       # ragged: 7 rows of 4
    want = np.asarray(ht_amax_pallas(jnp.asarray(x), jnp.asarray(sign),
                                     block_rows=4, interpret=True))
    got = ht_amax(*_t(x, sign)).numpy()
    np.testing.assert_allclose(got, want, atol=AMAX_TOL, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [16, 256, 1024])
def test_ht_quant_plain_matches_pallas(n, bits):
    """The reference's grids on both sides; codes equal but for isolated
    floor-boundary codes off by one."""
    x, sign, noise = _rows(7, n, 100 + n)
    amax = np.asarray(ht_amax_pallas(jnp.asarray(x), jnp.asarray(sign),
                                     block_rows=4, interpret=True))
    lo, step = _grids(amax, bits)
    want = np.asarray(ht_quant_pallas(*map(jnp.asarray,
                                           (x, sign, noise, lo, step)),
                                      bits=bits, block_rows=4,
                                      interpret=True)).astype(int)
    got = ht_quant(*_t(x, sign, noise, lo, step), bits=bits)
    assert got.dtype == torch.uint8 and got.shape == (7, n)
    diff = got.numpy().astype(int) - want
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= FLIP_RATE * diff.size


def test_ht_quant_is_floor_of_the_plain_rotation():
    """B4's codes are the quantizer applied to B1's encode (the same
    butterfly), bitwise: the rotation is shared, not re-derived."""
    x, sign, noise = _rows(64, 1024, 3)
    xt, st, nt = _t(x, sign, noise)
    rot = randomized_fwht(xt, st, mode="encode")
    assert torch.equal(rot, ht_rotate_ref(xt, st))
    assert torch.equal(ht_encode_fused(xt, st), rot)
    lo, step = _grids(rot.abs().amax(-1).numpy(), 8)
    assert torch.equal(ht_amax(xt, st), rot.abs().amax(-1))
    want = gq_ref.grid_quant_ref(rot, nt, *_t(lo, step), bits=8)
    assert torch.equal(ht_quant(xt, st, nt, *_t(lo, step), bits=8), want)


def test_peer_stack_shares_grids_noise_and_sign():
    """A (P, R, n) stack with one (R, n) noise and (R,) grids is P separate
    calls, also on a strided arena slice (what one launch a bucket reads)."""
    p, r, n = 4, 6, 256
    arena = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (p, 3, r * n)).astype(np.float32))
    x = arena[:, 1].view(p, r, n)
    _, sign, noise = _rows(r, n, 2)
    st, nt = _t(sign, noise)
    amax = ht_amax(x, st)
    assert amax.shape == (p, r)
    shared = amax.amax(0)
    lo, step = -shared, 2.0 * shared / 255
    codes = ht_quant(x, st, nt, lo, step, bits=8)
    for i in range(p):
        assert torch.equal(amax[i], ht_amax(x[i], st))
        assert torch.equal(codes[i], ht_quant(x[i], st, nt, lo, step,
                                              bits=8))


@pytest.mark.parametrize("n", [16, 256])
def test_non_finite_blocks_match_pallas(n):
    """A NaN and an inf each spread over their block in the rotation: the
    block's amax is NaN (inf), as ``jnp.max`` gives it, and its codes on
    such grids are 0, as XLA's float-to-uint8 convert makes of NaN."""
    x, sign, noise = _rows(7, n, 300 + n)
    x[2, 3] = np.nan
    x[5, 0] = np.inf
    want = np.asarray(ht_amax_pallas(jnp.asarray(x), jnp.asarray(sign),
                                     block_rows=4, interpret=True))
    got = ht_amax(*_t(x, sign)).numpy()
    assert np.isnan(got[2]) and np.isinf(got[5])
    np.testing.assert_allclose(got, want, atol=AMAX_TOL, rtol=0)
    lo, step = _grids(want, 8)
    codes = ht_quant(*_t(x, sign, noise, lo, step), bits=8).numpy()
    want = np.asarray(ht_quant_pallas(*map(jnp.asarray,
                                           (x, sign, noise, lo, step)),
                                      bits=8, block_rows=4, interpret=True))
    assert not codes[[2, 5]].any()
    diff = codes.astype(int) - want.astype(int)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= FLIP_RATE * diff.size + 1


# --------------------------------------------------------------------- B5
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("s,block", [(1536, 512), (2048, 256), (64, 16)])
def test_dequant_mean_plain_matches_pallas(s, block, masked):
    """Both kernel variants; 1536 columns are not a multiple of the Pallas
    tile (1024)."""
    rng = np.random.default_rng(s + masked)
    n = 4
    codes = rng.integers(0, 256, (n, s)).astype(np.uint8)
    lo, step = _grids((rng.random(s // block) * 3 + 0.1).astype(np.float32),
                      8)
    mask = None
    if masked:
        mask = (rng.random((n, s)) < 0.7).astype(np.float32)
        mask[:, 5:9] = 0.0                   # columns no peer delivered
    want = np.asarray(dequant_masked_mean_pallas(
        jnp.asarray(codes), jnp.asarray(np.repeat(lo, block)),
        jnp.asarray(np.repeat(step, block)),
        None if mask is None else jnp.asarray(mask), tile=1024,
        interpret=True))
    got = dequant_masked_mean(*_t(codes, lo, step),
                              None if mask is None else torch.from_numpy(mask),
                              block=block).numpy()
    np.testing.assert_allclose(got, want, atol=MEAN_TOL, rtol=0)
    if masked:
        assert np.all(got[5:9] == 0.0)


def test_dequant_mean_receiver_axis_reads_each_receivers_grids():
    """(R, N, S) codes on the all_to_all view with (R, S/block) grid slices
    equal R separate reductions."""
    rng = np.random.default_rng(5)
    p, s, block = 4, 512, 128
    sent = torch.from_numpy(rng.integers(0, 256, (p, p * s)).astype(np.uint8))
    received = sent.view(p, p, s).transpose(0, 1)
    amax = torch.from_numpy(rng.random(p * s // block).astype(np.float32) + 1)
    lo, step = (-amax).view(p, -1), (2 * amax / 255).view(p, -1)
    mask = torch.from_numpy((rng.random((p, p, s)) < 0.8).astype(np.float32))
    for m in (mask, None):
        got = dequant_masked_mean(received, lo, step, m, block=block)
        for r in range(p):
            want = dequant_masked_mean(received[r], lo[r], step[r],
                                       None if m is None else m[r],
                                       block=block)
            assert torch.equal(got[r], want)


# --------------------------------------------------------------------- B6
@pytest.mark.parametrize("bits", [8, 3])
@pytest.mark.parametrize("rows,c", [(130, 256), (5, 64)])
def test_grid_quant_plain_matches_pallas(rows, c, bits):
    """130 rows: not a multiple of the Pallas row block (128)."""
    rng = np.random.default_rng(rows + bits)
    x = (rng.standard_normal((rows, c)) * 2).astype(np.float32)
    noise = rng.random((rows, c)).astype(np.float32)
    lo, step = _grids(np.abs(x).max(1), bits)
    want = np.asarray(grid_quant_pallas(*map(jnp.asarray,
                                             (x, noise, lo, step)),
                                        bits=bits, interpret=True))
    got = grid_quant(*_t(x, noise, lo, step), bits=bits).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_quant_non_finite_values_match_pallas():
    """A NaN value, a NaN grid and an inf grid give code 0, an inf value
    the top code, as in the Pallas kernel."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    x[0, 3], x[1, 5] = np.nan, np.inf
    noise = rng.random((6, 64)).astype(np.float32)
    lo, step = _grids(np.abs(np.nan_to_num(x, posinf=0)).max(1), 8)
    lo[2], step[3] = np.nan, np.inf
    want = np.asarray(grid_quant_pallas(*map(jnp.asarray,
                                             (x, noise, lo, step)),
                                        bits=8, interpret=True))
    got = grid_quant(*_t(x, noise, lo, step), bits=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 3] == 0 and got[1, 5] == 255
    assert not got[2].any() and not got[3].any()


def test_grid_quant_shares_noise_and_reads_grids_by_row():
    """Stage 2: (P * R, C) rows, one (R, C) noise for every receiver and the
    bucket's (P * R,) grids, equals the expanded reference form."""
    rng = np.random.default_rng(9)
    p, r, c = 4, 3, 64
    x = rng.standard_normal((p * r, c)).astype(np.float32)
    noise = rng.random((r, c)).astype(np.float32)
    lo, step = _grids(np.abs(x).max(1), 8)
    got = grid_quant(*_t(x, noise, lo, step), bits=8)
    want = np.asarray(grid_quant_pallas(
        *map(jnp.asarray, (x, np.tile(noise, (p, 1)), lo, step)), bits=8,
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="must divide"):
        grid_quant(*_t(x, np.tile(noise, (2, 1))[:5], lo, step), bits=8)


# ------------------------------------------------------- dispatch, bounds
def test_wrappers_in_kernel_mode_raise_on_cpu():
    x = torch.zeros((2, 16))
    codes = torch.zeros((4, 16), dtype=torch.uint8)
    g = torch.ones(2)
    with runtime.kernel_mode_scope("kernel"):
        for call in (lambda: ht_amax(x, torch.ones(16)),
                     lambda: ht_quant(x, torch.ones(16), x, g, g),
                     lambda: dequant_masked_mean(codes, g[:1], g[:1],
                                                 block=16),
                     lambda: grid_quant(x, x, g, g)):
            with pytest.raises(RuntimeError, match="CUDA tensor"):
                call()
    assert hq_ops.amax_launches == hq_ops.quant_launches == 0
    assert dq_ops.launches == gq_ops.launches == 0


def test_bounds_count_each_byte_once():
    """At the main path's shapes (24 buckets of 6,553,600 fp32, block 1024,
    4 peers): 6,400 blocks a peer, shards of 1,600 blocks."""
    rows, n, g = 4 * 6_400, 1024, 6_400
    assert hq_ref.ht_amax_bytes(rows, n) == 4 * (rows * n + n + rows)
    assert hq_ref.ht_quant_bytes(rows, n, g, g) == \
        4 * rows * n + 4 * g * n + 8 * g + 4 * n + rows * n
    s = 1_600 * 1024
    assert dq_ref.dequant_mean_bytes(4, 4, s, 1024, masked=True) == \
        4 * 4 * s * 5 + 8 * 4 * 1_600 + 4 * 4 * s
    assert dq_ref.dequant_mean_bytes(4, 4, s, 1024, masked=False) == \
        4 * 4 * s + 8 * 4 * 1_600 + 4 * 4 * s
    assert gq_ref.grid_quant_bytes(4 * 1_600, 1024, 1_600, 6_400) == \
        5 * 4 * s + 4 * s + 8 * 6_400
    mb = [hq_ref.ht_amax_bytes(rows, n) / 1e6,
          hq_ref.ht_quant_bytes(rows, n, g, g) / 1e6,
          dq_ref.dequant_mean_bytes(4, 4, s, 1024, masked=True) / 1e6,
          gq_ref.grid_quant_bytes(4 * 1_600, 1024, 1_600, 6_400) / 1e6]
    assert [round(v) for v in mb] == [105, 157, 157, 39]
