"""The identities the rotate kernels B3 and B4 (``ht_quant/csrc/ht_quant.cu``)
and B1's scale rest on, pinned on the plain arithmetic with seeded numpy
inputs:

(i)  B3 takes the max of the unnormalised |H (d * x)| on the fp32 bit
     patterns with the sign cleared, and divides once a row by sqrt(n): a
     correctly rounded division by a positive constant is monotone, so this
     equals ``ht_amax_ref`` (the max of the scaled values) bitwise, NaN, inf,
     subnormal and all-zero rows included;
(ii) for even log2(n), sqrt(n) is a power of two, so ``v / sqrt(n)`` and
     ``v * 2^(-log2(n)/2)`` are the same correctly rounded number: the
     kernels' multiply is bitwise the plain version's division.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fwht.ref import (fwht_unnormalised_ref,
                                          orthonormal_scale_ref)
from repro_torch.kernels.ht_quant.ref import ht_amax_ref

SIZES = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _rows(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random rows, then rows holding a NaN, +inf, -inf, two infs of
    opposite sign, subnormals only, zeros only, and huge values."""
    x = rng.standard_normal((12, n)).astype(np.float32)
    x[1, 3] = np.nan
    x[2, 0] = np.inf
    x[3, n - 1] = -np.inf
    x[4, 1], x[4, 2] = np.inf, -np.inf
    x[5] = (rng.standard_normal(n) * 1e-41).astype(np.float32)   # subnormal
    x[6] = 0.0
    x[7] = -0.0
    x[8] = (rng.standard_normal(n) * 1e37).astype(np.float32)
    x[9, :] = np.float32(1e-45)                                   # smallest
    return x


@pytest.mark.parametrize("n", SIZES)
def test_amax_of_unnormalised_rotation_scaled_once_equals_plain(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_rows(n, rng))
    sign = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0)
                            .astype(np.float32))
    want = ht_amax_ref(x, sign)
    v = fwht_unnormalised_ref(x * sign)
    # the kernel's max: unsigned order of the patterns with the sign cleared
    # (NaN > inf > finite), then one division a row
    m = (_bits(v) & 0x7FFFFFFF).amax(-1).view(torch.float32)
    got = orthonormal_scale_ref(m, n)
    torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
    assert torch.equal(_bits(got[~want.isnan()]), _bits(want[~want.isnan()]))
    assert bool(want[1].isnan()) and bool(want[2].isinf())
    assert float(want[6]) == 0.0 and float(want[7]) == 0.0
    assert 0.0 < float(want[5]) < 1.2e-38                        # subnormal


@pytest.mark.parametrize("n", [s for s in SIZES if s.bit_length() % 2 == 1])
def test_scale_by_power_of_two_equals_division_by_sqrt_n(n):
    rng = np.random.default_rng(1000 + n)
    k = n.bit_length() - 1
    parts = [np.clip(rng.standard_normal(4096) * 10.0 ** e, -3e38, 3e38)
             for e in (-44, -40, -38, -30, -3, 0, 3, 30, 37, 38)]
    v = np.concatenate(parts + [
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                  3.4028235e38, -3.4028235e38, 1.1754944e-38])])
    v = torch.from_numpy(v.astype(np.float32))
    divided = orthonormal_scale_ref(v, n)
    multiplied = v * np.float32(2.0 ** (-k // 2))
    assert torch.equal(_bits(divided), _bits(multiplied))
    # the same in numpy's own float32 arithmetic
    vn = v.numpy()
    assert np.array_equal(
        (vn / np.sqrt(np.float32(n))).view(np.int32),
        (vn * np.float32(2.0 ** (-k // 2))).view(np.int32))
