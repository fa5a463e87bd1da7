"""The port's plain kernel versions against the reference's Pallas kernels
(run in interpret mode, as the reference's own tests run them on the CPU)
and oracles, on the same numpy inputs.

Tolerance: fp32 rounding. The butterfly's adds run in the same order on
both sides (bitwise in practice); the Pallas kernel and the Kronecker form
take the product as two matmuls, ~1e-6 from the butterfly at unit scale,
so rotations are held to 1e-5. The masked mean sums at most 4 products:
1e-6.

The CUDA kernels themselves only run on the card: ``test_torch_cuda.py``
(marked ``cuda``) and ``chip_smoke.py`` hold them against these plain
versions there.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.fwht import ref as jref  # noqa: E402
from repro.kernels.fwht.fwht import fwht_pallas  # noqa: E402
from repro.kernels.masked_sum.masked_sum import masked_mean_pallas  # noqa: E402
from repro.kernels.masked_sum.ref import masked_mean_ref as jmm_ref  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.fwht import fwht, randomized_fwht  # noqa: E402
from repro_torch.kernels.fwht import ops as fwht_ops  # noqa: E402
from repro_torch.kernels.fwht import ref as tref  # noqa: E402
from repro_torch.kernels.masked_sum import masked_mean  # noqa: E402
from repro_torch.kernels.masked_sum import ops as mm_ops  # noqa: E402
from repro_torch.kernels.masked_sum.ref import masked_mean_ref  # noqa: E402

ROT_TOL = 1e-5
MEAN_TOL = 1e-6


def _inputs(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    sign = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return x, sign


@pytest.mark.parametrize("n", [16, 256, 1024, 4096])
@pytest.mark.parametrize("mode", ["none", "pre", "post"])
def test_fwht_plain_matches_pallas(n, mode):
    x, sign = _inputs(5, n, n)                       # ragged: 5 rows
    want = np.asarray(fwht_pallas(jnp.asarray(x), jnp.asarray(sign),
                                  sign_mode=mode, block_rows=4,
                                  interpret=True))
    xt, st = torch.from_numpy(x), torch.from_numpy(sign)
    if mode == "none":
        got = fwht(xt)
    else:
        got = randomized_fwht(xt, st, mode="encode" if mode == "pre"
                              else "decode")
    np.testing.assert_allclose(got.numpy(), want, atol=ROT_TOL, rtol=0)


@pytest.mark.parametrize("n", [16, 256, 1024, 4096])
def test_fwht_butterfly_matches_reference_oracle(n):
    x, _ = _inputs(3, n, 7 + n)
    want = np.asarray(jax.jit(jref.fwht_ref)(jnp.asarray(x)))
    np.testing.assert_allclose(tref.fwht_ref(torch.from_numpy(x)).numpy(),
                               want, atol=ROT_TOL, rtol=0)


@pytest.mark.parametrize("n", [16, 128, 2048])
def test_fwht_kronecker_form_matches_reference(n):
    x, _ = _inputs(4, n, 11 + n)
    want = np.asarray(jref.fwht_mxu_ref(jnp.asarray(x)))
    got = tref.fwht_mxu_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ROT_TOL, rtol=0)
    np.testing.assert_allclose(
        got, tref.fwht_ref(torch.from_numpy(x)).numpy(), atol=ROT_TOL)


def test_hadamard_matrix_and_factors_match_reference():
    for n in (16, 32, 1024):
        assert tref.split_factors(n) == jref.split_factors(n)
        np.testing.assert_array_equal(tref.hadamard_matrix(n).numpy(),
                                      np.asarray(jref.hadamard_matrix(n)))


def test_randomized_fwht_roundtrip_and_peer_view():
    """decode(encode(x)) == x, and a (P, R, n) stack of peers transforms
    like its rows (what one launch per bucket relies on)."""
    x, sign = _inputs(12, 1024, 3)
    xt, st = torch.from_numpy(x), torch.from_numpy(sign)
    enc = randomized_fwht(xt, st, mode="encode")
    np.testing.assert_allclose(randomized_fwht(enc, st, mode="decode")
                               .numpy(), x, atol=ROT_TOL)
    stacked = randomized_fwht(xt.view(3, 4, 1024), st, mode="encode")
    assert torch.equal(stacked.reshape(12, 1024), enc)


def _mask_inputs(n, length, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, length)).astype(np.float32)
    m = (rng.random((n, length)) < 0.7).astype(np.float32)
    m[:, 5:40] = 0.0                       # columns no peer delivered
    return x, m


@pytest.mark.parametrize("length", [2048, 3000, 5])
def test_masked_mean_plain_matches_pallas(length):
    x, m = _mask_inputs(4, length, length)         # 3000: not a tile multiple
    m = m[:, :length]
    want = np.asarray(masked_mean_pallas(jnp.asarray(x), jnp.asarray(m),
                                         tile=1024, interpret=True))
    got = masked_mean(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=MEAN_TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jmm_ref(x, m)),
                               atol=MEAN_TOL, rtol=0)
    dead = m.sum(0) == 0
    assert np.all(got[dead] == 0.0)


def test_masked_mean_receiver_axis_batches_receivers():
    """(R, N, L) -> (R, L) equals R separate (N, L) reductions, also on the
    strided all_to_all view."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((4, 4 * 300))
                            .astype(np.float32))
    received = data.view(4, 4, 300).transpose(0, 1)
    mask = torch.from_numpy((rng.random((4, 4, 300)) < 0.8)
                            .astype(np.float32))
    got = masked_mean(received, mask)
    for r in range(4):
        assert torch.equal(got[r], masked_mean_ref(received[r], mask[r]))


def test_kernel_mode_kernel_on_cpu_raises():
    x = torch.zeros((2, 16))
    with runtime.kernel_mode_scope("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            fwht(x)
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            masked_mean(x, x)
    assert fwht_ops.launches == 0 and mm_ops.launches == 0


def test_kernel_mode_rejects_unknown():
    with pytest.raises(ValueError):
        runtime.set_kernel_mode("interpret")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert runtime.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runtime.resolve_device(None)
    assert runtime.resolve_device("cpu").type == "cpu"


def test_bounds_count_each_byte_once():
    from repro_torch.kernels.masked_sum.ref import masked_mean_bytes
    assert tref.fwht_bytes(25_600, 1024) == 4 * (2 * 25_600 * 1024 + 1024)
    assert masked_mean_bytes(4, 4, 1_638_400) == \
        4 * (2 * 4 * 4 * 1_638_400 + 4 * 1_638_400)
