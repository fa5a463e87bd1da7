"""Plain PyTorch versions of the (randomized) fast Walsh-Hadamard transform.

Counterpart of ``src/repro/kernels/fwht/ref.py``, with both of its forms:

* ``fwht_ref``      the O(n log n) butterfly, lowest index bit first: the
  arithmetic the CUDA kernel (``csrc/fwht.cu``) performs, and what the
  wrapper runs for a CPU tensor.
* ``fwht_mxu_ref``  the Kronecker form H_n = H_a (x) H_b (two matmuls on an
  (a, b) reshape): the math the TPU kernel runs on its matrix unit.

Both are orthonormal, in Sylvester (natural) order: ``fwht(fwht(x)) == x``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    if (1 << k) != n:
        raise ValueError(f"block size must be a power of two, got {n}")
    return k


@functools.lru_cache(maxsize=32)
def hadamard_matrix_np(n: int) -> np.ndarray:
    """Unnormalized n x n Hadamard (Sylvester construction), float32."""
    _log2(n)
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int, *, orthonormal: bool = True,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    h = hadamard_matrix_np(n)
    if orthonormal:
        h = h / np.sqrt(n).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(h)).to(device)


def split_factors(n: int) -> tuple[int, int]:
    """n = a * b with a, b powers of two and a >= b (a = 2^ceil(k/2))."""
    k = _log2(n)
    return 1 << ((k + 1) // 2), 1 << (k // 2)


def fwht_unnormalised_ref(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised H x over the last axis, fp32: the butterfly's adds,
    lowest index bit first, without the 1/sqrt(n) scale."""
    shape = x.shape
    n = shape[-1]
    _log2(n)
    y = x.to(torch.float32).reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2).reshape(-1, n)
        h *= 2
    return y.reshape(shape)


def orthonormal_scale_ref(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y / sqrt(n)``: a true division, by a 0-dim tensor on y's device
    (CUDA divides by a CPU scalar as a multiply by its reciprocal)."""
    return y / torch.full((), float(n), device=y.device).sqrt()


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FWHT over the last axis (butterfly oracle)."""
    return orthonormal_scale_ref(fwht_unnormalised_ref(x), x.shape[-1]).to(
        x.dtype)


def fwht_mxu_ref(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FWHT over the last axis, Kronecker-factored (the TPU
    kernel's form): a block reshaped to X[a, b] transforms as H_a X H_b."""
    shape, dtype = x.shape, x.dtype
    a, b = split_factors(shape[-1])
    ha = hadamard_matrix(a, device=x.device)
    hb = hadamard_matrix(b, device=x.device)
    xr = x.to(torch.float32).reshape(-1, a, b)
    t = torch.einsum("rjl,lk->rjk", xr, hb)
    y = torch.einsum("ij,rjk->rik", ha, t)
    return y.reshape(shape).to(dtype)


def randomized_fwht_ref(x: torch.Tensor, sign: torch.Tensor, *,
                        mode: str) -> torch.Tensor:
    """encode: H (d * x); decode: d * (H y). Orthonormal H makes decode the
    exact inverse of encode."""
    if mode == "encode":
        return fwht_ref(x * sign)
    if mode == "decode":
        return fwht_ref(x) * sign
    raise ValueError(f"unknown mode {mode!r}")


def fwht_bytes(rows: int, n: int) -> int:
    """Bytes the transform must move: each fp32 input read once, each output
    written once (the sign is n words, counted too)."""
    return 4 * (2 * rows * n + n)


def fwht_flops(rows: int, n: int) -> int:
    """Adds of the butterfly (n log2 n a row) plus the scale and sign."""
    return rows * n * (int(math.log2(n)) + 2)
