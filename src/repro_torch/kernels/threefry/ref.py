"""Plain PyTorch version of the threefry draw kernel (``csrc/threefry.cu``).

The counterpart of ``jax.random``'s draws under ``jax_threefry_partitionable``
(the reference's jax 0.9.0 default): output ``i`` of a draw under key
``(k0, k1)`` hashes the counter pair ``(hi32(i), lo32(i))`` with
threefry2x32 and takes ``x0 ^ x1`` as its 32 random bits, ``i`` being the
row-major flat index. 32-bit integer arithmetic runs in int64 tensors masked
with ``0xFFFFFFFF`` (torch has no wrapping uint32 arithmetic), on whatever
device the caller names: this is what a CPU draw runs, and what the kernel
is held to bit for bit on the card.

Modes (``MODES``):
  ``uniform``    ``bitcast((bits >> 9) | 0x3F800000) - 1``, then
                 ``* (b - a) + a`` and ``max(a, .)``, all in fp32
                 (``jax.random.uniform(key, shape, minval=a, maxval=b)``);
  ``bernoulli``  ``uniform < float32(a)`` as 0/1 fp32
                 (``jax.random.bernoulli(key, a, shape)``);
  ``normal``     ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))``
                 with XLA's fp32 ``ErfInv`` (Giles' two-branch polynomial)
                 over XLA's CPU ``log1p`` and ``log``, multiply-adds fused
                 where XLA fuses them; not ``torch.erfinv``, which computes
                 another approximation (``jax.random.normal``; within 2 ulp
                 of it, about two values in 10^5 differ).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFF_FFFF
MODES = {"uniform": 0, "bernoulli": 1, "normal": 2}
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# jax.random.normal's uniform range: [nextafter(-1, 0), 1)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's ErfInv32 coefficients, highest degree first: w < 5, then w >= 5
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32 (20 rounds) on int64 tensors holding uint32 values;
    keys and counters broadcast. Returns ``(x0, x1)``."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def bits_ref(keys: torch.Tensor, n: int,
             device: torch.device | str = "cpu") -> torch.Tensor:
    """``(K, n)`` int64 tensor of 32 random bits a value (``random_bits``)."""
    k = keys.to(torch.int64) & MASK
    k0 = k[:, 0:1].to(device)
    k1 = k[:, 1:2].to(device)
    i = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return x0 ^ x1


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) fp32 from 32 random bits: 23 mantissa bits over 1.0, less 1."""
    f = ((bits >> 9) | 0x3F80_0000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` on fp32 tensors with one rounding, as the card's
    ``fmaf`` and XLA's contracted multiply-adds round it: the product is
    exact in fp64, the sum is rounded to odd in fp64 (TwoSum, then the odd
    neighbour when inexact), which rounds correctly to fp32."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64) if torch.is_tensor(c) else torch.full(
        (), c, dtype=torch.float64, device=p.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def scale(u: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """``max(a, u * (b - a) + a)`` in fp32, the multiply-add fused as XLA
    fuses it."""
    if a == 0.0 and b == 1.0:
        return u
    lo, hi = _f32(a, u.device), _f32(b, u.device)
    return torch.maximum(lo, fma(u, hi - lo, lo))


# XLA's CPU log for fp32 (Cephes), its log1p's small-argument rational
# approximation (Cephes), in the order XLA evaluates them
LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
         -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
         2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
LOG_Q1, LOG_Q2 = -2.12194440E-4, 0.693359375
SQRTHF = 0.707106781186547524
LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
             6.5787325942061044846969E0, 2.9911919328553073277375E1,
             6.0949667980987787057556E1, 5.7112963590585538103336E1,
             2.0039553499201281259648E1)
LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
             2.2176239823732856465394E2, 3.0909872225312059774938E2,
             2.1642788614495947685003E2, 6.0118660497603843919306E1)
LOG1P_SMALL = 0.41421356237309504880          # sqrt(2) - 1


def log_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ``log`` on the CPU for positive normal and subnormal
    ``v`` (exponent split, Cephes polynomial in fused multiply-adds, the
    product by ``x^3`` fused with the exponent's low term): the same bits
    as ``jnp.log`` there."""
    dev = v.device
    t = torch.maximum(v, _f32(1.1754943508222875e-38, dev))
    bits = t.view(torch.int32)
    e = (bits >> 23) - 0x7F
    frac = ((bits & 0x007F_FFFF) | 0x3F00_0000).view(torch.float32)
    e = e.to(torch.float32) + 1.0
    small = frac < _f32(SQRTHF, dev)
    x = (frac - 1.0) + torch.where(small, frac, _f32(0.0, dev))
    e = e - torch.where(small, _f32(1.0, dev), _f32(0.0, dev))
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c, dev) for c in LOG_P]
    y, y1, y2 = fma(x, p[0], p[1]), fma(x, p[3], p[4]), fma(x, p[6], p[7])
    y, y1, y2 = fma(y, x, p[2]), fma(y1, x, p[5]), fma(y2, x, p[8])
    y = fma(y, x3, y1)
    y = fma(fma(y, x3, y2), x3, _f32(LOG_Q1, dev) * e)
    x = x - _f32(0.5, dev) * x2
    x = x + y
    return x + _f32(LOG_Q2, dev) * e


def log1p_xla(w: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ``log1p``: a rational approximation for |w| < sqrt(2) - 1,
    ``log(1 + w)`` above it; defined here for w > -1."""
    dev = w.device

    def poly(coefs):
        p = _f32(coefs[0], dev).expand_as(w)
        for c in coefs[1:]:
            p = fma(p, w, _f32(c, dev))
        return p
    ws = w * w
    small = poly(LOG1P_NUM) / poly(LOG1P_DEN)
    small = (w * ws) * small
    small = w + fma(_f32(-0.5, dev), ws, small)
    large = log_xla(w + 1.0)
    return torch.where(w.abs() < _f32(LOG1P_SMALL, dev), small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ``ErfInv`` on (-1, 1): Giles' approximation, two
    polynomial branches in ``w = -log1p(-x * x)``, evaluated in fused
    multiply-adds as XLA's CPU code evaluates them."""
    dev = x.device
    w = -log1p_xla(x * -x)
    lt = w < _f32(5.0, dev)
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(ERFINV_LT5[i], dev),
                           _f32(ERFINV_GE5[i], dev))
    p = coef(0)
    for i in range(1, len(ERFINV_LT5)):
        p = fma(p, w, coef(i))
    return p * x


def draw_ref(keys: torch.Tensor, n: int, mode: str = "uniform",
             a: float = 0.0, b: float = 1.0,
             device: torch.device | str = "cpu") -> torch.Tensor:
    """``(K, n)`` fp32: ``n`` values of ``mode`` under each of the ``(K, 2)``
    keys (uint32 bit patterns, any integer dtype, on the host)."""
    if mode not in MODES:
        raise ValueError(f"unknown draw mode {mode!r}; one of {tuple(MODES)}")
    u = _unit(bits_ref(keys, n, device))
    if mode == "uniform":
        return scale(u, a, b)
    if mode == "bernoulli":
        return (u < _f32(a, u.device)).to(torch.float32)
    return _f32(SQRT2, u.device) * erf_inv(scale(u, NORMAL_LO, 1.0))
