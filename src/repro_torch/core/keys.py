"""Threefry keys and draws: the port's ``jax.random``, bit for bit.

A key is the raw ``(k0, k1)`` pair of uint32 words of a
``jax.random.PRNGKey`` (default threefry implementation, partitionable
mode, the reference's jax 0.9.0 default):

  ``key(seed)``      ``(0, lo32(seed))`` (jax without x64);
  ``fold_in(k, d)``  ``threefry2x32(k, (0, d))``;
  ``split(k, n)``    key ``i`` is the pair ``threefry2x32(k, (0, i))``;
  draws              value ``i`` (row-major flat index) takes the 32 bits
                     ``x0 ^ x1`` of ``threefry2x32(k, (hi32(i), lo32(i)))``.

So the reference's derivations carry over name for name: the step key
``fold_in(key, step)``, the sync key ``fold_in(step_key, 7)``, a bucket's
key ``fold_in(sync_key, b)``, a receiver's mask key ``fold_in(bucket_key,
r)``. Key derivation runs on the host in Python integers, one fold at a
time, and never waits on the card. The draws run on
the device the caller names: the threefry kernel on a CUDA device, its
plain version on the CPU (``kernels/threefry``), the same bits either way.
"""
from __future__ import annotations

import math
import numpy as np
import torch

from repro_torch.kernels import threefry as tf_kernel

Key = tuple[int, int]

MASK = 0xFFFF_FFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _hash(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """threefry2x32 on Python integers (one counter pair)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _hash_np(k0, k1, x0, x1):
    """threefry2x32 on numpy ``uint32`` arrays (broadcast; wraps)."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with x64 off: ``(0, seed mod 2^32)``
    for any seed in ``[-2^63, 2^63)`` (jax keeps the seed's low word
    only), ``OverflowError`` outside it, as jax raises."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64")
    return (0, seed & MASK)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return _hash(int(k[0]), int(k[1]), 0, int(data) & MASK)


def split(k: Key, num: int = 2) -> tuple[Key, ...]:
    """``jax.random.split(k, num)``: key ``i`` is ``fold_in(k, i)``."""
    return tuple(fold_in(k, i) for i in range(num))


def fold_in_many(keys, data) -> np.ndarray:
    """``fold_in`` over a batch: ``(K, 2)`` keys (or one key) folded with
    ``(K,)`` data (or one value) -> ``(K, 2)`` uint32."""
    k = tf_kernel.key_array(keys)
    d = np.asarray(data, dtype=np.int64).reshape(-1) & MASK
    if len(k) == 1 and len(d) > 1:
        k = np.repeat(k, len(d), axis=0)
    elif len(d) == 1 and len(k) > 1:
        d = np.repeat(d, len(k))
    return np.array([fold_in(kk, c) for kk, c in zip(k.tolist(),
                                                     d.tolist())],
                    dtype=np.uint32).reshape(-1, 2)


def _shape(shape) -> tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(int(s)
                                                        for s in shape)


def _draw(keys, n: int, mode: str, a: float, b: float,
          device) -> torch.Tensor:
    """One kernel draw a ``MAX_KEYS`` keys (one for any batch the sync
    engine draws at once), rows concatenated."""
    k = tf_kernel.key_array(keys)
    step = tf_kernel.MAX_KEYS
    parts = [tf_kernel.draw(k[i:i + step], n, mode, a, b, device)
             for i in range(0, k.shape[0], step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def uniform_batch(keys, n: int, device: torch.device | str = "cpu", *,
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``(K, n)`` fp32: ``uniform(keys[j], (n,), minval, maxval)`` a row, in
    one draw."""
    return _draw(keys, n, "uniform", minval, maxval, device)


def bernoulli_batch(keys, p: float, n: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """``(K, n)`` bool: ``bernoulli(keys[j], p, (n,))`` a row."""
    return _draw(keys, n, "bernoulli", p, 1.0, device) > 0.5


def uniform(k: Key, shape, device: torch.device | str = "cpu", *,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    shape = _shape(shape)
    return uniform_batch([k], math.prod(shape), device, minval=minval,
                         maxval=maxval).view(shape)


def bernoulli(k: Key, p: float, shape,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` (``p`` rounded to fp32)."""
    shape = _shape(shape)
    return bernoulli_batch([k], p, math.prod(shape), device).view(shape)


def normal(k: Key, shape, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``."""
    shape = _shape(shape)
    return tf_kernel.draw([k], math.prod(shape), "normal",
                          device=device).view(shape)


def bits(k: Key, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` on the host, uint32."""
    shape = _shape(shape)
    i = np.arange(math.prod(shape), dtype=np.uint64)
    x0, x1 = _hash_np(k[0], k[1], (i >> np.uint64(32)).astype(np.uint32),
                      (i & np.uint64(MASK)).astype(np.uint32))
    return (x0 ^ x1).reshape(shape)


def randint(k: Key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) on the host:
    two bit draws from ``split(k)``, the span, the multiplier
    ``(2^16 mod span)^2 mod span`` and the offset wrapping in uint32, as
    jax's ``_randint`` computes them. Bounds past int32 raise
    ``OverflowError``, as jax's do with x64 off."""
    shape = _shape(shape)
    lo, hi = int(minval), int(maxval)
    for bound in (lo, hi):
        if not -(1 << 31) <= bound < (1 << 31):
            raise OverflowError(f"randint bound {bound} does not fit in "
                                "int32")
    k1, k2 = split(k)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = np.uint32(1 if hi <= lo else (hi - lo) & MASK)
    with np.errstate(over="ignore"):
        mult = np.uint32(1 << 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + (lower % span)) % span
    return (lo + off.astype(np.int64)).astype(np.int32)


def batch_keys(keys) -> np.ndarray:
    """Keys (a list of pairs or an array) as the ``(K, 2)`` uint32 batch the
    draws take."""
    return tf_kernel.key_array(keys)
