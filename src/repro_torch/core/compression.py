"""Lossy/compression baselines the paper compares against (Fig 16).

Counterpart of ``src/repro/core/compression.py``:

  * Top-K sparsification (Stich et al.) with error-feedback memory.
  * TernGrad (Wen et al.): stochastic ternarization onto {-s, 0, +s}.
  * THC (Li et al.): Hadamard rotation + uniform stochastic quantization on
    one shared range; codes are *homomorphic* — summed across workers and
    dequantized once. The rotation is kernel B1 and the quantizer kernel B7
    on the card.

As in ``core/hadamard``, the random operands come from the caller: TernGrad
takes its uniform draw ``u`` (``bernoulli(p)`` is ``u < p``, as
``jax.random.bernoulli`` draws it), THC its sign and noise. Every function
takes a leading worker axis: ``(W, L)`` is one Top-K, one TernGrad and, for
THC, one B1 encode and one B7 launch for all W workers, which share one sign
and one ``(L / block, block)`` noise copy, as the reference's harness hands
every worker the same key.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.fwht import randomized_fwht
from repro_torch.kernels.quant import uniform_dequant, uniform_quant


# --------------------------------------------------------------------- Top-K
class TopKState(NamedTuple):
    error: torch.Tensor  # (W, L) error-feedback memory, one row a worker


def topk_init(workers: int, length: int,
              device: torch.device | str = "cpu") -> TopKState:
    """Zero error memory for ``workers`` buckets of ``length``."""
    return TopKState(error=torch.zeros((workers, length), dtype=torch.float32,
                                       device=device))


def topk_compress(x: torch.Tensor, state: TopKState, *,
                  k: int) -> tuple[torch.Tensor, TopKState]:
    """Keep the k largest-|.| entries of (x + error) along the last axis;
    the rest feed back."""
    corrected = x + state.error
    idx = torch.topk(corrected.abs(), k, dim=-1).indices
    sparse = torch.zeros_like(corrected).scatter_(
        -1, idx, corrected.gather(-1, idx))
    return sparse, TopKState(error=corrected - sparse)


# ------------------------------------------------------------------ TernGrad
def terngrad_compress(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic ternarization of the last axis: E[out] == x
    (scale s = max|x|); ``u`` is uniform [0, 1) of x's shape."""
    s = x.abs().amax(dim=-1, keepdim=True)
    p = torch.where(s > 0, x.abs() / s, torch.zeros_like(x))
    return s * torch.sign(x) * (u < p).to(x.dtype)


# ----------------------------------------------------------------------- THC
class THCCompressed(NamedTuple):
    codes: torch.Tensor  # uint8 (..., L / block, block)
    lohi: torch.Tensor   # shared (2,) quantization range


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[-1]
    if n % block:
        raise ValueError(f"bucket length {n} not a multiple of block {block}")
    return x.reshape(*x.shape[:-1], n // block, block)


def thc_compress(x: torch.Tensor, sign: torch.Tensor, noise: torch.Tensor,
                 lohi: torch.Tensor, *, bits: int = 4,
                 block: int = 4096) -> THCCompressed:
    """Rotate (randomized HT) then quantize onto the shared [lo, hi] grid.

    x: ``(..., L)`` flat, L % block == 0; sign ``(block,)``; noise
    ``(L / block, block)`` uniform [0, 1), one copy for every leading index;
    ``lohi`` agreed across workers (THC pre-negotiates the range)."""
    rot = randomized_fwht(_blocks(x, block), sign, mode="encode")
    return THCCompressed(codes=uniform_quant(rot, noise, lohi, bits=bits),
                         lohi=lohi)


def thc_decompress_sum(code_sum: torch.Tensor, sign: torch.Tensor,
                       lohi: torch.Tensor, *, bits: int = 4,
                       block: int = 4096, nsum: int = 1) -> torch.Tensor:
    """Dequantize a *sum* of nsum workers' codes ``(L / block, block)``,
    divide by nsum (a true division on the codes' device), un-rotate;
    returns the flat ``(L,)`` mean."""
    rot_sum = uniform_dequant(code_sum, lohi, bits=bits, nsum=nsum)
    mean_rot = rot_sum / torch.full_like(lohi[0], nsum)
    out = randomized_fwht(_blocks(mean_rot, block), sign, mode="decode")
    return out.reshape(-1)
