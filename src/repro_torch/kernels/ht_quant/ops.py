"""Public wrappers for the fused HT-encode + quantize kernels
(``csrc/ht_quant.cu``).

Counterpart of ``src/repro/kernels/ht_quant/ops.py``. ``ht_amax`` and
``ht_quant`` take ``(..., n)`` rows, one Hadamard block each; a ``(P, R,
n)`` peer stack is one launch, read through its peer stride like the FWHT
kernel's input. A CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version in ``ref.py`` (see ``kernels/runtime``).
``amax_launches`` and ``quant_launches`` count kernel launches and are
bumped nowhere else. ``ht_encode_fused`` is the unquantized encode stage
(sign + FWHT in one pass, kernel B1), as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, runtime
from repro_torch.kernels.fwht import randomized_fwht
from repro_torch.kernels.fwht.ops import MAX_N, MIN_N, _rows_view

from .ref import ht_amax_ref, ht_quant_ref

amax_launches = 0
quant_launches = 0

_fns: dict[str, object] = {}
_ARGTYPES = {
    "ht_amax_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_longlong,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p],
    "ht_quant_f32": [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("ht_quant"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_rows(x: torch.Tensor, sign: torch.Tensor, what: str):
    n = x.shape[-1]
    if x.dtype != torch.float32 or sign.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 x and sign")
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"{what} kernel takes a power-of-two block in "
                         f"[{MIN_N}, {MAX_N}], got {n}")
    if sign.shape != (n,) or sign.device != x.device:
        raise ValueError(f"sign must be ({n},) on the input's device")
    sign = sign.contiguous()
    xv, rows, per_peer, stride = _rows_view(x)
    if xv.data_ptr() % 16 or stride % 4 or sign.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs 16-byte aligned rows and sign")
    return sign, xv, rows, per_peer, stride


def ht_amax_launch(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Launch B3 on CUDA fp32 rows ``(..., n)`` -> ``(...)`` fp32."""
    global amax_launches
    sign, xv, rows, per_peer, stride = _check_rows(x, sign, "ht_amax")
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    err = _kernel("ht_amax_f32")(
        xv.data_ptr(), sign.data_ptr(), out.data_ptr(), rows, x.shape[-1],
        per_peer, stride, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ht_amax_f32")
    amax_launches += 1
    return out


def ht_quant_launch(x: torch.Tensor, sign: torch.Tensor, noise: torch.Tensor,
                    lo: torch.Tensor, step: torch.Tensor, *,
                    bits: int) -> torch.Tensor:
    """Launch B4 on CUDA fp32 rows ``(..., n)`` with ``(G, n)`` noise and
    ``(G,)`` grids (row i reads row ``i % G``) -> uint8 of x's shape."""
    global quant_launches
    n = x.shape[-1]
    sign, xv, rows, per_peer, stride = _check_rows(x, sign, "ht_quant")
    g = lo.shape[0]
    if noise.shape != (g, n) or lo.shape != (g,) or step.shape != (g,):
        raise ValueError(f"noise must be (G, {n}) and lo, step (G,), got "
                         f"{tuple(noise.shape)}, {tuple(lo.shape)}, "
                         f"{tuple(step.shape)}")
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in (noise, lo, step)):
        raise ValueError("noise and grids must be float32 on x's device")
    if g <= 0 or per_peer % g or rows % g:
        raise ValueError(f"{g} grid rows must divide the {per_peer} rows a "
                         "peer holds")
    if not 1 <= bits <= 8:
        raise ValueError(f"uint8 codes hold 1..8 bits, got {bits}")
    noise, lo, step = noise.contiguous(), lo.contiguous(), step.contiguous()
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    err = _kernel("ht_quant_f32")(
        xv.data_ptr(), sign.data_ptr(), noise.data_ptr(), lo.data_ptr(),
        step.data_ptr(), out.data_ptr(), rows, n, per_peer, stride, g, bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ht_quant_f32")
    quant_launches += 1
    return out


def ht_amax(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Per-block amax of the rotated blocks, without materializing them.
    ``(..., n)`` -> ``(...)`` fp32."""
    if runtime.use_kernel(x, "ht_amax"):
        return ht_amax_launch(x, sign)
    return ht_amax_ref(x, sign)


def ht_quant(x: torch.Tensor, sign: torch.Tensor, noise: torch.Tensor,
             lo: torch.Tensor, step: torch.Tensor, *,
             bits: int = 8) -> torch.Tensor:
    """Fused sign-flip + FWHT + stochastic uniform quantization onto the
    shared grids: ``(..., n)`` -> uint8 codes of the same shape."""
    if runtime.use_kernel(x, "ht_quant"):
        return ht_quant_launch(x, sign, noise, lo, step, bits=bits)
    return ht_quant_ref(x, sign, noise, lo, step, bits=bits)


def ht_encode_fused(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Unquantized fused encode (sign + FWHT in one pass): the bits=0
    stage."""
    return randomized_fwht(x, sign, mode="encode")
