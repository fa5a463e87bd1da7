"""Public wrapper for the fused dequant + compensated-mean kernel
(``csrc/dequant_mean.cu``).

Counterpart of ``src/repro/kernels/dequant_reduce/ops.py``, with a leading
receiver axis: ``(R, N, S)`` codes, ``(R, S/block)`` per-block grids (each
receiver's slice of the bucket's grids) and an optional ``(R, N, S)`` mask
-> ``(R, S)``, one launch for every receiver of a bucket. The kernel reads
the per-block grids directly; only the plain version expands them to
per-column rows, as the reference's wrapper does. A CUDA tensor launches
the kernel (or raises); a CPU tensor takes ``dequant_masked_mean_ref`` (see
``kernels/runtime``). ``launches`` counts kernel launches and is bumped
nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, runtime

from .ref import dequant_masked_mean_ref

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library("dequant_mean").dequant_mean_u8
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_grids(codes: torch.Tensor, lo: torch.Tensor, step: torch.Tensor,
                 block: int) -> int:
    s = codes.shape[-1]
    if block <= 0 or s % block:
        raise ValueError(f"shard length {s} not a multiple of block {block}")
    want = (*codes.shape[:-2], s // block)
    if tuple(lo.shape) != want or tuple(step.shape) != want:
        raise ValueError(f"lo and step must be {want} per-block grids, got "
                         f"{tuple(lo.shape)} and {tuple(step.shape)}")
    return s // block


def dequant_mean_launch(codes: torch.Tensor, lo: torch.Tensor,
                        step: torch.Tensor, mask: torch.Tensor | None, *,
                        block: int) -> torch.Tensor:
    """Launch the kernel: CUDA uint8 ``(R, N, S)`` codes (receiver and peer
    strides of a multiple of 4, contiguous columns), fp32 ``(R, S/block)``
    grids and an optional fp32 ``(R, N, S)`` mask -> contiguous ``(R, S)``
    fp32. Each thread takes 4 columns: S and block must be multiples of 4,
    as the sync engine's Hadamard blocks (16..4096) are."""
    global launches
    if codes.dim() != 3 or codes.dtype != torch.uint8:
        raise ValueError("codes must be (R, N, S) uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    nblk = _check_grids(codes, lo, step, block)
    r, n, s = codes.shape
    if r > 65535:
        raise ValueError(f"at most 65535 receivers per launch, got {r}")
    if any(t.dtype != torch.float32 or t.device != codes.device
           for t in (lo, step)):
        raise ValueError("lo and step must be float32 on the codes' device")
    if mask is not None:
        if mask.shape != codes.shape or mask.dtype != torch.float32 or \
                mask.device != codes.device:
            raise ValueError("mask must be float32 of the codes' shape and "
                             "device")
        mask = mask.contiguous()
    if codes.stride(2) != 1:
        codes = codes.contiguous()
    lo, step = lo.contiguous(), step.contiguous()
    sr, sn = codes.stride(0), codes.stride(1)
    if (block % 4 or sr % 4 or sn % 4 or codes.data_ptr() % 4
            or (mask is not None and mask.data_ptr() % 16)):
        raise ValueError(
            "dequant_mean kernel takes a block and code strides of a multiple "
            f"of 4 and aligned codes and mask, got block {block}, strides "
            f"{(sr, sn)}")
    out = torch.empty((r, s), dtype=torch.float32, device=codes.device)
    err = _kernel()(codes.data_ptr(), lo.data_ptr(), step.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), r, n, s, sr, sn, nblk, block,
                    torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(err, "dequant_mean_u8")
    launches += 1
    return out


def dequant_masked_mean(codes: torch.Tensor, lo: torch.Tensor,
                        step: torch.Tensor,
                        mask: torch.Tensor | None = None, *,
                        block: int) -> torch.Tensor:
    """Drop-compensated mean over N peers' dequantized codes (the plain mean
    without a mask). codes ``(..., N, S)``, S = nblk * block; lo/step
    ``(..., nblk)`` per-block grids; mask ``(..., N, S)`` or None.
    Returns ``(..., S)`` fp32. The kernel takes the sync engine's
    ``(R, N, S)``; the plain version any leading axes."""
    if runtime.use_kernel(codes, "dequant_masked_mean"):
        return dequant_mean_launch(codes, lo, step, mask, block=block)
    _check_grids(codes, lo, step, block)
    return dequant_masked_mean_ref(
        codes, lo.repeat_interleave(block, dim=-1),
        step.repeat_interleave(block, dim=-1), mask)
