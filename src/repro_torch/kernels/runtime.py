"""Kernel dispatch: which tensors run the hand-written CUDA kernels.

Counterpart of ``src/repro/kernels/runtime.py``. The reference chose between
the Pallas interpreter and Mosaic; the port chooses by the device the caller
put the tensor on:

  ``auto``    (default) a CUDA tensor launches the kernel, a CPU tensor takes
              the plain PyTorch version. The choice follows the device the
              caller asked for; it is never a fallback after a failure.
  ``kernel``  every call must launch the kernel: a CPU tensor raises.
  ``ref``     every call must take the plain version: a CUDA tensor raises
              (on the card a wrapper launches its kernel or raises; compare
              with the plain version by calling the package's ``ref.py``).

A kernel that fails to build or launch raises; nothing is caught. The
mode is set with :func:`set_kernel_mode` (the launcher's
``--kernel-mode``).
"""
from __future__ import annotations

import contextlib

import torch

MODES = ("auto", "kernel", "ref")

_mode = "auto"


def _check(mode: str) -> str:
    mode = str(mode).strip().lower()
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; expected one of "
                         f"{MODES}")
    return mode


def kernel_mode() -> str:
    return _mode


def set_kernel_mode(mode: str | None) -> None:
    """Set the process-wide mode (``None`` restores ``auto``)."""
    global _mode
    _mode = "auto" if mode is None else _check(mode)


@contextlib.contextmanager
def kernel_mode_scope(mode: str | None):
    prev = _mode
    set_kernel_mode(mode)
    try:
        yield
    finally:
        set_kernel_mode(prev)


def use_kernel(t: torch.Tensor, what: str) -> bool:
    """True when ``t`` must go through the CUDA kernel ``what``; False when
    it takes the plain version; raises where the mode and device disagree."""
    mode = kernel_mode()
    if t.is_cuda:
        if mode == "ref":
            raise RuntimeError(
                f"{what}: kernel mode 'ref' on a CUDA tensor — the wrapper "
                "launches its kernel on the card; call the plain version "
                "from the package's ref.py to compare")
        return True
    if mode == "kernel":
        raise RuntimeError(f"{what}: kernel mode 'kernel' needs a CUDA "
                           f"tensor, got one on {t.device}")
    return False


def resolve_device(device: str | torch.device | None) -> torch.device:
    """An entry point's device: CUDA unless the caller asks for another,
    and CUDA raises when it is absent instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return dev
