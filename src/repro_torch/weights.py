"""Carry the JAX package's parameters (and optimizer state) into the port.

``params_from_jax`` takes trees of numpy arrays (``jax.tree.map(np.asarray,
tree)`` on the reference's side: dicts, lists and ``AdamState``-like named
tuples) and returns the same trees of torch tensors, so both packages start
from identical values and compute the same thing. The optimizer state is
AdamW's ``AdamState(m, v)`` or momentum SGD's tree of ``m``. bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) are carried bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizers import AdamState
from repro_torch.tree import tree_map


def tensor_from_numpy(a, device: torch.device | str = "cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(params: Any, opt_state: Any = None, *,
                    device: torch.device | str = "cpu"):
    """Reference parameter tree (numpy leaves) -> the port's tree of
    tensors; with ``opt_state`` (as numpy: the reference's ``AdamState(m,
    v)`` or a pair ``(m, v)``, or momentum SGD's tree of ``m`` mirroring
    the parameters), also returns the port's :class:`AdamState` or tree of
    ``m``."""
    def carry(tree):
        return tree_map(lambda a: tensor_from_numpy(a, device), tree)

    p = carry(params)
    if opt_state is None:
        return p
    if isinstance(opt_state, tuple):              # AdamState or (m, v)
        m, v = opt_state
        return p, AdamState(m=carry(m), v=carry(v))
    return p, carry(opt_state)
