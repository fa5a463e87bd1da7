"""Optimizers: SGD, momentum SGD and AdamW, written out as the reference
writes them.

Counterpart of ``src/repro/optim/optimizers.py``. AdamW here is
``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` on every leaf, in fp32,
with moments kept in ``state_dtype`` — not ``torch.optim.AdamW``, whose
decay and epsilon placement differ. Momentum SGD is ``m = momentum * m + g``
then ``p -= lr * m`` in fp32 (the time-to-accuracy harness's optimizer).
States are trees mirroring the parameters. ``update`` writes the new
parameters and moments into the given tensors in place (no second copy of
either) and returns them. The reference's ``scan_update`` only bounds XLA's
fp32 transients by mapping the update over stacked layers; eager PyTorch
updates one leaf at a time already, so it has no counterpart here. Adafactor
waits for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9
    state_dtype: torch.dtype = torch.float32
    grad_clip: float = 1.0


class Optimizer(NamedTuple):
    init: Callable
    update: Callable     # (grads, state, params, lr, step) -> (params, state)
    state_like_params: bool


class AdamState(NamedTuple):
    m: Any
    v: Any


def sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros((), device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        del step
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.copy_(p.to(torch.float32) - lr * g.to(torch.float32))
        return params, state

    return Optimizer(init, update, state_like_params=False)


def momentum_sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                              device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        del step
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state)):
            mf = cfg.momentum * m.to(torch.float32) + g.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * mf)
            m.copy_(mf)
        return params, state

    return Optimizer(init, update, state_like_params=True)


def adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=cfg.state_dtype,
                               device=p.device)
        return AdamState(m=tree_map(z, params), v=tree_map(z, params))

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        # bias corrections in fp32, as the reference computes beta ** t
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        bc1 = 1.0 - torch.tensor(cfg.beta1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(cfg.beta2, dtype=torch.float32) ** t
        lr = torch.as_tensor(lr, dtype=torch.float32)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            dev = p.device
            gf = g.to(torch.float32)
            mf = cfg.beta1 * m.to(torch.float32) + (1 - cfg.beta1) * gf
            vf = cfg.beta2 * v.to(torch.float32) + (1 - cfg.beta2) * gf * gf
            mhat = mf / bc1.to(dev)
            vhat = vf / bc2.to(dev)
            pf = p.to(torch.float32)
            pf = pf - lr.to(dev) * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                    + cfg.weight_decay * pf)
            p.copy_(pf)
            m.copy_(mf)
            v.copy_(vf)
        return params, state

    return Optimizer(init, update, state_like_params=True)


_REGISTRY = {"sgd": sgd, "momentum": momentum_sgd, "adamw": adamw}


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adafactor":
        raise NotImplementedError(f"optimizer {cfg.name!r} is not ported "
                                  "yet: ROADMAP A10")
    if cfg.name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return _REGISTRY[cfg.name](cfg)
