"""Optimizers: SGD, momentum SGD, AdamW and the factored Adafactor-lite,
written out as the reference writes them.

Counterpart of ``src/repro/optim/optimizers.py``. AdamW here is
``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` on every leaf, in fp32,
with moments kept in ``state_dtype`` — not ``torch.optim.AdamW``, whose
decay and epsilon placement differ. Momentum SGD is ``m = momentum * m + g``
then ``p -= lr * m`` in fp32 (the time-to-accuracy harness's optimizer).
States are trees mirroring the parameters. ``update`` writes the new
parameters and moments into the given tensors in place (no second copy of
either) and returns them. The reference's ``scan_update`` only bounds XLA's
fp32 transients by mapping the update over stacked layers; eager PyTorch
updates one leaf at a time already, so it has no counterpart here.
Adafactor's state is two trees of factored second-moment statistics (a row
vector and a column vector a leaf of two or more dims, the full ``v`` and a
placeholder otherwise), not shaped like the parameters
(``state_like_params=False``): the reference replicates it under FSDP, and
so does the port, which holds every state whole on the card.
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


class AdafactorState(NamedTuple):
    row: Any     # per-leaf row statistics (the full v for a leaf under 2-D)
    col: Any     # per-leaf column statistics (a 0-d placeholder under 2-D)


def adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Factored second moment over the trailing two dims (Shazeer-Stern,
    simplified as the reference simplifies it: no first moment, no update
    clipping, no relative step): ``r = b2 r + (1 - b2) mean_col(g^2)``,
    ``c = b2 c + (1 - b2) mean_row(g^2)``, ``v_hat = r c / max(mean(r),
    1e-30)``, ``p -= lr (g / (sqrt(v_hat) + eps) + wd p)``, in fp32, with
    ``g^2`` taken as ``g * g + 1e-30``. Updates in place, as AdamW does."""
    def init(params):
        def rows(p):
            shape = p.shape[:-1] if p.dim() >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def cols(p):
            shape = (p.shape[:-2] + p.shape[-1:]) if p.dim() >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        return AdafactorState(row=tree_map(rows, params),
                              col=tree_map(cols, params))

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        del step
        b2 = cfg.beta2
        lr = torch.as_tensor(lr, dtype=torch.float32)
        for p, g, r, c in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.row), tree_leaves(state.col)):
            gf = g.to(torch.float32)
            g2 = gf * gf + 1e-30
            if p.dim() >= 2:
                rn = b2 * r + (1 - b2) * g2.mean(dim=-1)
                cn = b2 * c + (1 - b2) * g2.mean(dim=-2)
                rmean = rn.mean(dim=-1, keepdim=True)
                vhat = (rn[..., None] * cn[..., None, :]
                        / torch.clamp(rmean[..., None], min=1e-30))
                c.copy_(cn)
            else:
                rn = b2 * r + (1 - b2) * g2
                vhat = rn
            pf = p.to(torch.float32)
            pf = pf - lr.to(p.device) * (gf / (torch.sqrt(vhat) + cfg.eps)
                                         + cfg.weight_decay * pf)
            p.copy_(pf)
            r.copy_(rn)
        return params, state

    return Optimizer(init, update, state_like_params=False)


_REGISTRY = {"sgd": sgd, "momentum": momentum_sgd, "adamw": adamw,
             "adafactor": adafactor}


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return _REGISTRY[cfg.name](cfg)
