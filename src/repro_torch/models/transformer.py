"""Decoder-only transformer, dense family.

Counterpart of the dense family of ``src/repro/models/transformer.py``
(``param_table``, ``init_params``, ``forward_hidden``, ``lm_loss``). The
port keeps the reference's parameter tree, so parameters carry over leaf
for leaf (``weights.params_from_jax``) and the gradient arena has the same
layout::

    {"embed": (V, D), "final_ln": (D,),
     "stages": [{"ln1", "wq", "wk", "wv", "wo", "ln2",
                 "w_gate", "w_up", "w_down"}]}     # leaves stacked (L, ...)

The head is tied (``embed.T``) unless ``tie_embeddings`` is off. The loss is
the mean next-token cross-entropy, chunked over the sequence with weight
``labels >= 0``, logits in fp32. MoE, SSM, hybrid and frontend families,
tensor parallelism, FSDP and serving wait for later slices (ROADMAP A15,
A21).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

from .layers import attention_train, gated_mlp, rms_norm


class Leaf(NamedTuple):
    shape: tuple
    init: str            # 'normal' | 'ones'


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.attn_every
            or cfg.frontend):
        raise NotImplementedError(
            f"model family {cfg.family!r} of {cfg.name!r} is not ported yet: "
            "ROADMAP A21 (the port's transformer is the dense family)")


def param_table(cfg: ModelConfig) -> dict[str, Any]:
    """The leaf table of the dense family at tp = 1, no FSDP."""
    _check_dense(cfg)
    d, dh, f, L = cfg.d_model, cfg.dh, cfg.d_ff, cfg.n_layers
    stage = {
        "ln1": Leaf((L, d), "ones"),
        "wq": Leaf((L, d, cfg.n_heads * dh), "normal"),
        "wk": Leaf((L, d, cfg.n_kv_heads * dh), "normal"),
        "wv": Leaf((L, d, cfg.n_kv_heads * dh), "normal"),
        "wo": Leaf((L, cfg.n_heads * dh, d), "normal"),
        "ln2": Leaf((L, d), "ones"),
        "w_gate": Leaf((L, d, f), "normal"),
        "w_up": Leaf((L, d, f), "normal"),
        "w_down": Leaf((L, f, d), "normal"),
    }
    table: dict[str, Any] = {
        "embed": Leaf((cfg.vocab_size, d), "normal"),
        "final_ln": Leaf((d,), "ones"),
        "stages": [stage],
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = Leaf((d, cfg.vocab_size), "normal")
    return table


def _map_table(fn, table):
    """Apply ``fn`` to every ``Leaf`` of the table, keeping its structure
    (dict keys in sorted order, the tree order)."""
    if isinstance(table, Leaf):
        return fn(table)
    if isinstance(table, dict):
        return {k: _map_table(fn, table[k]) for k in sorted(table)}
    return [_map_table(fn, v) for v in table]


def count_params(cfg: ModelConfig) -> int:
    total = 0

    def add(leaf: Leaf) -> None:
        nonlocal total
        total += math.prod(leaf.shape)
    _map_table(add, param_table(cfg))
    return total


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device: torch.device | str, scale: float = 0.02):
    """Materialize parameters in ``cfg.param_dtype`` on ``device``: normal
    leaves have std min(scale, 1/sqrt(fan_in)), norms are ones. The values
    come from ``gen``, not from the reference's threefry stream; carry the
    reference's parameters over with ``weights.params_from_jax``."""
    def make(leaf: Leaf) -> torch.Tensor:
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=cfg.param_dtype,
                              device=device)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
        std = min(scale, 1.0 / math.sqrt(fan_in))
        w = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return w.to(device=device, dtype=cfg.param_dtype)

    return _map_table(make, param_table(cfg))


def _layer(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
           names: tuple[str, ...], *weights: torch.Tensor) -> torch.Tensor:
    """One pre-norm residual block."""
    lw = dict(zip(names, weights))
    h = rms_norm(x, lw["ln1"])
    x = x + attention_train(
        h, {"wq": lw["wq"], "wk": lw["wk"], "wv": lw["wv"], "wo": lw["wo"],
            "head_dim": cfg.dh, "attn_chunk": cfg.attn_chunk},
        positions=positions, rope_theta=cfg.rope_theta)
    h2 = rms_norm(x, lw["ln2"])
    return x + gated_mlp(h2, lw, activation=cfg.activation)


def forward_hidden(params, batch, cfg: ModelConfig, *,
                   remat: bool = True) -> torch.Tensor:
    """Tokens -> final hidden states (B, S, D). ``remat`` recomputes each
    layer in the backward pass (the reference's ``jax.checkpoint``)."""
    _check_dense(cfg)
    tokens = batch["tokens"].long()
    x = params["embed"][tokens].to(cfg.param_dtype)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    stage = params["stages"][0]
    names = tuple(sorted(stage))
    # unbind: one view per layer, whose backward stacks the layer grads
    per_layer = zip(*(stage[k].unbind(0) for k in names))
    for weights in per_layer:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, positions, cfg, names, *weights,
                           use_reentrant=False)
        else:
            x = _layer(x, positions, cfg, names, *weights)
    return rms_norm(x, params["final_ln"])


def _chunk_loss(x_chunk: torch.Tensor, y_chunk: torch.Tensor,
                head: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    logits = x_chunk.to(torch.float32) @ head.to(torch.float32)
    m = logits.detach().amax(dim=-1)
    z = torch.exp(logits - m[..., None]).sum(dim=-1)
    v = head.shape[1]
    valid = (y_chunk >= 0) & (y_chunk < v)
    safe = y_chunk.clamp(0, v - 1).long()
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    correct = torch.where(valid, picked, torch.zeros_like(picked))
    weight = (y_chunk >= 0).to(torch.float32)
    nll = (torch.log(z) + m - correct) * weight
    return nll.sum(), weight.sum()


def lm_loss(params, batch, cfg: ModelConfig, *, seq_chunk: int = 1024,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over the sequence (full
    logits are never alive at once when ``remat`` recomputes each chunk)."""
    x = forward_hidden(params, batch, cfg, remat=remat)
    labels = batch["labels"]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T                       # tied: (D, V)
    s = x.shape[1]
    chunk = math.gcd(min(seq_chunk, s), s)
    total = torch.zeros((), device=x.device)
    count = torch.zeros((), device=x.device)
    for i in range(s // chunk):
        xc = x[:, i * chunk:(i + 1) * chunk]
        yc = labels[:, i * chunk:(i + 1) * chunk]
        if remat and torch.is_grad_enabled():
            l, w = checkpoint(_chunk_loss, xc, yc, head, use_reentrant=False)
        else:
            l, w = _chunk_loss(xc, yc, head)
        total = total + l
        count = count + w
    return total / torch.clamp(count, min=1.0)
