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
``labels >= 0``, logits in fp32.

FSDP (``param_table(cfg, fsdp_axes=...)``): a leaf's ``fsdp_dim`` is the dim
the reference shards over the fsdp axes: ``embed`` on dim 1, the attention
and MLP weights on their input dim (``wo`` and ``w_down`` on their output
dim), the norms replicated. The forward pass gathers each sharded weight
through ``pctx.gather`` at the reference's call sites and keys: ``embed``
with ``key`` for the lookup and again for the tied head, layer l's weights
with ``fold_in(key, l)``. MoE, SSM, hybrid and frontend families, tensor
parallelism (ROADMAP A15b) and serving wait for later slices (ROADMAP A21).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.keys import Key, fold_in

from .layers import attention_train, gated_mlp, rms_norm
from .parallel import ParallelCtx


class Leaf(NamedTuple):
    shape: tuple
    init: str                      # 'normal' | 'ones'
    fsdp_dim: int | None = None    # dim sharded over the fsdp axes


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.attn_every
            or cfg.frontend):
        raise NotImplementedError(
            f"model family {cfg.family!r} of {cfg.name!r} is not ported yet: "
            "ROADMAP A21 (the port's transformer is the dense family)")


def param_table(cfg: ModelConfig, *,
                fsdp_axes: tuple[str, ...] | None = None) -> dict[str, Any]:
    """The leaf table of the dense family at tp = 1. Shapes are global (the
    stored shapes on one card); with ``fsdp_axes`` each sharded leaf
    carries its ``fsdp_dim`` (stack dim counted)."""
    _check_dense(cfg)
    d, dh, f, L = cfg.d_model, cfg.dh, cfg.d_ff, cfg.n_layers

    def w(shape, fsdp_dim=None, init="normal"):
        return Leaf(tuple(shape), init,
                    fsdp_dim if fsdp_axes is not None else None)

    stage = {
        "ln1": w((L, d), init="ones"),
        "wq": w((L, d, cfg.n_heads * dh), fsdp_dim=1),
        "wk": w((L, d, cfg.n_kv_heads * dh), fsdp_dim=1),
        "wv": w((L, d, cfg.n_kv_heads * dh), fsdp_dim=1),
        "wo": w((L, cfg.n_heads * dh, d), fsdp_dim=2),
        "ln2": w((L, d), init="ones"),
        "w_gate": w((L, d, f), fsdp_dim=1),
        "w_up": w((L, d, f), fsdp_dim=1),
        "w_down": w((L, f, d), fsdp_dim=2),
    }
    table: dict[str, Any] = {
        "embed": w((cfg.vocab_size, d), fsdp_dim=1),
        "final_ln": w((d,), init="ones"),
        "stages": [stage],
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = w((d, cfg.vocab_size), fsdp_dim=0)
    return table


def param_specs(cfg: ModelConfig, *,
                fsdp_axes: tuple[str, ...] | None = None):
    """Each leaf's partition spec, as the reference's ``PartitionSpec``: a
    tuple with one entry per dim, None or the axis name (a tuple of names
    for several axes, pod-major) the dim is sharded over."""
    def spec(leaf: Leaf):
        out = [None] * len(leaf.shape)
        if leaf.fsdp_dim is not None:
            out[leaf.fsdp_dim] = (fsdp_axes if len(fsdp_axes) > 1
                                  else fsdp_axes[0])
        return tuple(out)
    return _map_table(spec, param_table(cfg, fsdp_axes=fsdp_axes))


def _layer_fsdp_dims(cfg: ModelConfig) -> dict[str, int | None]:
    """A layer slice's sharded dims (the stack dim removed)."""
    stage = param_table(cfg, fsdp_axes=("data",))["stages"][0]
    return {k: (v.fsdp_dim - 1 if v.fsdp_dim is not None else None)
            for k, v in stage.items()}


def _maybe_gather(pctx: ParallelCtx | None, w: torch.Tensor,
                  dim: int | None, key: Key | None,
                  name: str) -> torch.Tensor:
    if dim is None or pctx is None or not pctx.fsdp or pctx.gather is None:
        return w
    return pctx.gather(w, dim, key, name)


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


def forward_hidden(params, batch, cfg: ModelConfig, *, remat: bool = True,
                   pctx: ParallelCtx | None = None,
                   key: Key | None = None) -> torch.Tensor:
    """Tokens -> final hidden states (B, S, D). ``remat`` recomputes each
    layer in the backward pass (the reference's ``jax.checkpoint``). Under
    FSDP (``pctx.fsdp``) each sharded weight is gathered before the layer
    runs, outside the recomputed region, so a recompute gathers nothing."""
    _check_dense(cfg)
    tokens = batch["tokens"].long()
    emb = _maybe_gather(pctx, params["embed"], 1, key, "embed")
    x = emb[tokens].to(cfg.param_dtype)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    stage = params["stages"][0]
    names = tuple(sorted(stage))
    fsdp_dim = _layer_fsdp_dims(cfg)
    # unbind: one view per layer, whose backward stacks the layer grads
    per_layer = zip(*(stage[k].unbind(0) for k in names))
    for layer, weights in enumerate(per_layer):
        if pctx is not None and pctx.fsdp:
            lkey = fold_in(key, layer)
            weights = [_maybe_gather(pctx, w, fsdp_dim[k], lkey, k)
                       for k, w in zip(names, weights)]
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
            remat: bool = True, pctx: ParallelCtx | None = None,
            key: Key | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over the sequence (full
    logits are never alive at once when ``remat`` recomputes each chunk).
    ``pctx`` and ``key`` as in :func:`forward_hidden`."""
    x = forward_hidden(params, batch, cfg, remat=remat, pctx=pctx, key=key)
    labels = batch["labels"]
    head = params.get("lm_head")
    if head is None:                                   # tied: (D, V)
        head = _maybe_gather(pctx, params["embed"], 1, key, "head").T
    else:
        head = _maybe_gather(pctx, head, 0, key, "lm_head")
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
