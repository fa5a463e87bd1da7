"""Decoder-only transformer, dense family.

Counterpart of the dense family of ``src/repro/models/transformer.py``
(``TpLayout``, ``param_table``, ``init_params``, ``forward_hidden``,
``lm_loss``). The port keeps the reference's parameter tree, so parameters
carry over leaf for leaf (``weights.params_from_jax``) and the gradient
arena has the same layout::

    {"embed": (V, D), "final_ln": (D,),
     "stages": [{"ln1", "wq", "wk", "wv", "wo", "ln2",
                 "w_gate", "w_up", "w_down"}]}     # leaves stacked (L, ...)

The head is tied (``embed.T``) unless ``tie_embeddings`` is off. The loss is
the mean next-token cross-entropy, chunked over the sequence with weight
``labels >= 0``, logits in fp32.

Tensor parallelism (``param_table(cfg, tp=T)``, ``pctx.tp_axis``): the
shapes are the reference's global, padded ones (``TpLayout``: heads, KV
heads and vocab padded to multiples of T; the KV projections replicated
when there are fewer KV heads than ranks), and a leaf's ``tp_dim`` is the
dim the reference shards over ``model``: ``wq``, ``w_gate``, ``w_up`` (and
``wk``, ``wv`` unless replicated) column-parallel on their output dim,
``wo`` and ``w_down`` row-parallel on their input dim, ``embed`` on the
vocab. The weights stay stored once, global: tp rank t's shard is the t-th
of T contiguous chunks of the tp dim, a view (``P(..., "model")``'s cut).
A column-parallel product runs as one GEMM over the global weight (no
shard's output depends on another's); a row-parallel product is T partial
products, each rounded to the activation dtype, summed by ``psum_tp`` in
rank order, as the reference's ranks compute and psum them. The embedding
looks up each rank's vocab range, masks it and sums over tp; the loss is the
vocab-parallel softmax (``pmax_tp`` of the detached max, ``psum_tp`` of the
exp-sum and of the picked logit). Under ``pctx.sp`` the residual stream is
a ``(T, B, S/T, D)`` stack of sequence slices between the sublayers
(``models/parallel.py``). At T = 1 every product is the plain one.

FSDP (``param_table(cfg, fsdp_axes=...)``): a leaf's ``fsdp_dim`` is the dim
the reference shards over the fsdp axes: ``embed`` on dim 1, the attention
and MLP weights on their input dim (``wo`` and ``w_down`` on their output
dim), the norms replicated. The forward pass gathers each sharded weight
through ``pctx.gather`` at the reference's call sites and keys: ``embed``
with ``key`` for the lookup and again for the tied head, layer l's weights
with ``fold_in(key, l)``; under tensor parallelism a leaf is sharded on
both dims and the gather hands over the global weight, the trainer cutting
its gradient per tp shard. MoE, SSM, hybrid and frontend families and
serving wait for later slices (ROADMAP A21).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.keys import Key, fold_in

from .layers import attention_train, gated_mlp, rms_norm
from .parallel import SINGLE, ParallelCtx


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


@dataclasses.dataclass(frozen=True)
class TpLayout:
    """Padded dimensions for a tensor-parallel degree: the reference's
    ``TpLayout`` arithmetic (shard indices are Python ints here)."""
    tp: int
    heads_pad: int
    kv_pad: int          # padded KV heads (== n_kv when replicated)
    kv_replicated: bool  # n_kv < tp: KV projection weights replicated
    kv_single: bool      # ...and each shard's q heads share ONE kv head
    vocab_pad: int
    experts_pad: int
    ssm_heads_pad: int

    @staticmethod
    def build(cfg: ModelConfig, tp: int) -> "TpLayout":
        heads_pad = _ceil_to(cfg.n_heads, tp) if cfg.n_heads else 0
        kv_single = False
        if cfg.n_kv_heads and cfg.n_kv_heads >= tp:
            kv_pad, kv_repl = _ceil_to(cfg.n_kv_heads, tp), False
        else:
            kv_pad, kv_repl = cfg.n_kv_heads, True
            if kv_pad and tp > 1:
                hq_l = heads_pad // tp
                kv_single = all(
                    len({(q * kv_pad) // heads_pad
                         for q in range(s * hq_l, (s + 1) * hq_l)}) == 1
                    for s in range(tp))
        return TpLayout(
            tp=tp, heads_pad=heads_pad, kv_pad=kv_pad, kv_replicated=kv_repl,
            kv_single=kv_single, vocab_pad=_ceil_to(cfg.vocab_size, tp),
            experts_pad=_ceil_to(cfg.n_experts, tp) if cfg.n_experts else 0,
            ssm_heads_pad=_ceil_to(cfg.ssm_heads, tp) if cfg.ssm_heads else 0)

    def kv_select(self, shard: int) -> int | None:
        """Global KV head this shard keeps (kv_single only)."""
        if not self.kv_single:
            return None
        hq_l = self.heads_pad // self.tp
        return (shard * hq_l * self.kv_pad) // self.heads_pad

    def kv_map(self, cfg: ModelConfig, shard: int) -> list[int] | None:
        """Local q head -> local KV-cache head index (None = default
        GQA)."""
        hq_l = self.heads_pad // self.tp
        if self.kv_single:
            return None
        if self.kv_replicated:
            # cache holds all n_kv heads; global q head h uses h*kv//heads
            return [min(max(((shard * hq_l + j) * self.kv_pad)
                            // max(self.heads_pad, 1), 0), self.kv_pad - 1)
                    for j in range(hq_l)]
        kv_l = self.kv_pad // self.tp
        if hq_l % kv_l == 0 and (self.heads_pad // self.kv_pad) * kv_l == hq_l:
            return None  # contiguous GQA grouping holds shard-locally
        return [j * kv_l // hq_l for j in range(hq_l)]

    def kv_heads(self, cfg: ModelConfig) -> list[int]:
        """For every global (padded) q head, the head of the global K / V
        projection it attends with: each shard's ``kv_select`` /
        ``kv_map`` mapped onto the global heads."""
        hq_l = self.heads_pad // self.tp
        out = []
        for t in range(self.tp):
            sel, kmap = self.kv_select(t), self.kv_map(cfg, t)
            for j in range(hq_l):
                if sel is not None:
                    out.append(sel)
                elif self.kv_replicated:
                    out.append(kmap[j])
                else:
                    kv_l = self.kv_pad // self.tp
                    local = (j // (hq_l // kv_l) if kmap is None
                             else kmap[j])
                    out.append(t * kv_l + local)
        return out


class Leaf(NamedTuple):
    shape: tuple
    init: str                      # 'normal' | 'ones'
    fsdp_dim: int | None = None    # dim sharded over the fsdp axes
    tp_dim: int | None = None      # dim sharded over 'model' (tp > 1)


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.attn_every
            or cfg.frontend):
        raise NotImplementedError(
            f"model family {cfg.family!r} of {cfg.name!r} is not ported yet: "
            "ROADMAP A21 (the port's transformer is the dense family)")


def param_table(cfg: ModelConfig, *, tp: int = 1,
                fsdp_axes: tuple[str, ...] | None = None) -> dict[str, Any]:
    """The leaf table of the dense family. Shapes are global and padded
    for ``tp`` (the stored shapes on one card); with ``tp`` > 1 each
    tp-sharded leaf carries its ``tp_dim``, with ``fsdp_axes`` each
    sharded leaf its ``fsdp_dim`` (stack dim counted)."""
    _check_dense(cfg)
    lay = TpLayout.build(cfg, tp)
    d, dh, f, L = cfg.d_model, cfg.dh, cfg.d_ff, cfg.n_layers
    if f % tp:
        raise ValueError(f"d_ff {f} does not split over {tp} tp ranks")

    def w(shape, tp_dim=None, fsdp_dim=None, init="normal"):
        return Leaf(tuple(shape), init,
                    fsdp_dim if fsdp_axes is not None else None,
                    tp_dim if tp > 1 else None)

    kv_tp = None if lay.kv_replicated else 2
    stage = {
        "ln1": w((L, d), init="ones"),
        "wq": w((L, d, lay.heads_pad * dh), tp_dim=2, fsdp_dim=1),
        "wk": w((L, d, lay.kv_pad * dh), tp_dim=kv_tp, fsdp_dim=1),
        "wv": w((L, d, lay.kv_pad * dh), tp_dim=kv_tp, fsdp_dim=1),
        "wo": w((L, lay.heads_pad * dh, d), tp_dim=1, fsdp_dim=2),
        "ln2": w((L, d), init="ones"),
        "w_gate": w((L, d, f), tp_dim=2, fsdp_dim=1),
        "w_up": w((L, d, f), tp_dim=2, fsdp_dim=1),
        "w_down": w((L, f, d), tp_dim=1, fsdp_dim=2),
    }
    table: dict[str, Any] = {
        "embed": w((lay.vocab_pad, d), tp_dim=0, fsdp_dim=1),
        "final_ln": w((d,), init="ones"),
        "stages": [stage],
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = w((d, lay.vocab_pad), tp_dim=1, fsdp_dim=0)
    return table


def param_specs(cfg: ModelConfig, *, tp: int = 1,
                fsdp_axes: tuple[str, ...] | None = None):
    """Each leaf's partition spec, as the reference's ``PartitionSpec``: a
    tuple with one entry per dim, None or the axis name (a tuple of names
    for several axes, pod-major) the dim is sharded over; ``"model"`` on
    the tp dim."""
    def spec(leaf: Leaf):
        out = [None] * len(leaf.shape)
        if leaf.tp_dim is not None:
            out[leaf.tp_dim] = "model"
        if leaf.fsdp_dim is not None:
            out[leaf.fsdp_dim] = (fsdp_axes if len(fsdp_axes) > 1
                                  else fsdp_axes[0])
        return tuple(out)
    return _map_table(spec, param_table(cfg, tp=tp, fsdp_axes=fsdp_axes))


def tp_dims(cfg: ModelConfig, tp: int) -> list[int | None]:
    """Each leaf's tp dim in tree order (None: replicated over tp)."""
    out: list[int | None] = []
    _map_table(lambda leaf: out.append(leaf.tp_dim), param_table(cfg, tp=tp))
    return out


def _layer_fsdp_dims(cfg: ModelConfig) -> dict[str, int | None]:
    """A layer slice's sharded dims (the stack dim removed)."""
    stage = param_table(cfg, fsdp_axes=("data",))["stages"][0]
    return {k: (v.fsdp_dim - 1 if v.fsdp_dim is not None else None)
            for k, v in stage.items()}


def _maybe_gather(pctx: ParallelCtx, w: torch.Tensor, dim: int | None,
                  key: Key | None, name: str) -> torch.Tensor:
    if dim is None or not pctx.fsdp or pctx.gather is None:
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
                device: torch.device | str, tp: int = 1,
                scale: float = 0.02):
    """Materialize parameters in ``cfg.param_dtype`` on ``device``, at the
    global padded shapes of ``tp``: normal leaves have std min(scale,
    1/sqrt(fan_in)) (the padding rows too, as in the reference), norms are
    ones. The values come from ``gen``, not from the reference's threefry
    stream; carry the reference's parameters over with
    ``weights.params_from_jax``."""
    def make(leaf: Leaf) -> torch.Tensor:
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=cfg.param_dtype,
                              device=device)
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
        std = min(scale, 1.0 / math.sqrt(fan_in))
        w = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return w.to(device=device, dtype=cfg.param_dtype)

    return _map_table(make, param_table(cfg, tp=tp))


def _layer(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
           names: tuple[str, ...], pctx: ParallelCtx,
           kv_heads: torch.Tensor | None, *weights: torch.Tensor
           ) -> torch.Tensor:
    """One pre-norm residual block (under SP, ``x`` is the ``(T, B, S/T,
    D)`` stack of sequence slices; the norms are per token)."""
    lw = dict(zip(names, weights))
    h = pctx.gather_seq(rms_norm(x, lw["ln1"]))    # SP: the full sequence
    x = x + attention_train(
        h, {"wq": lw["wq"], "wk": lw["wk"], "wv": lw["wv"], "wo": lw["wo"],
            "head_dim": cfg.dh, "attn_chunk": cfg.attn_chunk},
        positions=positions, rope_theta=cfg.rope_theta, pctx=pctx,
        kv_heads=kv_heads)
    h2 = pctx.gather_seq(rms_norm(x, lw["ln2"]))
    return x + gated_mlp(h2, lw, activation=cfg.activation, pctx=pctx)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                 pctx: ParallelCtx) -> torch.Tensor:
    """The embedding lookup; under tensor parallelism the reference's
    vocab-sharded form: each rank keeps the rows of the tokens in its own
    vocab range of the ``(V_pad, D)`` table (rank t's local row ``token -
    t * V_pad / T`` is the global row ``token``, so one gather serves
    every rank), zeroes the others, and the ranks' rows are summed over tp
    (one of them non-zero)."""
    rows = emb[tokens].to(cfg.param_dtype)
    t = pctx.tp_size()
    if t == 1:
        return rows
    v_local = emb.shape[0] // t
    lo = (pctx.tp_index(tokens.device) * v_local)[:, None, None]
    valid = (tokens[None] >= lo) & (tokens[None] < lo + v_local)  # (T, B, S)
    ranks = torch.where(valid[..., None], rows[None],
                        torch.zeros((), dtype=rows.dtype, device=rows.device))
    return pctx.psum_tp(ranks)


def forward_hidden(params, batch, cfg: ModelConfig, *, remat: bool = True,
                   pctx: ParallelCtx | None = None,
                   key: Key | None = None) -> torch.Tensor:
    """Tokens -> final hidden states (B, S, D). ``remat`` recomputes each
    layer in the backward pass (the reference's ``jax.checkpoint``). Under
    FSDP (``pctx.fsdp``) each sharded weight is gathered before the layer
    runs, outside the recomputed region, so a recompute gathers nothing.
    Under tensor parallelism the parameters are the global padded ones of
    ``param_table(cfg, tp=T)``; with ``pctx.sp`` the residual stream runs
    as the ranks' sequence slices and is gathered back after the final
    norm."""
    _check_dense(cfg)
    pctx = pctx or SINGLE
    tokens = batch["tokens"].long()
    emb = _maybe_gather(pctx, params["embed"], 1, key, "embed")
    x = embed_tokens(emb, tokens, cfg, pctx)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    t = pctx.tp_size()
    kv_heads = None
    if t > 1:
        kv_heads = torch.tensor(TpLayout.build(cfg, t).kv_heads(cfg),
                                dtype=torch.long, device=tokens.device)
        if pctx.seq_sharded():
            if s % t:
                raise ValueError(f"seq_parallel needs seq {s} divisible by "
                                 f"tp {t}")
            x = pctx.scatter_seq(x)
    stage = params["stages"][0]
    names = tuple(sorted(stage))
    fsdp_dim = _layer_fsdp_dims(cfg)
    # unbind: one view per layer, whose backward stacks the layer grads
    per_layer = zip(*(stage[k].unbind(0) for k in names))
    for layer, weights in enumerate(per_layer):
        if pctx.fsdp:
            lkey = fold_in(key, layer)
            weights = [_maybe_gather(pctx, w, fsdp_dim[k], lkey, k)
                       for k, w in zip(names, weights)]
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, positions, cfg, names, pctx, kv_heads,
                           *weights, use_reentrant=False)
        else:
            x = _layer(x, positions, cfg, names, pctx, kv_heads, *weights)
    return pctx.gather_seq(rms_norm(x, params["final_ln"]))


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


def _chunk_loss_tp(x_chunk: torch.Tensor, y_chunk: torch.Tensor,
                   head: torch.Tensor, pctx: ParallelCtx
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The vocab-parallel softmax: each rank's logits over its vocab range
    (one GEMM over the global head, viewed ``(T, B, c, V/T)``), the max
    detached and ``pmax_tp``'d, the exp-sum and the picked logit
    ``psum_tp``'d."""
    t = pctx.tp_size()
    logits = x_chunk.to(torch.float32) @ head.to(torch.float32)
    b, c, vp = logits.shape
    v_local = vp // t
    lg = logits.view(b, c, t, v_local).movedim(2, 0)        # (T, B, c, V/T)
    m = pctx.pmax_tp(lg.detach().amax(dim=-1))               # (B, c)
    z = pctx.psum_tp(torch.exp(lg - m[None, ..., None]).sum(dim=-1))
    local_y = y_chunk[None] - (pctx.tp_index(y_chunk.device)
                               * v_local)[:, None, None]
    valid = (local_y >= 0) & (local_y < v_local)
    safe = local_y.clamp(0, v_local - 1).long()
    picked = torch.gather(lg, -1, safe[..., None])[..., 0]
    correct = pctx.psum_tp(torch.where(valid, picked,
                                       torch.zeros_like(picked)))
    weight = (y_chunk >= 0).to(torch.float32)
    nll = (torch.log(z) + m - correct) * weight
    return nll.sum(), weight.sum()


def lm_loss(params, batch, cfg: ModelConfig, *, seq_chunk: int = 1024,
            remat: bool = True, pctx: ParallelCtx | None = None,
            key: Key | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over the sequence (full
    logits are never alive at once when ``remat`` recomputes each chunk).
    ``pctx`` and ``key`` as in :func:`forward_hidden`."""
    pctx = pctx or SINGLE
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
        args = (xc, yc, head)
        fn = _chunk_loss
        if pctx.tp_size() > 1:
            args, fn = (xc, yc, head, pctx), _chunk_loss_tp
        if remat and torch.is_grad_enabled():
            l, w = checkpoint(fn, *args, use_reentrant=False)
        else:
            l, w = fn(*args)
        total = total + l
        count = count + w
    return total / torch.clamp(count, min=1.0)
