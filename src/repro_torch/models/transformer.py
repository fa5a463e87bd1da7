"""Decoder-only transformer family covering every architecture of the
reference: dense (GQA), MoE (top-k, shared experts, dense residual), SSM
(Mamba-2), the hybrid interleave (Jamba) and the frontend-stubbed VLM and
audio variants.

Counterpart of ``src/repro/models/transformer.py`` (``TpLayout``,
``param_table``, ``init_params``, ``count_params``, ``active_params``,
``abstract_params``, ``forward_hidden``, ``lm_loss``, ``prefill_step``,
``init_decode_state``, ``decode_step``). The port keeps the
reference's parameter tree, so parameters carry over leaf for leaf
(``weights.params_from_jax``) and the gradient arena has the same layout.
Layers are organised in a repeating *period* (1 for homogeneous stacks, 8
for Jamba's attention every 8 and MoE every 2), one dict of leaves a period
position, each leaf stacked over the period's repeats::

    {"embed": (V, D), "final_ln": (D,), ["lm_head": (D, V),]
     ["frontend_proj": (F, D),]
     "stages": [{"ln1", attention: "wq", "wk", "wv", "wo" | Mamba-2: "wx",
                 "wz", "wB", "wC", "wdt", "dt_bias", "conv_w", "a_log",
                 "d_skip", "out_proj"; "ln2" unless pure SSM, MLP: "w_gate",
                 "w_up", "w_down" | MoE: "router", "we_gate", "we_up",
                 "we_down" (+ "ws_*" shared experts, + the MLP for a dense
                 residual)} for each period position]}

The tree order is the sorted dict keys, the positions in order. The head
is tied (``embed.T``) unless ``tie_embeddings`` is off. A frontend family's
batch may carry ``prefix_embeds`` (B, P, F): projected by
``frontend_proj`` and put before the tokens; the loss skips the prefix
positions. The loss is the mean next-token cross-entropy, chunked over the
sequence with weight ``labels >= 0``, logits in fp32.

Tensor parallelism, every family (``param_table(cfg, tp=T)``,
``pctx.tp_axis``): the shapes are the reference's global, padded ones
(``TpLayout``: heads, KV heads, vocab, experts and SSM heads padded to
multiples of T; the KV projections replicated when there are fewer KV
heads than ranks), and a leaf's ``tp_dim`` is the dim the reference shards
over ``model``: ``wq``, ``w_gate``, ``w_up``, ``ws_gate``, ``ws_up`` (and
``wk``, ``wv`` unless replicated) column-parallel on their output dim,
``wo``, ``w_down`` and ``ws_down`` row-parallel on their input dim,
``embed`` on the vocab; the experts ``we_*`` on the expert dim; Mamba-2's
``wx``, ``wz``, ``wdt``, ``conv_w`` on their channel or head dim,
``dt_bias``, ``a_log``, ``d_skip`` on the heads, ``out_proj`` row-parallel;
``router``, ``wB``, ``wC``, ``frontend_proj`` and the norms replicated
(each rank's partial gradient of a replicated leaf sums by construction:
one activation feeds every rank). The MoE computes all experts and splits
its output by the rank that owns each expert (``models/moe.py``; over
ranks a rank computes only its own). The
weights stay stored once, global: tp rank t's shard is the t-th of T
contiguous chunks of the tp dim, a view (``P(..., "model")``'s cut). A
column-parallel product runs as one GEMM over the global weight (no
shard's output depends on another's); a row-parallel product is T partial
products, each rounded to the activation dtype, summed by ``psum_tp`` in
rank order, as the reference's ranks compute and psum them. The embedding
looks up each rank's vocab range, masks it and sums over tp; the loss is the
vocab-parallel softmax (``pmax_tp`` of the detached max, ``psum_tp`` of the
exp-sum and of the picked logit). Under ``pctx.sp`` the residual stream is
a ``(T, B, S/T, D)`` stack of sequence slices between the sublayers
(``models/parallel.py``); a frontend's prefix is projected by the
replicated ``frontend_proj``, put before the tokens, and the whole stream
sliced, so prefix and tokens together must split over T (the reference
truncates instead: ROADMAP C). At T = 1 every product is the plain one.

Over ranks (``pctx.over_ranks()``: one tp rank a process, the
reference's ``shard_map`` body) the tree holds this rank's shard of every
tp-sharded leaf, its chunk t of the tp dim (``train/elastic.py``): the
embedding looks up its own ``(V_pad/T, D)`` rows and sums over the tp
group, the head is its ``(D, V_pad/T)`` columns, the attention runs its
``Hq/T`` q heads with the K / V heads ``_kv_maps`` gives shard t, and each
stack over the tp dim is the rank's one row (``models/parallel.py``); the
MoE holds and computes only the rank's own experts (``models/moe.py``),
Mamba-2 only the rank's own SSM heads (``models/ssm.py``). It runs the
dense, MoE, SSM and frontend-prefix families, and sequence parallelism with
the dense block: the rank's residual stream is its ``(1, B, S/T, D)``
slice of prefix and tokens, each rank projects its data index's own
prefix rows by the whole ``frontend_proj`` before the slice (whose
backward gathers the whole gradient, so the projection's is complete on
every rank, as without SP, where every column-parallel input's "f" makes
the residual stream's gradient whole), and the norms, which see the
rank's slice alone, have their gradient summed over the tp group
(``pctx.copy_seq``). The hybrid family and the MoE or SSM block under SP
raise (:func:`check_tp_ranks`, later slices of ROADMAP A18c).

FSDP (``param_table(cfg, fsdp_axes=...)``): a leaf's ``fsdp_dim`` is the dim
the reference shards over the fsdp axes: ``embed`` on dim 1, the
projections on their input dim (``wo``, ``w_down``, ``out_proj`` and the
down projections of the experts on their output dim), ``frontend_proj`` on
dim 0; the norms and Mamba-2's ``dt_bias``, ``conv_w``, ``a_log`` and
``d_skip`` replicated. The forward pass gathers each sharded weight through
``pctx.gather`` at the reference's call sites, each named by its key path
below the step key: ``embed`` at ``()`` for the lookup and again for the
tied head, ``frontend_proj`` at ``()`` (only when the batch has a prefix),
layer l's weights at ``(l,)`` (the reference's ``fold_in(key, l)``); the
gather derives the keys. Under tensor parallelism a leaf is sharded on both
dims and the gather hands over the global weight, the trainer cutting its
gradient per tp shard.

Serving: ``prefill_step`` runs the prompt through ``forward_hidden`` with
``collect_state`` (each attention layer's post-RoPE K / V, each Mamba-2
layer's conv tail and final SSD state, stacked over the period's repeats)
and takes the fp32 head's greedy token at the last position;
``decode_step`` embeds one token a row, runs every layer against its slice
of the decode state (``init_decode_state``: KV caches ``(n_repeat, B,
S_max, H_cache, dh)``, conv ``(n_repeat, B, K-1, d_inner)``, fp32 SSD
``(n_repeat, B, H, P, N)``) and writes each layer's new state into it in
place, one index write into the stacked cache a layer (the reference keeps
the cache in its scan's carry for the same reason: one live copy). The
greedy token is the argmax of the fp32 logits; under tensor parallelism
each rank's best of its vocab range, ``pmax_tp`` and ``psum_tp`` of the
winner's index, as the reference's ranks agree on it. On the serving grid
(``serve/engine.py``) a ``pctx`` with data peers and no ``seq_shard_axis``
means the batch's rows are the peers' (the MoE routes each peer's on their
own); with ``seq_shard_axis`` the cache's sequence is theirs and the batch
is replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.core.keys import Key, normal, split, uniform
from repro_torch.kernels.threefry.ref import log_xla

from .layers import (KVCache, attention_decode, attention_train, gated_mlp,
                     rms_norm)
from .moe import moe_block
from .parallel import SINGLE, ParallelCtx
from .ssm import SSMState, mamba2_forward


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

    @property
    def kv_local(self) -> int:
        """KV heads a shard's decode cache holds."""
        if self.kv_single:
            return 1
        if self.kv_replicated:
            return self.kv_pad
        return self.kv_pad // self.tp

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

    def cache_heads(self, cfg: ModelConfig
                    ) -> tuple[list[int] | None, list[int]]:
        """The global decode cache under tp: the K / V projection head each
        cache head holds (None: all ``kv_pad`` in order) and each global q
        head's cache head. A ``kv_single`` rank keeps the one head its q
        heads use, so the cache holds T heads, rank t's at index t."""
        if self.kv_single:
            hq_l = self.heads_pad // self.tp
            return ([self.kv_select(t) for t in range(self.tp)],
                    [h // hq_l for h in range(self.heads_pad)])
        return None, self.kv_heads(cfg)


class KvMaps(NamedTuple):
    """Head maps under tensor parallelism (int64 tensors): each q head's
    K / V projection head, the cache's heads (None: all) and each q head's
    cache head; ``shared``: the K / V projections are replicated over tp
    (``kv_replicated``)."""
    q_kv: torch.Tensor
    cache: torch.Tensor | None
    q_cache: torch.Tensor | None
    shared: bool = False


def _kv_maps(cfg: ModelConfig, t: int, device,
             shard: int | None = None) -> KvMaps | None:
    """The head maps at tp ``t`` over the global heads, or with ``shard``
    those of that tp rank's own heads (over ranks: its q heads' K / V
    heads in its own, or the replicated, projection; no cache maps)."""
    if t == 1:
        return None
    lay = TpLayout.build(cfg, t)

    def as_tensor(v):
        return None if v is None else torch.tensor(v, dtype=torch.long,
                                                   device=device)
    if shard is not None:
        hq_l = lay.heads_pad // t
        own = lay.kv_heads(cfg)[shard * hq_l:(shard + 1) * hq_l]
        if not lay.kv_replicated:          # into the shard's own K / V heads
            own = [h - shard * (lay.kv_pad // t) for h in own]
        return KvMaps(as_tensor(own), None, None, lay.kv_replicated)
    heads, q_cache = lay.cache_heads(cfg)
    return KvMaps(as_tensor(lay.kv_heads(cfg)), as_tensor(heads),
                  as_tensor(q_cache))


# what one rank a tp rank runs, named by every refusal of a later slice
TP_RANKS_RUN = ("one rank a tp rank runs the dense, MoE, SSM and "
                "frontend-prefix families, replicated or FSDP over the data "
                "ranks, one pod, and --seq-parallel with the dense block")


def check_tp_ranks(cfg: ModelConfig, *, seq_parallel: bool = False,
                   positions: int | None = None, tp: int = 1) -> None:
    """Raise on what tp over ranks does not run for ``cfg``, naming its
    slice of ROADMAP A18c: the hybrid family (slice 3), ``--seq-parallel``
    with the MoE or SSM block (slice 12), and under ``--seq-parallel`` a
    sequence of ``positions`` (prefix and tokens) that does not split over
    the ``tp`` ranks (slice 6 splits it, as the stacked form does)."""
    what = None
    if cfg.n_experts and cfg.ssm_heads:
        what = (f"the hybrid family over tp ranks ({cfg.name}) is slice 3 "
                "of ROADMAP A18c, which waits for a machine with four cards")
    elif seq_parallel and (cfg.n_experts or cfg.ssm_heads):
        block = "MoE" if cfg.n_experts else "SSM"
        what = (f"--seq-parallel with the MoE or SSM block over tp ranks "
                f"({cfg.name}'s {block} block) is slice 12 of ROADMAP A18c")
    elif seq_parallel and positions is not None and positions % tp:
        what = (f"--seq-parallel over tp ranks splits the sequence (prefix "
                f"and tokens), {positions} positions here, over tp {tp} "
                "(slice 6 of ROADMAP A18c; the reference truncates it: "
                "ROADMAP C)")
    if what is not None:
        raise ValueError(f"{what}; {TP_RANKS_RUN}")


class Leaf(NamedTuple):
    shape: tuple
    init: str                      # normal | zeros | ones | alog | conv
    fsdp_dim: int | None = None    # dim sharded over the fsdp axes
    tp_dim: int | None = None      # dim sharded over 'model' (tp > 1)


def _period(cfg: ModelConfig) -> int:
    """Layers of one repeating unit: 1 for homogeneous stacks, lcm of the
    attention and MoE periods otherwise (8 for Jamba)."""
    p = cfg.attn_every or 1
    if cfg.n_experts and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    return p


def _layer_leaves(cfg: ModelConfig, lay: TpLayout, pos: int, n_repeat: int,
                  w) -> dict[str, Leaf]:
    """The leaves of one period position, stacked over its ``n_repeat``
    layers: the reference's ``_layer_leaves``."""
    d, dh, L = cfg.d_model, cfg.dh, n_repeat
    is_moe = cfg.is_moe_layer(pos)
    leaves: dict[str, Leaf] = {"ln1": w((L, d), init="ones")}
    if cfg.is_attn_layer(pos):
        kv_tp = None if lay.kv_replicated else 2
        leaves["wq"] = w((L, d, lay.heads_pad * dh), tp_dim=2, fsdp_dim=1)
        leaves["wk"] = w((L, d, lay.kv_pad * dh), tp_dim=kv_tp, fsdp_dim=1)
        leaves["wv"] = w((L, d, lay.kv_pad * dh), tp_dim=kv_tp, fsdp_dim=1)
        leaves["wo"] = w((L, lay.heads_pad * dh, d), tp_dim=1, fsdp_dim=2)
    else:
        di = cfg.d_inner
        h = lay.ssm_heads_pad or cfg.ssm_heads
        gn = cfg.ssm_state                   # one group
        leaves["wx"] = w((L, d, di), tp_dim=2, fsdp_dim=1)
        leaves["wz"] = w((L, d, di), tp_dim=2, fsdp_dim=1)
        leaves["wB"] = w((L, d, gn), fsdp_dim=1)
        leaves["wC"] = w((L, d, gn), fsdp_dim=1)
        leaves["wdt"] = w((L, d, h), tp_dim=2, fsdp_dim=1)
        leaves["dt_bias"] = w((L, h), tp_dim=1, init="zeros")
        leaves["conv_w"] = w((L, cfg.ssm_conv_k, di), tp_dim=2, init="conv")
        leaves["a_log"] = w((L, h), tp_dim=1, init="alog")
        leaves["d_skip"] = w((L, h), tp_dim=1, init="ones")
        leaves["out_proj"] = w((L, di, d), tp_dim=1, fsdp_dim=2)
    # the FFN position: MLP or MoE (both for arctic's dense residual);
    # pure-SSM layers (d_ff 0, no MoE) have no FFN sublayer at all
    needs_dense = (not is_moe) or cfg.dense_residual
    if (needs_dense and cfg.d_ff) or is_moe:
        leaves["ln2"] = w((L, d), init="ones")
    if needs_dense and cfg.d_ff:
        leaves["w_gate"] = w((L, d, cfg.d_ff), tp_dim=2, fsdp_dim=1)
        leaves["w_up"] = w((L, d, cfg.d_ff), tp_dim=2, fsdp_dim=1)
        leaves["w_down"] = w((L, cfg.d_ff, d), tp_dim=1, fsdp_dim=2)
    if is_moe:
        e, f = lay.experts_pad, cfg.d_ff
        leaves["router"] = w((L, d, e), fsdp_dim=1)
        leaves["we_gate"] = w((L, e, d, f), tp_dim=1, fsdp_dim=2)
        leaves["we_up"] = w((L, e, d, f), tp_dim=1, fsdp_dim=2)
        leaves["we_down"] = w((L, e, f, d), tp_dim=1, fsdp_dim=3)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * cfg.d_ff
            leaves["ws_gate"] = w((L, d, fs), tp_dim=2, fsdp_dim=1)
            leaves["ws_up"] = w((L, d, fs), tp_dim=2, fsdp_dim=1)
            leaves["ws_down"] = w((L, fs, d), tp_dim=1, fsdp_dim=2)
    return leaves


def param_table(cfg: ModelConfig, *, tp: int = 1,
                fsdp_axes: tuple[str, ...] | None = None) -> dict[str, Any]:
    """The complete leaf table, ``{"embed", "final_ln", "stages": [one dict
    a period position], "lm_head" (untied), "frontend_proj" (frontend
    families)}``, each stage leaf stacked over the period's repeats. Shapes
    are global and padded for ``tp`` (the stored shapes on one card); with
    ``tp`` > 1 each tp-sharded leaf carries its ``tp_dim``, with
    ``fsdp_axes`` each sharded leaf its ``fsdp_dim`` (stack dim counted)."""
    lay = TpLayout.build(cfg, tp)
    period = _period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"periods of {period}")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over {tp} tp "
                         "ranks")
    if cfg.ssm_heads and cfg.d_inner % tp:
        raise ValueError(f"d_inner {cfg.d_inner} does not split over {tp} "
                         "tp ranks")

    def w(shape, tp_dim=None, fsdp_dim=None, init="normal"):
        return Leaf(tuple(shape), init,
                    fsdp_dim if fsdp_axes is not None else None,
                    tp_dim if tp > 1 else None)

    d = cfg.d_model
    table: dict[str, Any] = {
        "embed": w((lay.vocab_pad, d), tp_dim=0, fsdp_dim=1),
        "final_ln": w((d,), init="ones"),
        "stages": [_layer_leaves(cfg, lay, pos, cfg.n_layers // period, w)
                   for pos in range(period)],
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = w((d, lay.vocab_pad), tp_dim=1, fsdp_dim=0)
    if cfg.frontend:
        table["frontend_proj"] = w((cfg.frontend_dim, d), fsdp_dim=0)
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


def _layer_fsdp_dims(cfg: ModelConfig) -> list[dict[str, int | None]]:
    """Each period position's layer slice's sharded dims (the stack dim
    removed)."""
    return [{k: (v.fsdp_dim - 1 if v.fsdp_dim is not None else None)
             for k, v in stage.items()}
            for stage in param_table(cfg, fsdp_axes=("data",))["stages"]]


def _maybe_gather(pctx: ParallelCtx, w: torch.Tensor, dim: int | None,
                  path: tuple[int, ...], name: str) -> torch.Tensor:
    if dim is None or not pctx.fsdp or pctx.gather is None:
        return w
    return pctx.gather(w, dim, path, name)


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


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts of each
    routed expert leaf)."""
    table = param_table(cfg)
    total = 0
    for name, leaf in _walk(table):
        n = math.prod(leaf.shape)
        if cfg.n_experts and name.startswith("we_"):
            n = n * cfg.top_k // max(cfg.n_experts, 1)
        total += n
    return total


def _walk(table, name: str = ""):
    """(leaf name, leaf) pairs in tree order."""
    if isinstance(table, Leaf):
        yield name, table
    elif isinstance(table, dict):
        for k in sorted(table):
            yield from _walk(table[k], k)
    else:
        for v in table:
            yield from _walk(v, name)


def abstract_params(cfg: ModelConfig, *, tp: int = 1,
                    fsdp_axes: tuple[str, ...] | None = None):
    """The parameter tree as ``device="meta"`` tensors (no allocation)."""
    return _map_table(
        lambda leaf: torch.empty(leaf.shape, dtype=cfg.param_dtype,
                                 device="meta"),
        param_table(cfg, tp=tp, fsdp_axes=fsdp_axes))


def init_params(key: Key, cfg: ModelConfig, *,
                device: torch.device | str, tp: int = 1,
                scale: float = 0.02,
                keep: Callable[[int, torch.Tensor], torch.Tensor] | None
                = None):
    """Materialize parameters in ``cfg.param_dtype`` on ``device``, at the
    global padded shapes of ``tp``, as the reference draws them: ``key`` is
    split once per leaf, the keys handed out in the order the reference's
    table walk meets the leaves (dict insertion order), normal leaves are ``normal * std`` with std min(scale,
    1/sqrt(fan_in)) (the padding rows too), norms and ``d_skip`` ones,
    ``dt_bias`` zeros, ``a_log`` ``log(uniform(k, shape, 1, 16))`` (Mamba-2's
    A), ``conv_w`` normal / sqrt(kernel width); fp32, then cast. The draws
    are the reference's threefry bits (``core/keys.py``) and ``a_log`` is
    bit for bit the reference's; a normal is within 2 ulp of fp32 of it
    (XLA's CPU formulas, about two values in 10^5 differ), so nearly every
    bf16 weight equals the reference's. ``keep(i, w)``, when given, takes
    leaf i (tree order) as it is drawn and returns what to hold of it (a
    rank's FSDP shard): the full leaf goes before the next is drawn."""
    table = param_table(cfg, tp=tp)
    # the reference splits the key into one key a leaf and hands them out
    # in the order its table walk visits the leaves: dicts in insertion
    # order, not the sorted tree order
    visits: list[int] = []

    def visit(node) -> None:
        if isinstance(node, Leaf):
            visits.append(id(node))
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        else:
            for v in node:
                visit(v)
    visit(table)
    keys = dict(zip(visits, split(key, len(visits))))

    def make(leaf: Leaf) -> torch.Tensor:
        k = keys[id(leaf)]
        if leaf.init in ("ones", "zeros"):
            fill = torch.ones if leaf.init == "ones" else torch.zeros
            return fill(leaf.shape, dtype=cfg.param_dtype, device=device)
        if leaf.init == "alog":
            w = log_xla(uniform(k, leaf.shape, device, minval=1.0,
                                maxval=16.0))
        else:
            w = normal(k, leaf.shape, device)
            if leaf.init == "conv":
                # a true division, on the card too
                w = w / torch.full_like(w, math.sqrt(leaf.shape[-2]))
            else:
                fan_in = (leaf.shape[-2] if len(leaf.shape) >= 2
                          else leaf.shape[-1])
                w = w * min(scale, 1.0 / math.sqrt(fan_in))
        return w.to(dtype=cfg.param_dtype)

    if keep is None:
        return _map_table(make, table)
    order = iter(range(len(visits)))     # _map_table walks in tree order
    return _map_table(lambda leaf: keep(next(order), make(leaf)), table)


def _layer(x: torch.Tensor, positions: torch.Tensor | None,
           cfg: ModelConfig, pos: int, names: tuple[str, ...],
           pctx: ParallelCtx, kv: KvMaps | None, *weights: torch.Tensor,
           state=None, step: torch.Tensor | None = None,
           seq_shards: int = 1, peers: int = 1,
           collect_state: bool = False):
    """One pre-norm residual block at period position ``pos``: attention or
    Mamba-2, then the FFN position (gated MLP, MoE, both for a dense
    residual, plus the shared experts; none on a pure-SSM layer). Under SP
    ``x`` is the ``(T, B, S/T, D)`` stack of sequence slices (dense family
    only; the norms are per token). Returns ``(x, state)``: with ``step``
    (decode: the token's one-element position) ``state`` is the layer's
    ``KVCache`` / ``SSMState``, updated in place; with ``collect_state``
    the state the sequence leaves (prefill); None otherwise. ``seq_shards``
    and ``peers`` split the cache's sequence or the batch's rows over the
    data peers (``decode_step``)."""
    lw = dict(zip(names, weights))
    # SP: the full sequence; over ranks the norm sees the rank's slice
    h = pctx.gather_seq(rms_norm(x, pctx.copy_seq(lw["ln1"])))
    new_state = None
    if cfg.is_attn_layer(pos):
        aw = {"wq": lw["wq"], "wk": lw["wk"], "wv": lw["wv"], "wo": lw["wo"],
              "head_dim": cfg.dh, "attn_chunk": cfg.attn_chunk}
        if step is not None:
            att, new_state = attention_decode(
                h, aw, state, pos=step, rope_theta=cfg.rope_theta, pctx=pctx,
                kv_map=kv.q_cache if kv else None,
                cache_heads=kv.cache if kv else None, seq_shards=seq_shards)
        else:
            att = attention_train(
                h, aw, positions=positions, rope_theta=cfg.rope_theta,
                pctx=pctx, kv_heads=kv.q_kv if kv else None,
                cache_heads=kv.cache if kv else None,
                collect_kv=collect_state,
                kv_shared=bool(kv and kv.shared))
            if collect_state:
                att, new_state = att
        x = x + att
    else:
        y, ssm = mamba2_forward(h, {**lw, "d_state": cfg.ssm_state,
                                    "n_groups": 1}, pctx=pctx,
                                chunk=cfg.ssm_chunk, state=state,
                                decode=step is not None)
        if step is not None:
            state.conv.copy_(ssm.conv)
            state.ssm.copy_(ssm.ssm)
            new_state = state
        elif collect_state:
            new_state = ssm
        x = x + y
    if "ln2" not in lw:                    # pure-SSM layer: no FFN sublayer
        return x, new_state
    h2 = pctx.gather_seq(rms_norm(x, pctx.copy_seq(lw["ln2"])))
    ff = None
    if "w_gate" in lw:
        ff = gated_mlp(h2, lw, activation=cfg.activation, pctx=pctx)
    if cfg.is_moe_layer(pos):
        moe = moe_block(h2, lw, top_k=cfg.top_k,
                        n_experts=cfg.n_experts,
                        capacity_factor=cfg.capacity_factor,
                        activation=cfg.activation, peers=peers,
                        weights_stationary=pctx.moe_stationary and pctx.fsdp,
                        pctx=pctx)
        ff = moe if ff is None else ff + moe
        if cfg.n_shared_experts:
            ff = ff + gated_mlp(h2, {"w_gate": lw["ws_gate"],
                                     "w_up": lw["ws_up"],
                                     "w_down": lw["ws_down"]},
                                activation=cfg.activation, pctx=pctx)
    return x + ff, new_state


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                 pctx: ParallelCtx) -> torch.Tensor:
    """The embedding lookup; under tensor parallelism the reference's
    vocab-sharded form: each rank keeps the rows of the tokens in its own
    vocab range of the ``(V_pad, D)`` table (rank t's local row ``token -
    t * V_pad / T`` is the global row ``token``, so one gather serves
    every rank), zeroes the others, and the ranks' rows are summed over tp
    (one of them non-zero). Over ranks ``emb`` is the rank's own ``(V_pad
    / T, D)`` rows, read at ``token - t * V_pad / T``."""
    t = pctx.tp_size()
    if t == 1:
        return emb[tokens].to(cfg.param_dtype)
    v_local = emb.shape[0] // pctx.tp_rows()
    lo = (pctx.tp_index(tokens.device) * v_local)[:, None, None]
    valid = (tokens[None] >= lo) & (tokens[None] < lo + v_local)  # (T, B, S)
    if pctx.over_ranks():
        rows = emb[(tokens[None] - lo).clamp(0, v_local - 1)].to(
            cfg.param_dtype)
    else:
        rows = emb[tokens].to(cfg.param_dtype)[None]
    ranks = torch.where(valid[..., None], rows,
                        torch.zeros((), dtype=rows.dtype, device=rows.device))
    return pctx.psum_tp(ranks)


def forward_hidden(params, batch, cfg: ModelConfig, *, remat: bool = True,
                   pctx: ParallelCtx | None = None,
                   collect_state: bool = False):
    """Tokens (after the frontend's prefix, when the batch has
    ``prefix_embeds``) -> final hidden states (B, S, D). The layers run in
    the reference's order, repeat r of the period's position p being layer
    ``r * period + p``. ``remat`` recomputes each layer in the backward pass
    (the reference's ``jax.checkpoint``). Under FSDP (``pctx.fsdp``) each
    sharded weight is gathered before its layer runs, outside the
    recomputed region, so a recompute gathers nothing; layer l's weights
    at the site path ``(l,)``, the embedding and the frontend projection at
    ``()``. Under tensor parallelism the parameters are the global padded
    ones of ``param_table(cfg, tp=T)``; with ``pctx.sp`` the residual
    stream runs as the ranks' sequence slices and is gathered back after
    the final norm. With ``collect_state`` (prefill; no recompute) returns
    ``(x, states)``: for each period position its layers' decode state
    (``KVCache`` / ``SSMState``) stacked over the repeats."""
    pctx = pctx or SINGLE
    t = pctx.tp_size()
    shard = None
    prefix = cfg.frontend and "prefix_embeds" in batch
    if pctx.over_ranks():
        check_tp_ranks(cfg, seq_parallel=pctx.sp, tp=t, positions=(
            batch["tokens"].shape[1]
            + (batch["prefix_embeds"].shape[1] if prefix else 0)))
        if collect_state:
            raise ValueError("serving over ranks is a later slice of "
                             "ROADMAP A18c: prefill runs as one process")
        shard = pctx.tp_grid.index_on(collectives.MODEL)
    tokens = batch["tokens"].long()
    emb = _maybe_gather(pctx, params["embed"], 1, (), "embed")
    x = embed_tokens(emb, tokens, cfg, pctx)
    if prefix:
        proj = _maybe_gather(pctx, params["frontend_proj"], 0, (),
                             "frontend_proj")
        pref = batch["prefix_embeds"].to(cfg.param_dtype) @ proj.to(
            cfg.param_dtype)
        x = torch.cat([pref, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    kv = _kv_maps(cfg, t, tokens.device, shard)
    if t > 1:
        if pctx.seq_sharded():
            if s % t:
                # the reference's ranks take s // t positions each and
                # drop the rest, misaligning the loss (ROADMAP C)
                raise ValueError(
                    f"seq_parallel needs the sequence (prefix and tokens) "
                    f"{s} divisible by tp {t}")
            x = pctx.scatter_seq(x)
    stages = params["stages"]
    period = len(stages)
    names = [tuple(sorted(stage)) for stage in stages]
    fsdp_dims = _layer_fsdp_dims(cfg) if pctx.fsdp else None
    # unbind: one view per layer, whose backward stacks the layer grads
    per_pos = [list(zip(*(stage[k].unbind(0) for k in nm)))
               for stage, nm in zip(stages, names)]
    collected = [[] for _ in range(period)]
    for r in range(len(per_pos[0])):
        for pos in range(period):
            weights = per_pos[pos][r]
            if pctx.fsdp:
                site = (r * period + pos,)
                weights = [_maybe_gather(pctx, w, fsdp_dims[pos][k], site, k)
                           for k, w in zip(names[pos], weights)]
            args = (x, positions, cfg, pos, names[pos], pctx, kv, *weights)
            if remat and torch.is_grad_enabled() and not collect_state:
                x, _ = checkpoint(_layer, *args, use_reentrant=False)
            else:
                x, st = _layer(*args, collect_state=collect_state)
                if collect_state:
                    collected[pos].append(st)
    x = pctx.gather_seq(rms_norm(x, pctx.copy_seq(params["final_ln"])))
    if not collect_state:
        return x
    return x, [type(sts[0])(*(torch.stack(parts) for parts in zip(*sts)))
               for sts in collected]


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
    (one GEMM over the global head, viewed ``(T, B, c, V/T)``; over ranks
    the rank's ``(D, V/T)`` head, its one row), the max detached and
    ``pmax_tp``'d, the exp-sum and the picked logit ``psum_tp``'d."""
    t = pctx.tp_rows()
    x_chunk = pctx.copy_act(x_chunk)
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


def _head(params, pctx: ParallelCtx) -> torch.Tensor:
    """The (D, V_pad) output head: ``lm_head``, or the tied ``embed.T``."""
    head = params.get("lm_head")
    if head is None:
        return _maybe_gather(pctx, params["embed"], 1, (), "head").T
    return _maybe_gather(pctx, head, 0, (), "lm_head")


def lm_loss(params, batch, cfg: ModelConfig, *, seq_chunk: int = 1024,
            remat: bool = True,
            pctx: ParallelCtx | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over the sequence (full
    logits are never alive at once when ``remat`` recomputes each chunk).
    ``pctx`` as in :func:`forward_hidden`."""
    pctx = pctx or SINGLE
    x = forward_hidden(params, batch, cfg, remat=remat, pctx=pctx)
    labels = batch["labels"]
    p = x.shape[1] - labels.shape[1]
    if p:
        x = x[:, p:]                      # loss only on token positions
    head = _head(params, pctx)
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


def _greedy(x: torch.Tensor, head: torch.Tensor,
            pctx: ParallelCtx) -> torch.Tensor:
    """(B, D) -> (B,) int32: the argmax of the fp32 logits (first index of
    a tie). Under tensor parallelism each rank's best over its vocab
    range, the ``pmax_tp`` of the bests, and the ``psum_tp`` of the index
    of every rank that holds it (ties across ranks add, as the
    reference's)."""
    logits = x.to(torch.float32) @ head.to(torch.float32)
    t = pctx.tp_size()
    if t == 1:
        return logits.argmax(dim=-1).to(torch.int32)
    b, vp = logits.shape
    v_local = vp // t
    lg = logits.view(b, t, v_local).movedim(1, 0)             # (T, B, V/T)
    best_local = lg.amax(dim=-1)
    best_idx = lg.argmax(dim=-1) + (pctx.tp_index(x.device)
                                    * v_local)[:, None]
    best = pctx.pmax_tp(best_local)
    winner = torch.where(best_local >= best, best_idx,
                         torch.zeros_like(best_idx))
    return pctx.psum_tp(winner).to(torch.int32)


@torch.no_grad()
def prefill_step(params, batch, cfg: ModelConfig,
                 pctx: ParallelCtx | None = None):
    """Serving prefill: consume the prompt, return ``(first_token (B, 1)
    int32, states)``, the states stacked over the repeats as
    ``init_decode_state`` lays them out (their sequence the prompt's)."""
    pctx = pctx or SINGLE
    x, states = forward_hidden(params, batch, cfg, remat=False, pctx=pctx,
                               collect_state=True)
    return _greedy(x[:, -1], _head(params, pctx), pctx)[:, None], states


def init_decode_state(params_like, cfg: ModelConfig, *, batch: int,
                      max_seq: int, tp: int = 1, seq_shards: int = 1,
                      dtype: torch.dtype = torch.bfloat16,
                      device: torch.device | str = "cpu"):
    """A zero decode state, one entry a period position (``params_like`` is
    unused, as in the reference): ``KVCache`` ``(n_repeat, B,
    S_max/seq_shards, kv_local, dh)`` for an attention position,
    ``SSMState`` conv ``(n_repeat, B, K-1, d_inner/tp)`` and fp32 (fp64
    under an fp64 ``dtype``) ssm ``(n_repeat, B, H/tp, P, N)`` for a
    Mamba-2 one: one shard's shapes,
    which at ``tp`` 1 and ``seq_shards`` 1 are the whole state."""
    del params_like
    lay = TpLayout.build(cfg, tp)
    period = _period(cfg)
    n_repeat = cfg.n_layers // period
    ssm_dtype = torch.promote_types(dtype, torch.float32)
    states = []
    for pos in range(period):
        if cfg.is_attn_layer(pos):
            shape = (n_repeat, batch, max_seq // seq_shards, lay.kv_local,
                     cfg.dh)
            states.append(KVCache(
                k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device)))
        else:
            h_l = (lay.ssm_heads_pad or cfg.ssm_heads) // tp
            states.append(SSMState(
                conv=torch.zeros((n_repeat, batch, cfg.ssm_conv_k - 1,
                                  cfg.d_inner // tp), dtype=dtype,
                                 device=device),
                ssm=torch.zeros((n_repeat, batch, h_l, cfg.ssm_head_dim,
                                 cfg.ssm_state), dtype=ssm_dtype,
                                device=device)))
    return states


def _serving_split(pctx: ParallelCtx, seq_shard_axis) -> tuple[int, int]:
    """``(seq_shards, peers)`` of a decode step: with ``seq_shard_axis``
    (the data axes) the cache's sequence is split over the data peers and
    the batch replicated; otherwise the batch's rows are split over them."""
    if seq_shard_axis is None:
        return 1, pctx.dp_size()
    axes = ((seq_shard_axis,) if isinstance(seq_shard_axis, str)
            else tuple(seq_shard_axis))
    if axes != pctx.dp_axes():
        raise ValueError(f"seq_shard_axis {axes} must be the data axes "
                         f"{pctx.dp_axes()}")
    return pctx.dp_size(), 1


@torch.no_grad()
def decode_step(params, state, tokens, pos, cfg: ModelConfig,
                pctx: ParallelCtx | None = None, *, seq_shard_axis=None):
    """One greedy decode step. ``tokens``: (B, 1); ``pos``: the tokens'
    position, an int or a 0-d tensor; ``state``: the global decode state
    (a list over period positions), written in place. Returns
    ``(next_tokens (B, 1) int32, state)``. Under FSDP layer l's weights
    are gathered at the site path ``(l,)``; with ``pctx.moe_stationary``
    the expert weights are not gathered."""
    pctx = pctx or SINGLE
    tokens = tokens.long()
    dev = tokens.device
    step = torch.as_tensor(pos, device=dev).to(torch.long).reshape(1)
    seq_shards, peers = _serving_split(pctx, seq_shard_axis)
    x = embed_tokens(_maybe_gather(pctx, params["embed"], 1, (), "embed"),
                     tokens, cfg, pctx)
    kv = _kv_maps(cfg, pctx.tp_size(), dev)
    stages = params["stages"]
    period = len(stages)
    names = [tuple(sorted(stage)) for stage in stages]
    fsdp_dims = _layer_fsdp_dims(cfg) if pctx.fsdp else None
    stationary = pctx.moe_stationary and pctx.fsdp
    for r in range(cfg.n_layers // period):
        for p in range(period):
            weights = [stages[p][k][r] for k in names[p]]
            if pctx.fsdp:
                site = (r * period + p,)
                weights = [w if stationary and k.startswith("we_") else
                           _maybe_gather(pctx, w, fsdp_dims[p][k], site, k)
                           for k, w in zip(names[p], weights)]
            layer_state = type(state[p])(*(a[r] for a in state[p]))
            x, _ = _layer(x, None, cfg, p, names[p], pctx, kv, *weights,
                          state=layer_state, step=step,
                          seq_shards=seq_shards, peers=peers)
    x = rms_norm(x, params["final_ln"])
    nxt = _greedy(x[:, 0], _head(params, pctx), pctx)
    return nxt[:, None], state
