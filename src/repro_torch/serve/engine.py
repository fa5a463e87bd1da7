"""Serving engine: batched decode on the peer grid.

Counterpart of ``src/repro/serve/engine.py``. The reference shards the
decode state over a device mesh and runs ``decode_step`` in a
``shard_map``; the port runs every peer on one card, the state and the
parameters stored whole at their global (tp-padded) shapes, and the
peers' collectives reindex ``(P, ...)`` stacks (``models/parallel.py``).
The sharding policy is the reference's, chosen per shape:

* batch >= dp_total (and divisible): the batch dim over ``('pod',
  'data')``, heads over ``model``. The data peers are a view of the batch:
  rows ``[i B/P, (i+1) B/P)`` are peer i's, and the MoE routes each peer's
  tokens on their own (capacity from B/P).
* batch < dp_total (B = 1, long context): the KV cache's *sequence* dim
  over the data axes (the flash-decoding split), the batch replicated; the
  cache's sequence is a ``(P, S/P)`` view and attention merges the peers'
  partial softmaxes (pmax of the maxima, psum of fp32 numerators and
  denominators).

``weight_fsdp`` shards the weights over the data axes and gathers them at
each use; on one card the gather is the identity, still called at the
reference's sites with its keys. ``moe_stationary`` keeps the expert
weights sharded and psums the expert activations instead. Tensor
parallelism serves every family: heads, experts (``E_pad / T`` a rank) and
SSM heads (``ssm_heads_pad / T``) over ``model``, so the global state
holds every rank's KV heads, conv channels and SSD heads
(``global_state``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import decode_step, init_decode_state, param_specs
from repro_torch.models.layers import KVCache
from repro_torch.models.parallel import SINGLE, ParallelCtx
from repro_torch.models.ssm import SSMState
from repro_torch.models.transformer import TpLayout


@dataclasses.dataclass(frozen=True)
class ServePlan:
    batch_axes: tuple[str, ...]      # mesh axes carrying the batch dim
    seq_axes: tuple[str, ...]        # mesh axes carrying the KV seq dim
    tp: int
    dp_total: int

    @property
    def seq_shards(self) -> int:
        return self.dp_total if self.seq_axes else 1


def plan_serving(mesh, global_batch: int) -> ServePlan:
    """The plan for ``global_batch`` rows on ``mesh`` (a ``HostMesh``)."""
    names = tuple(mesh.axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp_total = math.prod(mesh.shape[a] for a in dp_axes)
    tp = mesh.shape["model"] if "model" in names else 1
    if global_batch >= dp_total and global_batch % dp_total == 0:
        return ServePlan(batch_axes=dp_axes, seq_axes=(), tp=tp,
                         dp_total=dp_total)
    # tiny batch: shard the cache's sequence dim instead (split-K decode)
    return ServePlan(batch_axes=(), seq_axes=dp_axes, tp=tp,
                     dp_total=dp_total)


def _axes_entry(axes: tuple[str, ...]):
    """A spec entry: None, one axis name, or a tuple of names."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def state_specs(cfg: ModelConfig, plan: ServePlan):
    """Partition specs of the decode state, in ``param_specs``' form (a
    tuple an array, one entry a dim): KV ``(stack, B, S, H_kv, dh)``; SSM
    conv ``(stack, B, K-1, d_inner)``, ssm ``(stack, B, H, P, N)``.
    Returns ``build(state) -> specs`` of the state's structure."""
    lay = TpLayout.build(cfg, plan.tp)
    b_ax, s_ax = _axes_entry(plan.batch_axes), _axes_entry(plan.seq_axes)
    kv_sharded = plan.tp > 1 and (not lay.kv_replicated or lay.kv_single)
    kv_spec = (None, b_ax, s_ax, "model" if kv_sharded else None, None)
    tp_ax = "model" if plan.tp > 1 else None

    def build(state):
        out = []
        for st in state:
            if isinstance(st, KVCache):
                out.append(KVCache(k=kv_spec, v=kv_spec))
            elif isinstance(st, SSMState):
                out.append(SSMState(conv=(None, b_ax, None, tp_ax),
                                    ssm=(None, b_ax, tp_ax, None, None)))
            else:
                raise TypeError(type(st))
        return out

    return build


def global_state(cfg: ModelConfig, *, batch: int, max_seq: int, tp: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu"):
    """The zero decode state at its global, tp-padded shapes (each
    shard's head count times tp; a replicated multi-head KV cache keeps its
    count), the state ``build_serve_step``'s step takes."""
    lay = TpLayout.build(cfg, tp)
    mult = tp if (not lay.kv_replicated or lay.kv_single) else 1
    out = []
    for st in init_decode_state(None, cfg, batch=batch, max_seq=max_seq,
                                tp=tp, dtype=dtype, device="meta"):
        if isinstance(st, KVCache):
            n, b, s, h, dh = st.k.shape
            shape = (n, b, s, h * mult, dh)
            out.append(KVCache(
                k=torch.zeros(shape, dtype=st.k.dtype, device=device),
                v=torch.zeros(shape, dtype=st.k.dtype, device=device)))
        else:
            n, b, k1, di = st.conv.shape
            _, _, h, p, ns = st.ssm.shape
            out.append(SSMState(
                conv=torch.zeros((n, b, k1, di * tp), dtype=st.conv.dtype,
                                 device=device),
                ssm=torch.zeros((n, b, h * tp, p, ns), dtype=st.ssm.dtype,
                                device=device)))
    return out


def abstract_state(cfg: ModelConfig, shape: ShapeConfig, plan: ServePlan):
    """The decode state at its global (tp-padded) shapes as ``meta``
    tensors (no allocation): the reference's ``eval_shape``."""
    return global_state(cfg, batch=shape.global_batch, max_seq=shape.seq_len,
                        tp=plan.tp, device="meta")


def build_serve_step(cfg: ModelConfig, mesh, plan: ServePlan, *,
                     weight_fsdp: bool = False, moe_stationary: bool = False):
    """``make(abstract_state) -> (fn, specs)``: ``fn(params, state, tokens,
    pos) -> (next_tok (B, 1), state)`` runs one decode step of every
    peer of ``mesh`` under ``plan`` (the state written in place); ``specs``
    holds the partition specs of the params, the state and the tokens.

    ``weight_fsdp``: the weights are also sharded over the data axes and
    gathered per layer just in time (ZeRO-inference); ``moe_stationary``
    leaves the MoE expert weights sharded and psums their activations.
    """
    names = tuple(mesh.axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    pctx = ParallelCtx(
        tp_axis="model" if "model" in names else None,
        dp_axis="data" if "data" in names else None,
        pod_axis="pod" if "pod" in names else None,
        fsdp=weight_fsdp,
        # one card stores each weight whole: the gather hands it back
        gather=(lambda w, dim, path, name: w) if weight_fsdp else None,
        sizes=mesh.shape, moe_stationary=moe_stationary)
    seq_axes = plan.seq_axes or None
    p_specs = param_specs(cfg, tp=plan.tp,
                          fsdp_axes=dp_axes if weight_fsdp else None)
    s_specs = state_specs(cfg, plan)
    tok_spec = (_axes_entry(plan.batch_axes), None)

    def fn(params, state, tokens, pos):
        if seq_axes is None and tokens.shape[0] % plan.dp_total:
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"{plan.dp_total} data peers")
        lengths = {st.k.shape[2] for st in state if isinstance(st, KVCache)}
        if seq_axes and any(n % plan.dp_total for n in lengths):
            raise ValueError(f"cache length {lengths} does not split over "
                             f"{plan.dp_total} data peers")
        return decode_step(params, state, tokens, pos, cfg, pctx,
                           seq_shard_axis=seq_axes)

    def make(abstract_st):
        return fn, {"params": p_specs, "state": s_specs(abstract_st),
                    "tokens": tok_spec}

    return make


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, *,
             max_new: int = 16,
             pctx: ParallelCtx | None = None) -> torch.Tensor:
    """Single-peer loop: teacher-force the prompt token by token through
    ``decode_step`` (no prefill), then greedy-decode ``max_new`` tokens.
    Returns the prompts and the new tokens, (B, S0 + max_new). A ``pctx``
    with T tp ranks decodes over tp, on the global state of T ranks
    (``global_state``; ``params`` padded for T)."""
    pctx = pctx or SINGLE
    b, s0 = prompts.shape
    state = global_state(cfg, batch=b, max_seq=s0 + max_new,
                         tp=pctx.tp_size(), dtype=cfg.param_dtype,
                         device=prompts.device)
    tok = prompts[:, :1]
    out = [prompts]
    for t in range(s0 + max_new - 1):
        nxt, state = decode_step(params, state, tok, t, cfg, pctx)
        if t + 1 < s0:
            tok = prompts[:, t + 1:t + 2]      # teacher-force the prompt
        else:
            tok = nxt.to(prompts.dtype)
            out.append(tok)
    return torch.cat(out, dim=1)
