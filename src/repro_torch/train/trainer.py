"""Replicated data-parallel trainer with OptiReduce as the gradient sync.

Counterpart of the ``replicated`` path of ``src/repro/train/trainer.py``.
The reference runs one rank per device under ``shard_map``; here the P
peers live on one card as the leading axis of a **packed arena** of shape
``(P, B, bucket_elems)``, one ``(B, bucket_elems)`` gradient arena per peer:

1. peer p takes rows ``[p*b_local, (p+1)*b_local)`` of the global batch and
   packs its gradients (micro-batch by micro-batch, accumulated in
   ``accum_dtype``) straight into its arena row;
2. ``sync_packed`` syncs the whole arena (stage skew ``pipelined`` by
   default) with every kernel launch covering all P peers of a bucket;
3. after stage 2 every peer holds the same synced arena (the tests assert
   it), so the §3.4 guard, the global norm over ``plan.total`` entries and
   the clip run once, as one multiply, on peer 0's copy;
4. one optimizer update is applied, in place, to the single parameter copy
   — the parameters every replica would hold.

The loss metric is the mean over peers; ``loss_frac`` the mean over
receivers. FSDP, tensor and sequence parallelism and wire transports wait
for later slices (ROADMAP A15, A18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
from repro_torch.core.bucket_plan import BucketPlan
from repro_torch.core.keys import Key, fold_in
from repro_torch.core.pipeline import (Draws, GeneratorDraws, SyncContext,
                                       resolve_spec)
from repro_torch.core.safeguards import guard_scale
from repro_torch.kernels import runtime as kernel_runtime
from repro_torch.models import lm_loss
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    sync: OptiReduceConfig = OptiReduceConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    dp_mode: str = "replicated"
    microbatch: int | None = None        # per-peer micro-batch (grad accum)
    seq_chunk: int = 1024                # loss sequence chunking
    remat: bool = True
    bucket_elems: int = 6_553_600        # 25 MB fp32 buckets
    sync_mode: str = "pipelined"         # 'pipelined' | 'scan'
    guard: bool = True                   # §3.4 skip-update safeguard
    accum_dtype: torch.dtype = torch.float32
    kernel_mode: str | None = None       # kernels/runtime mode, None = as is


def packed_global_norm(batch: torch.Tensor, plan: BucketPlan) -> torch.Tensor:
    """Global L2 norm of one peer's packed ``(B, bucket_elems)`` arena over
    its ``plan.total`` real entries (the zero-padded tail excluded)."""
    flat = batch.reshape(-1)[:plan.total].to(torch.float32)
    return torch.sqrt(torch.sum(flat * flat))


def _local(batch: dict, rows: slice, device: torch.device) -> dict:
    return {k: torch.as_tensor(v[rows]).to(device) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, tc: TrainConfig, *, peers: int,
                     device: torch.device | str) -> tuple[Callable, Any]:
    """Returns ``(step_fn, opt)``; ``step_fn(params, opt_state, batch, step,
    key, draws=None) -> (params, opt_state, metrics)`` updates ``params``
    and ``opt_state`` in place. ``batch`` is the global batch (numpy or
    tensors) split over ``peers``; ``draws`` overrides the step's default
    :class:`GeneratorDraws` (a test hands in the reference's)."""
    if tc.dp_mode != "replicated":
        raise NotImplementedError(f"dp_mode={tc.dp_mode!r} is not ported "
                                  "yet: ROADMAP A15")
    if tc.kernel_mode is not None:
        kernel_runtime.set_kernel_mode(tc.kernel_mode)
    device = torch.device(device)
    spec = resolve_spec(tc.sync)           # fail fast on unported settings
    opt = make_optimizer(tc.optimizer)

    def step_fn(params, opt_state, batch, step: int, key: Key,
                draws: Draws | None = None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        plan = BucketPlan.for_tree(params, tc.bucket_elems)
        skey = fold_in(key, step)
        gb = len(batch["tokens"])
        if gb % peers:
            raise ValueError(f"global batch {gb} not divisible by {peers} "
                             "peers")
        b_local = gb // peers
        mb = tc.microbatch or b_local
        n_micro = max(1, b_local // mb)
        arena_dtype = torch.float32 if n_micro == 1 else tc.accum_dtype
        arena = torch.zeros((peers, plan.num_buckets, plan.bucket_elems),
                            dtype=arena_dtype, device=device)
        losses = []
        for peer in range(peers):
            loss_p = torch.zeros((), device=device)
            for i in range(n_micro):
                lo = peer * b_local + i * mb
                mbatch = _local(batch, slice(lo, lo + mb), device)
                loss = lm_loss(params, mbatch, cfg, seq_chunk=tc.seq_chunk,
                               remat=tc.remat)
                grads = torch.autograd.grad(loss, leaves)
                plan.pack_into(arena[peer], tree_unflatten(params, grads),
                               accumulate=i > 0)
                loss_p = loss_p + loss.detach()
            losses.append(loss_p / n_micro)
        if n_micro > 1:
            # accumulate in accum_dtype, take the mean in fp32 wire space
            arena = arena.to(torch.float32) / n_micro

        ctx = SyncContext(cfg=tc.sync, draws=draws or GeneratorDraws(
            key=fold_in(skey, 7), cfg=tc.sync, device=device))
        synced = sync_packed(arena, ctx, mode=tc.sync_mode, spec=spec)
        loss_frac = ctx.loss_fraction().to(device)
        del arena

        g = synced[0]          # every peer holds the same synced arena
        if tc.guard:
            gscale, skipped = guard_scale(
                loss_frac, skip_threshold=tc.sync.skip_threshold)
        else:
            gscale = torch.ones((), device=device)
            skipped = torch.zeros((), dtype=torch.bool, device=device)
        gscale = gscale.to(device)
        gnorm = gscale * packed_global_norm(g, plan)
        clip = torch.clamp(tc.optimizer.grad_clip
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = plan.unpack(g * (gscale * clip))
        del synced, g
        params, opt_state = opt.update(grads, opt_state, params,
                                       tc.optimizer.lr, step)
        metrics = {
            "loss": torch.stack(losses).mean(),
            "grad_norm": gnorm,
            "loss_frac": loss_frac,
            "skipped": skipped.to(torch.float32),
        }
        return params, opt_state, metrics

    return step_fn, opt
