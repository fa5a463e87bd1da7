"""Dry run of every (arch x shape) cell on the production mesh, analysed on
the ``meta`` device: nothing is compiled and nothing is allocated.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell for 512 host devices and reads XLA's analyses. The port has no
compiler to ask, so it takes each cell's numbers from the abstract trees:

* the cell's plan, with the reference's fields: ``arch``, ``shape``,
  ``kind``, ``mesh``, ``params``, ``active_params``, ``strategy``,
  ``drop_rate``, ``status`` (``ok`` | ``skipped`` with its ``reason`` |
  ``error``), ``dp_mode`` and ``microbatch`` (train) or ``serve_plan``
  (decode), from the same ``PLAN`` table;
* ``state_bytes_per_device``: the bytes one device holds of the cell's
  state, each leaf's shape cut by its partition spec on the 16 x 16 (or
  2 x 16 x 16) mesh (a dim sharded over axes of n devices in all keeps
  ``ceil(dim / n)``): the parameters (``abstract_params`` under
  ``param_specs``; FSDP on the dp axes where the plan says), the optimizer
  moments in the plan's dtype (train: AdamW's m and v, momentum's m,
  sharded as their parameters) and the decode state (decode:
  ``abstract_state`` under ``state_specs``). It stands in for XLA's
  ``memory_analysis``, which also counts activations and temporaries, so
  it is not a peak;
* the cost model (``cost_model``): ``matmul_flops``, the multiply-add
  FLOPs (2 a multiply-add) of the GEMMs and attention products that
  ``torch.utils.flop_counter.FlopCounterMode`` counts, for ONE data
  peer's tp group (the T tp ranks' products together: the port runs a
  tp group in one pass) on ``meta`` tensors; train counts the model's
  forward and backward passes (recomputation included) and not the
  gradient sync, prefill the prompt's forward pass, decode one step
  against the per-peer slice of the state. As in the reference, four
  shallow points (1 and 2 periods of layers x a per-device batch of 1
  and 2, dense attention: ``attn_chunk=0``) fit
  ``M(L, B) = fix_base + B tok_base + L fix_layer + L B tok_layer``
  exactly, evaluated at the production (L, B). XLA's ``flops`` also
  counts elementwise work, so the two are not the same metric; the
  reference's collective bytes come from HLO and have no counterpart
  here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out build/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.allreduce import OptiReduceConfig
from repro_torch.core.pipeline import resolve_spec
from repro_torch.launch.mesh import HostMesh, make_production_mesh
from repro_torch.models import (ParallelCtx, abstract_params, active_params,
                                count_params, decode_step, lm_loss,
                                param_specs, prefill_step)
from repro_torch.models.transformer import _period
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.serve.engine import (abstract_state, global_state,
                                      plan_serving, state_specs)
from repro_torch.train.trainer import _spec_leaves
from repro_torch.tree import tree_leaves

# Per-arch training plan: dp_mode, microbatch (per device), moments dtype
# (the reference's table, src/repro/launch/dryrun.py).
PLAN = {
    "arctic-480b":          dict(dp_mode="fsdp", microbatch=1, mom="bf16",
                                 opt="momentum", accum="bf16",
                                 serve_fsdp=True),
    "qwen2-moe-a2.7b":      dict(dp_mode="fsdp", microbatch=4, mom="f32"),
    "mamba2-1.3b":          dict(dp_mode="fsdp", microbatch=4, mom="f32"),
    "command-r-plus-104b":  dict(dp_mode="fsdp", microbatch=1, mom="bf16",
                                 accum="bf16", serve_fsdp=True),
    "stablelm-1.6b":        dict(dp_mode="fsdp", microbatch=4, mom="f32"),
    "smollm-360m":          dict(dp_mode="replicated", microbatch=8, mom="f32"),
    "glm4-9b":              dict(dp_mode="fsdp", microbatch=2, mom="f32"),
    "llava-next-mistral-7b": dict(dp_mode="fsdp", microbatch=2, mom="f32"),
    "musicgen-medium":      dict(dp_mode="fsdp", microbatch=4, mom="f32"),
    "jamba-v0.1-52b":       dict(dp_mode="fsdp", microbatch=1, mom="bf16"),
}


def _dp_axes(mesh: HostMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_total_of(mesh: HostMesh) -> int:
    return math.prod(mesh.shape[a] for a in _dp_axes(mesh))


def local_bytes(t: torch.Tensor, spec, sizes: dict[str, int]) -> int:
    """Bytes of one device's shard of ``t`` under ``spec`` (one entry a
    dim: None, an axis name, or a tuple of names)."""
    n = 1
    for dim, entry in zip(t.shape, tuple(spec) + (None,) * t.dim()):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n * t.element_size()


def tree_bytes(tree, spec_leaves: list, sizes: dict[str, int]) -> int:
    """One device's bytes of ``tree`` under the specs of its leaves (in
    tree order)."""
    leaves = tree_leaves(tree)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return sum(local_bytes(t, s, sizes) for t, s in zip(leaves, spec_leaves))


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """What the reference's ``make_train_cell`` sets up for a cell."""
    dp_mode: str
    microbatch: int | None
    tp: int
    fsdp_axes: tuple[str, ...] | None
    optimizer: OptimizerConfig
    seq_chunk: int
    remat: bool
    seq_parallel: bool


def train_plan(cfg: ModelConfig, shape: ShapeConfig, mesh: HostMesh,
               plan: dict, *, unroll: bool = False) -> TrainPlan:
    pure_dp = plan.get("pure_dp", False)
    dp_tot = dp_total_of(mesh) * (mesh.shape.get("model", 1) if pure_dp
                                  else 1)
    b_local = max(1, shape.global_batch // dp_tot)
    if plan["dp_mode"] != "fsdp":
        fsdp_axes = None
    elif pure_dp:
        fsdp_axes = ("model", "data")
    else:
        fsdp_axes = _dp_axes(mesh)
    return TrainPlan(
        dp_mode=plan["dp_mode"],
        microbatch=None if unroll else min(plan["microbatch"], b_local),
        tp=1 if pure_dp else mesh.shape["model"], fsdp_axes=fsdp_axes,
        optimizer=OptimizerConfig(
            name=plan.get("opt", "adamw"),
            state_dtype=(torch.bfloat16 if plan["mom"] == "bf16"
                         else torch.float32)),
        seq_chunk=min(plan.get("seq_chunk", 512), shape.seq_len),
        remat=plan.get("remat", True),
        seq_parallel=plan.get("seq_parallel", False))


def state_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: HostMesh,
                plan: dict) -> dict[str, int]:
    """One device's bytes of the cell's parameters, optimizer moments
    (train) and decode state (decode), from the abstract trees."""
    sizes = mesh.shape
    tp = mesh.shape["model"]
    out = {"params": 0, "opt_state": 0, "decode_state": 0}
    if shape.kind == "train":
        tpl = train_plan(cfg, shape, mesh, plan)
        params = abstract_params(cfg, tp=tpl.tp, fsdp_axes=tpl.fsdp_axes)
        specs = _spec_leaves(param_specs(cfg, tp=tpl.tp,
                                         fsdp_axes=tpl.fsdp_axes))
        out["params"] = tree_bytes(params, specs, sizes)
        opt = make_optimizer(tpl.optimizer)
        if opt.state_like_params:
            state = opt.init(params)
            moments = list(state) if isinstance(state, tuple) else [state]
            out["opt_state"] = sum(tree_bytes(m, specs, sizes)
                                   for m in moments)
    else:
        fsdp_axes = _dp_axes(mesh) if plan.get("serve_fsdp") else None
        params = abstract_params(cfg, tp=tp, fsdp_axes=fsdp_axes)
        out["params"] = tree_bytes(params, _spec_leaves(param_specs(
            cfg, tp=tp, fsdp_axes=fsdp_axes)), sizes)
        if shape.kind == "decode":
            splan = plan_serving(mesh, shape.global_batch)
            st = abstract_state(cfg, shape, splan)
            # one (KVCache | SSMState) of specs a period position
            specs = [s for pos in state_specs(cfg, splan)(st) for s in pos]
            out["decode_state"] = tree_bytes(st, specs, sizes)
    out["total"] = sum(out.values())
    return out


def _int64(batch: dict) -> dict:
    return {k: (v.long() if v.dtype == torch.int32 else v)
            for k, v in batch.items()}


def matmul_flops(cfg: ModelConfig, shape: ShapeConfig, mesh: HostMesh,
                 plan: dict) -> float:
    """The GEMM and attention FLOPs of one data peer's tp group for the
    cell ``(cfg, shape)`` (``shape.global_batch`` the global batch), on
    ``meta`` tensors."""
    kind = shape.kind
    dp = dp_total_of(mesh)
    tp = mesh.shape["model"]
    sp = False
    if kind == "train":
        tpl = train_plan(cfg, shape, mesh, plan, unroll=True)
        tp, sp = tpl.tp, tpl.seq_parallel and tpl.tp > 1
        if plan.get("pure_dp"):
            dp *= mesh.shape.get("model", 1)
    pctx = ParallelCtx(tp_axis="model" if tp > 1 else None,
                       sizes={"model": tp}, sp=sp)
    with torch.device("meta"):
        params = abstract_params(cfg, tp=tp)
        with FlopCounterMode(display=False) as counter:
            if kind == "train":
                b = max(1, shape.global_batch // dp)
                batch = _int64(input_specs(cfg, shape, batch_override=b))
                leaves = tree_leaves(params)
                for p in leaves:
                    p.requires_grad_(True)
                loss = lm_loss(params, batch, cfg, seq_chunk=tpl.seq_chunk,
                               remat=tpl.remat, pctx=pctx)
                torch.autograd.grad(loss, leaves, allow_unused=True)
            elif kind == "prefill":
                b = max(1, shape.global_batch // dp)
                batch = _int64(input_specs(cfg, shape, batch_override=b))
                prefill_step(params, batch, cfg, pctx)
            else:
                splan = plan_serving(mesh, shape.global_batch)
                # one peer's rows of the batch, or its slice of the cache
                b = shape.global_batch // (1 if splan.seq_axes else dp)
                state = global_state(cfg, batch=b,
                                     max_seq=shape.seq_len // splan.seq_shards,
                                     tp=tp, dtype=cfg.param_dtype,
                                     device="meta")
                tokens = torch.zeros((b, 1), dtype=torch.long)
                decode_step(params, state, tokens, 0, cfg, pctx)
    return float(counter.get_total_flops())


def cost_model(cfg: ModelConfig, shape: ShapeConfig, mesh: HostMesh,
               plan: dict) -> dict:
    """Fit ``M(L, B) = fix_base + B tok_base + L fix_layer + L B
    tok_layer`` to ``matmul_flops`` at four shallow points (1 and 2
    periods x a per-device batch of 1 and 2, dense attention) and evaluate
    it at the production (L, B): the reference's ``cost_model``."""
    period = _period(cfg)
    d1, d2 = period, 2 * period
    dp = dp_total_of(mesh)
    if shape.kind == "train" and plan.get("pure_dp"):
        dp *= mesh.shape.get("model", 1)     # both axes carry batch
    b1, b2 = dp, 2 * dp
    if shape.global_batch < dp:              # long_500k: B=1 global
        b1, b2 = 1, 2
    meas = {}
    for d in (d1, d2):
        for b in (b1, b2):
            c = dataclasses.replace(cfg, n_layers=d, attn_chunk=0)
            s = dataclasses.replace(shape, global_batch=b)
            meas[(d, b)] = {"matmul_flops": matmul_flops(c, s, mesh, plan)}
    out = fit_affine(meas, (d1, d2), (b1, b2), cfg.n_layers,
                     shape.global_batch)
    out["_model"] = {"depths": [d1, d2], "batches": [b1, b2],
                     "eval_at": [cfg.n_layers, shape.global_batch]}
    return out


def fit_affine(meas: dict, depths: tuple[int, int], batches: tuple[int, int],
               layers: int, batch: int) -> dict[str, float]:
    """The exact affine fit of the reference's cost model: ``meas`` maps
    each (depth, batch) of the four points to ``{metric: value}``; returns
    each metric at ``(layers, batch)``, clipped at 0."""
    (d1, d2), (b1, b2) = depths, batches
    keys = sorted({k for m in meas.values() for k in m})
    out = {}
    for k in keys:
        f = {db: meas[db].get(k, 0.0) for db in meas}
        lay_b1 = (f[(d2, b1)] - f[(d1, b1)]) / (d2 - d1)
        lay_b2 = (f[(d2, b2)] - f[(d1, b2)]) / (d2 - d1)
        tok_layer = (lay_b2 - lay_b1) / (b2 - b1)
        fix_layer = lay_b1 - b1 * tok_layer
        base_b1 = f[(d1, b1)] - d1 * lay_b1
        base_b2 = f[(d1, b2)] - d1 * lay_b2
        tok_base = (base_b2 - base_b1) / (b2 - b1)
        fix_base = base_b1 - b1 * tok_base
        val = fix_base + batch * tok_base + layers * (fix_layer
                                                      + batch * tok_layer)
        out[k] = max(val, 0.0)
    return out


def run_cell(arch: str, shape_name: str, mesh: HostMesh, *,
             strategy: str = "optireduce", drop_rate: float = 0.01,
             overrides: dict | None = None,
             with_cost_model: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    plan = dict(PLAN[arch])
    plan.update(overrides or {})
    ok, why = shape_applicable(cfg, shape)
    rec: dict = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "params": count_params(cfg), "active_params": active_params(cfg),
        "strategy": strategy, "drop_rate": drop_rate,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    t0 = time.perf_counter()
    try:
        if shape.kind == "train":
            tpl = train_plan(cfg, shape, mesh, plan)
            rec["dp_mode"] = tpl.dp_mode
            rec["microbatch"] = tpl.microbatch
        elif shape.kind == "decode":
            rec["serve_plan"] = dataclasses.asdict(
                plan_serving(mesh, shape.global_batch))
        rec["state_bytes_per_device"] = state_bytes(cfg, shape, mesh, plan)
        if with_cost_model:
            rec["cost_model"] = cost_model(cfg, shape, mesh, plan)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="optireduce")
    ap.add_argument("--drop-rate", type=float, default=0.01)
    ap.add_argument("--dp-mode", default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--seq-chunk", type=int, default=None)
    # the reference's flag sizes the sync buckets, whose collective bytes
    # only its HLO shows: refused here rather than ignored
    ap.add_argument("--bucket-elems", type=int, default=None)
    ap.add_argument("--no-cost-model", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.bucket_elems is not None:
        ap.error("--bucket-elems sizes the gradient sync's buckets, and this "
                 "dry run does not model the sync's collective bytes")

    # fail fast (with the registered-name list) before any analysis
    resolve_spec(OptiReduceConfig(strategy=args.strategy))

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    overrides = {k: getattr(args, k) for k in ("dp_mode", "microbatch",
                                               "seq_chunk")
                 if getattr(args, k) is not None}
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    results = []
    t0 = time.perf_counter()
    for arch, shape in cells:
        print(f"=== {arch} x {shape} "
              f"({'2x16x16' if args.multi_pod else '16x16'}) ===", flush=True)
        rec = run_cell(arch, shape, mesh, strategy=args.strategy,
                       drop_rate=args.drop_rate, overrides=overrides,
                       with_cost_model=not args.no_cost_model)
        results.append(rec)
        state = rec.get("state_bytes_per_device", {}).get("total")
        state_s = f" state={state / 2**30:.2f}GiB" if state else ""
        flops = rec.get("cost_model", {}).get("matmul_flops")
        fl_s = f" matmul_flops/group={flops:.3e}" if flops else ""
        print(f"  -> {rec['status']}{state_s}{fl_s} "
              f"({rec.get('seconds', 0.0):.2f}s)", flush=True)
        if rec["status"] == "error":
            print("  " + rec["error"], flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {len(results)} cells, {n_err} errors in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
