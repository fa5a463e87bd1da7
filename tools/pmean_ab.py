"""Time ``collectives.pmean``'s sum in peer order against one library sum
over the peer dim, on the paths that call ``pmean``, in one process on one
NVIDIA GPU.

``pmean`` adds the peers' rows one at a time, in index order
(``collectives._sum_in_order``), so its bits do not depend on the row width
and the batched sync (``mode="vmap"``) matches ``scan``. Before, it took one
``sum`` over the peer dim. This script swaps the two forms of that sum in
turns (library, in order, in order, library) on the same inputs, on each
path that reaches ``pmean``, and counts the sums a sync or a step makes:

- ``psum`` (one ``pmean`` a bucket) on 4 peers, and ``gloo_ring``,
  ``bcube`` and ``optireduce_q`` on 2 pods of 4 (the pod axis's mean
  after the data axis's reduction), scan mode, on the strategies'
  full-width arena (24 buckets of 6,553,600 fp32 a peer), drops 0.01 tail
  where the strategy has them; ``optireduce_2d`` on the 2 pods too (its
  pod axis runs a TAR, so it counts no sum);
- the ``pod_q`` and ``pod_main`` training steps: gpt2-paper at full width
  on the (4, 2) grid under ``pure_dp``, ``optireduce_q`` and
  ``optireduce_2d``, 3 steps each turn.

A sync's time is the CUDA events' ms around one ``sync_packed`` call and
its host ms; a step's, its host ms (the step ends on a host read of its
metrics). Prints one JSON line a measurement and a ``{"pmean_ab": ...}``
summary with each form's times side by side. Exits 1 without a GPU or
when the two forms' results differ beyond fp32 reordering.

    python3 tools/pmean_ab.py [--reps N]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PEERS, BUCKETS, BUCKET, BLOCK = 4, 24, 6_553_600, 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def library_sum(x, dim: int):
    """The sum before: one library reduction over the peer dim."""
    return x.sum(dim=dim, keepdim=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pmean_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import collectives
    from repro_torch.core.allreduce import OptiReduceConfig, sync_packed
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import SyncContext, ThreefryDraws
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    forms = {"library": library_sum,
             "in_order": collectives._sum_in_order}
    order = ("library", "in_order", "in_order", "library")
    gen = torch.Generator(device=dev).manual_seed(5)
    results: dict = {}
    sums = [0]

    def use(form):
        def counted(x, dim):
            sums[0] += 1
            return forms[form](x, dim)
        collectives._sum_in_order = counted

    def sync_case(name, cfg, grid, peers):
        arena = torch.empty((peers, BUCKETS, BUCKET), device=dev)
        for p in range(peers):
            arena[p].normal_(generator=gen).mul_(1.0 + 0.25 * p)
        outs = {}
        for form in order:
            use(form)
            for _ in range(args.reps):
                ctx = SyncContext(cfg=cfg, grid=grid, draws=ThreefryDraws(
                    fold_in(key(0), 7), cfg, dev))
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                sums[0] = 0
                t0 = time.perf_counter()
                start.record()
                out = sync_packed(arena, ctx, mode="scan")
                end.record()
                torch.cuda.synchronize()
                host = (time.perf_counter() - t0) * 1e3
                row = {"case": name, "form": form, "sums": sums[0],
                       "device_ms": start.elapsed_time(end), "host_ms": host}
                emit(row)
                case = results.setdefault(name, {"sums": sums[0]})
                case.setdefault(form, []).append([row["device_ms"], host])
                outs.setdefault(form, out)
                del out
        a, b = outs["library"], outs["in_order"]
        gap = float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
        results[name]["max_rel_gap"] = gap
        del arena, outs, a, b
        torch.cuda.empty_cache()
        return gap <= 1e-5

    def lossy(strategy, **kw):
        return OptiReduceConfig(strategy=strategy, drop_rate=0.01,
                                drop_pattern="tail", hadamard_block=BLOCK,
                                **kw)

    pods = collectives.Grid(pods=2)
    ok = sync_case("psum", OptiReduceConfig(strategy="psum"),
                   collectives.ONE, PEERS)
    for strategy in ("gloo_ring", "bcube"):
        ok &= sync_case(f"{strategy}_pods", OptiReduceConfig(
            strategy=strategy, hadamard_block=BLOCK, pod_axis="pod"), pods,
            2 * PEERS)
    for strategy in ("optireduce_q", "optireduce_2d"):
        ok &= sync_case(f"{strategy}_pods", lossy(strategy, pod_axis="pod"),
                        pods, 2 * PEERS)

    # pod_q and pod_main: the training steps on the (4, 2) grid
    cfg = get_config("gpt2-paper")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    base = init_params(key(0), cfg, device=dev)
    for name, strategy in (("pod_q_step", "optireduce_q"),
                           ("pod_main_step", "optireduce_2d")):
        tc = TrainConfig(sync=lossy(strategy), seq_chunk=128,
                         kernel_mode="kernel", pure_dp=True)
        step_fn, opt = build_train_step(cfg, tc, make_host_mesh(PEERS, 2),
                                        device=dev)
        for form in order:
            use(form)
            params = tree_map(lambda p: p.clone(), base)
            state = opt.init(params)
            for s in range(3):
                torch.cuda.synchronize()
                sums[0] = 0
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state,
                                           data.host_batch(s, 0, 1), s,
                                           key(0))
                loss = float(m["loss"])
                host = (time.perf_counter() - t0) * 1e3
                emit({"case": name, "form": form, "step": s, "loss": loss,
                      "sums": sums[0], "host_ms": host})
                case = results.setdefault(name, {"sums": sums[0]})
                case.setdefault(form, []).append(host)
            del params, state
            torch.cuda.empty_cache()
    collectives._sum_in_order = forms["in_order"]
    emit({"pmean_ab": results})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
