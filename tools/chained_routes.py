"""Where a chained MoE training step on the card leaves the CPU's: the
expert routes of each step, card against CPU, on one NVIDIA GPU.

``chip_smoke.py``'s ``tp_families_check_tp4`` (qwen2-moe-smoke at data 2 x
model 4, ``optireduce``, tail drops 0.05, AdamW lr 1e-2) runs 2 steps on
the card from its own state against 2 on the CPU. This script runs the
same case and records every call of ``models.moe.route`` (the forward
passes and their recomputes), then compares the card's routes with the
CPU's call by call: the (token, slot) assignments whose expert differs,
those whose capacity keep flag differs, and, where an expert differs, the
CPU's margin between the last chosen and the first unchosen logit. With
``--restart`` the card's step 1 starts from the CPU's state after step 0
instead.

    python3 tools/chained_routes.py [--restart]

Prints one JSON line a step and exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--restart", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chained_routes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import _HostDraws
    from repro_torch.configs import get_smoke
    from repro_torch.core.allreduce import OptiReduceConfig
    from repro_torch.core.keys import fold_in, key
    from repro_torch.core.pipeline import ThreefryDraws
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, moe
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, build_train_step
    from repro_torch.tree import tree_map

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    cfg = get_smoke("qwen2-moe-a2.7b")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, seed=0))
    k = key(0)
    mesh = (2, 4)
    sync = OptiReduceConfig(strategy="optireduce", drop_rate=0.05,
                            drop_pattern="tail", hadamard_block=256,
                            skip_threshold=0.9)
    tc = TrainConfig(sync=sync, optimizer=OptimizerConfig(lr=1e-2),
                     bucket_elems=16_384, seq_chunk=32)
    base = init_params(k, cfg, device="cpu", tp=mesh[1])
    calls: list = []
    real_route = moe.route

    def recorded(*a, **kw):
        r = real_route(*a, **kw)
        calls.append((r.logits.detach().float().cpu(),
                      r.gate_idx.detach().cpu(), r.keep.detach().cpu()))
        return r
    moe.route = recorded
    runs = {}
    for name, device in (("cpu", cpu), ("cuda", dev)):
        fn, opt = build_train_step(cfg, tc, make_host_mesh(*mesh),
                                   device=device)
        params = tree_map(lambda p: p.clone().to(device), base)
        runs[name] = [fn, [params, opt.init(params)], []]
    for step in range(2):
        if args.restart and step:
            runs["cuda"][1] = [tree_map(lambda p: p.detach().clone().to(dev),
                                        t) for t in runs["cpu"][1]]
        for name, device in (("cpu", cpu), ("cuda", dev)):
            fn, state, rec = runs[name]
            skey = fold_in(k, step)
            calls.clear()
            p, s, m = fn(state[0], state[1], data.host_batch(step, 0, 1),
                         step, k,
                         draws=_HostDraws(ThreefryDraws(
                             key=fold_in(skey, 7), cfg=sync, device=cpu),
                             device),
                         site_draws=_HostDraws(ThreefryDraws(
                             key=skey, cfg=sync, device=cpu), device))
            runs[name][1] = [p, s]
            rec.append((list(calls), float(m["loss"])))
        (c_calls, c_loss), (g_calls, g_loss) = (runs["cpu"][2][step],
                                                runs["cuda"][2][step])
        expert = kept = slots = 0
        margins = []
        for (lc, ic, kc), (_, ig, kg) in zip(c_calls, g_calls):
            slots += ic.numel()
            diff = ic != ig
            expert += int(diff.sum())
            kept += int((kc != kg).sum())
            if diff.any():
                top = torch.topk(lc, ic.shape[-1] + 1, dim=-1).values
                gap = top[..., -2] - top[..., -1]
                margins += gap[diff.any(dim=-1)].tolist()
        print(json.dumps({"step": step, "restart": args.restart,
                          "route_calls": [len(c_calls), len(g_calls)],
                          "slots": slots, "expert_differs": expert,
                          "keep_differs": kept,
                          "cpu_margin_where_differs": sorted(margins)[:8],
                          "loss_cpu": c_loss, "loss_card": g_loss}),
              flush=True)
    moe.route = real_route
    return 0


if __name__ == "__main__":
    sys.exit(main())
