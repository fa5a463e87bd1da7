"""How well conditioned the first gradient of a random-init Mamba-2 is, and
whether tensor parallelism moves it by more than rounding.

    PYTHONPATH=src python3 tools/mamba2_conditioning.py [--device cpu]
        [--d-model 512] [--layers 4] [--vocab 4096]

mamba2-1.3b's config with ``d_model``, ``ssm_heads`` (``2 d_model / 64``,
the published head dim), ``n_layers`` and the vocabulary cut as given.
Prints one JSON line a measurement:

* ``launcher``: one step of ``repro_torch.launch.train`` (``--dp 2``, seq
  128, global batch 8, AdamW, no drops) at ``--tp 1`` and ``--tp 2``, in
  bf16, fp32 and fp64: the first loss and grad norm of each, and the two
  tp degrees' relative gaps (rounding's share shrinks with the dtype's
  unit roundoff);
* ``perturbation``: ``lm_loss``'s gradient on the launcher's first batch
  (its first data peer's 4 rows) in fp32 at tp 1, against the same after
  every weight is scaled by ``1 + eps * N(0, 1)`` (eps 1e-4, 1e-3, 4e-3):
  the global norms and the embedding gradient's largest change over its
  largest magnitude. A well-conditioned gradient moves by about eps; bf16
  rounds each weight by up to 2^-9 (~2e-3).

Runs in a minute or two on the CPU at the defaults.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core.keys import key
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import ParallelCtx, init_params, lm_loss
from repro_torch.tree import tree_leaves

SEQ, BATCH = 128, 8


def _cfg(args, dtype):
    return dataclasses.replace(
        get_config("mamba2-1.3b"), n_layers=args.layers,
        d_model=args.d_model, ssm_heads=2 * args.d_model // 64,
        vocab_size=args.vocab, param_dtype=dtype)


def launcher_gaps(args) -> None:
    full = launch_train.get_config
    try:
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32),
                            ("fp64", torch.float64)):
            cfg = _cfg(args, dtype)
            launch_train.get_config = lambda _: cfg
            rec = {}
            for tp in (1, 2):
                rec[tp] = launch_train.run(
                    ["--arch", "mamba2-1.3b", "--dp", "2", "--tp", str(tp),
                     "--drop-rate", "0", "--seq-len", str(SEQ),
                     "--global-batch", str(BATCH), "--optimizer", "adamw",
                     "--device", args.device, "--steps", "1"])[0]
            print(json.dumps({
                "measure": "launcher", "dtype": name,
                "loss": [rec[1]["loss"], rec[2]["loss"]],
                "grad_norm": [rec[1]["grad_norm"], rec[2]["grad_norm"]],
                "loss_rel_gap": abs(rec[2]["loss"] - rec[1]["loss"])
                / abs(rec[1]["loss"]),
                "grad_norm_rel_gap": abs(rec[2]["grad_norm"]
                                         - rec[1]["grad_norm"])
                / rec[1]["grad_norm"]}), flush=True)
    finally:
        launch_train.get_config = full


def perturbation(args) -> None:
    cfg = _cfg(args, torch.float32)
    dev = torch.device(args.device)
    params = init_params(key(0), cfg, device=dev, tp=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    batch = {k: torch.as_tensor(v[:BATCH // 2]).to(dev)
             for k, v in data.host_batch(0, 0, 1).items()}
    leaves = tree_leaves(params)

    def grads():
        for p in leaves:
            p.requires_grad_(True)
        loss = lm_loss(params, batch, cfg,
                       pctx=ParallelCtx(tp_axis="model", sizes={"model": 1}))
        return [g.double() for g in torch.autograd.grad(loss, leaves)]

    def norm(gs):
        return float(torch.sqrt(sum((g * g).sum() for g in gs)))

    base = grads()
    for eps in (1e-4, 1e-3, 4e-3):
        saved = [p.detach().clone() for p in leaves]
        noise = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            for p in leaves:
                p.mul_(1 + eps * torch.randn(p.shape, generator=noise,
                                             device=dev, dtype=p.dtype))
        moved = grads()
        with torch.no_grad():
            for p, s in zip(leaves, saved):
                p.copy_(s)
        print(json.dumps({
            "measure": "perturbation", "eps": eps,
            "grad_norm": [norm(base), norm(moved)],
            "embed_grad_rel_change": float(
                (moved[0] - base[0]).abs().max() / base[0].abs().max())}),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    args = ap.parse_args(argv)
    launcher_gaps(args)
    perturbation(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
