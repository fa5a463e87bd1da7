"""How far the AdamW first moments of the weights replicated over tp whose
gradient is summed over the tp group (the MoE's router, Mamba-2's ``wB``
and ``wC``, the norms under sequence parallelism) lie over tp ranks from
the one-process form's in bf16, and how far they would lie without that
sum.

Over ranks each tp rank's router gradient reaches only its own experts'
slots (``models/moe.py``), its ``wB`` / ``wC`` gradient only its own
SSM heads (``models/ssm.py``), and under ``--seq-parallel`` its norms'
gradient only its own sequence slice (llava-next-mistral-7b, with its
prefix: ``models/transformer.py``); each sums it over the tp group
(``copy_tp``, ``copy_seq``). In fp32 the two forms agree to rounding
(``tests/test_torch_dist_moe.py``, ``tests/test_torch_dist_ssm.py``); in
bf16 each rank's partial gradient is rounded before the sum, and the steps
after the first run on parameters that differ by that rounding. This tool
measures both on the CPU: 4 gloo ranks as ``(data 2, model 2)``
(``tools/distcheck.py``'s ``--tp-train``) and the one-process launcher,
the ``--arch`` smoke config in bf16 at d 256 (qwen2-moe-smoke's d_ff 256
too), seq 64, global batch 8, lr 3e-4, 2 steps (``--layers`` sets the
depth); with ``--no-sum`` the ranks skip those weights' sum (the fault
it prevents). It prints, a step, the
grad norm's ``|norm_rank - norm_one| / norm_one`` and each replicated
leaf's ``max |m_rank - m_one| / max |m_one|`` (equal on every rank)::

  PYTHONPATH=src python tools/tp_sum_gap.py build/router_gap
  PYTHONPATH=src python tools/tp_sum_gap.py build/router_gap_nosum \\
      --no-sum
  PYTHONPATH=src python tools/tp_sum_gap.py build/bc_gap --arch mamba2-1.3b
  PYTHONPATH=src python tools/tp_sum_gap.py build/bc_gap12 --arch \\
      mamba2-1.3b --layers 12
  PYTHONPATH=src python tools/tp_sum_gap.py build/sp_gap --arch \\
      llava-next-mistral-7b [--no-sum]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import distcheck  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import parallel  # noqa: E402
from repro_torch.models.transformer import _walk, param_table  # noqa: E402

ARGV = ["--smoke", "--device", "cpu", "--seq-len", "64", "--global-batch",
        "8", "--log-every", "1", "--lr", "3e-4", "--drop-pattern", "tail",
        "--steps", "2", "--dp", "2", "--tp", "2"]
# the leaves replicated over tp, by family
REPLICATED = ("router", "wB", "wC", "frontend_proj", "ln1", "ln2",
              "final_ln")
# the frontend arch trains with its prefix under sequence parallelism
FRONTEND = "llava-next-mistral-7b"
SP_FLAGS = ["--seq-parallel", "--prefix"]


def config(arch: str, layers: int | None = None):
    """The smoke config in bf16, wider (d 256; d_ff 256 where it has an
    MLP), at ``layers`` layers (the smoke config's)."""
    cfg = get_smoke(arch)
    return dataclasses.replace(cfg, param_dtype=torch.bfloat16, d_model=256,
                               d_ff=256 if cfg.d_ff else 0,
                               n_layers=layers or cfg.n_layers)


def patch(arch: str, no_sum: bool, layers: int | None) -> None:
    """The launcher reads :func:`config`; with ``no_sum`` the ``copy_tp``
    of a weight summed over tp (the router's ``(D, E_pad)``, ``wB``'s and
    ``wC``'s ``(D, N)``) passes its gradient through unsummed, and so does
    the norms' ``copy_seq`` under sequence parallelism."""
    launch_train.get_smoke = lambda name: config(name, layers)
    if no_sum and arch == FRONTEND:
        parallel.ParallelCtx.copy_seq = lambda self, w: w
    elif no_sum:
        cfg = config(arch)
        width = cfg.n_experts or cfg.ssm_state
        copy = parallel.ParallelCtx.copy_tp

        def copy_tp(self, x):
            if x.dim() == 2 and x.shape == (cfg.d_model, width):
                return x
            return copy(self, x)
        parallel.ParallelCtx.copy_tp = copy_tp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--arch", default="qwen2-moe-a2.7b",
                    choices=("qwen2-moe-a2.7b", "mamba2-1.3b", FRONTEND))
    ap.add_argument("--no-sum", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--rank", nargs=argparse.REMAINDER,
                    help="(internal) one rank: distcheck's arguments")
    args = ap.parse_args(argv)
    patch(args.arch, args.no_sum, args.layers)
    run_argv = ARGV + ["--arch", args.arch] + (
        SP_FLAGS if args.arch == FRONTEND else [])
    if args.rank is not None:
        return distcheck.main([args.out] + args.rank)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    port = distcheck.free_port()
    procs = []
    for r in range(4):
        env = {**os.environ, "WORLD_SIZE": "4", "RANK": str(r),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port),
               "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                              os.environ.get("PYTHONPATH",
                                                             "")])}
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(out), "--arch", args.arch]
                + (["--layers", str(args.layers)] if args.layers else [])
                + (["--no-sum"] if args.no_sum else [])
                + ["--rank", "--device", "cpu", "--threads", "1",
                   "--tp-train", json.dumps({"name": "ranks",
                                             "argv": run_argv,
                                             "save": True})],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    torch.set_num_threads(1)
    # the one-process form: every expert's slots, every head, in one
    # product (its copy_tp is the identity, patched or not)
    one = distcheck.tp_train({"name": "one", "argv": run_argv,
                              "save": True})
    for r, p in enumerate(procs):
        if p.wait() != 0:
            raise RuntimeError((out / f"rank{r}.log").read_text()[-3000:])
    names = [n for n, _ in _walk(param_table(config(args.arch,
                                                    args.layers), tp=2))]
    n = len(names)
    ranks = [torch.load(out / f"ranks.rank{r}.pt") for r in range(4)]
    got = json.loads((out / "rank0.json").read_text())["train"]["ranks"]
    for step in range(2):
        norms = (got["records"][step]["grad_norm"],
                 one["records"][step]["grad_norm"])
        row = {"step": step,
               "grad_norm": abs(norms[0] - norms[1]) / norms[1]}
        for j, name in enumerate(names):
            if name not in REPLICATED:
                continue
            want = one["leaves"][step][n + j].float()
            gaps = {float((rk[step][n + j].float() - want).abs().max()
                          / want.abs().max()) for rk in ranks}
            row[name] = sorted(gaps)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
