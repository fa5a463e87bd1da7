"""How far the router's AdamW first moment over tp ranks lies from the
one-process form's in bf16, and how far it would lie without the router
gradient's sum over the tp group.

Over ranks each tp rank's router gradient reaches only its own experts'
slots, and ``models/moe.py`` sums it over the tp group (``copy_tp``). In
fp32 the two forms agree to rounding (``tests/test_torch_dist_moe.py``);
in bf16 each rank's partial gradient is rounded before the sum, and the
steps after the first run on parameters that differ by that rounding. This
tool measures both on the CPU: 4 gloo ranks as ``(data 2, model 2)``
(``tools/distcheck.py``'s ``--tp-train``) and the one-process launcher,
qwen2-moe-smoke in bf16 at d 256 and d_ff 256, seq 64, global batch 8, lr
3e-4, 2 steps; with ``--no-router-sum`` the ranks skip the router's sum
(the fault the sum prevents). It prints, a step, each replicated leaf's
``max |m_rank - m_one| / max |m_one|`` (equal on every rank)::

  PYTHONPATH=src python tools/moe_router_gap.py build/router_gap
  PYTHONPATH=src python tools/moe_router_gap.py build/router_gap_nosum \\
      --no-router-sum
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

ARCH = "qwen2-moe-a2.7b"
ARGV = ["--smoke", "--device", "cpu", "--seq-len", "64", "--global-batch",
        "8", "--log-every", "1", "--lr", "3e-4", "--drop-pattern", "tail",
        "--steps", "2", "--arch", ARCH, "--dp", "2", "--tp", "2"]
REPLICATED = ("router", "ln1", "ln2", "final_ln")


def config(arch: str):
    """The smoke config in bf16, wider (d 256, d_ff 256)."""
    return dataclasses.replace(get_smoke(arch), param_dtype=torch.bfloat16,
                               d_model=256, d_ff=256)


def patch(no_router_sum: bool) -> None:
    """The launcher reads :func:`config`; with ``no_router_sum`` the
    router's ``copy_tp`` (a ``(D, E_pad)`` weight) passes its gradient
    through unsummed."""
    launch_train.get_smoke = config
    if no_router_sum:
        e_pad = config(ARCH).n_experts
        copy = parallel.ParallelCtx.copy_tp

        def copy_tp(self, x):
            if x.dim() == 2 and x.shape[-1] == e_pad:
                return x
            return copy(self, x)
        parallel.ParallelCtx.copy_tp = copy_tp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--no-router-sum", action="store_true")
    ap.add_argument("--rank", nargs=argparse.REMAINDER,
                    help="(internal) one rank: distcheck's arguments")
    args = ap.parse_args(argv)
    patch(args.no_router_sum)
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
                [sys.executable, __file__, str(out)]
                + (["--no-router-sum"] if args.no_router_sum else [])
                + ["--rank", "--device", "cpu", "--threads", "1",
                   "--tp-train", json.dumps({"name": "ranks", "argv": ARGV,
                                             "save": True})],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    torch.set_num_threads(1)
    # the one-process form: every expert's slots in one product (its
    # copy_tp is the identity, patched or not)
    one = distcheck.tp_train({"name": "one", "argv": ARGV, "save": True})
    for r, p in enumerate(procs):
        if p.wait() != 0:
            raise RuntimeError((out / f"rank{r}.log").read_text()[-3000:])
    names = [n for n, _ in _walk(param_table(config(ARCH), tp=2))]
    n = len(names)
    ranks = [torch.load(out / f"ranks.rank{r}.pt") for r in range(4)]
    for step in range(2):
        row = {"step": step}
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
