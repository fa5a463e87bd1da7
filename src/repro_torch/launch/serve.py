"""Serving launcher: batched greedy decoding of random-weight models.

Counterpart of ``src/repro/launch/serve.py``, with the reference's flags
and its two output lines, plus ``--device``: the CUDA device unless asked
otherwise, raising where there is none (no CPU fallback). The weights and
the prompts are random, made from ``--seed``. It runs as one process:
under ``torchrun`` (``WORLD_SIZE`` set) it raises, serving over ranks
being a later slice of ROADMAP A18c. Example:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-paper \\
      --batch 128 --prompt-len 896 --max-new 128
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --batch 2 --prompt-len 4 --max-new 4
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.keys import key, randint
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        raise ValueError("serving over ranks (torchrun) is a later slice of "
                         "ROADMAP A18c: run launch/serve.py as one process")

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    k = key(args.seed)
    params = init_params(k, cfg, device=device)
    prompts = torch.from_numpy(randint(k, (args.batch, args.prompt_len), 0,
                                       cfg.vocab_size)).to(device)
    t0 = time.time()
    out = generate(params, cfg, prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    print("sample:", out[0, -args.max_new:].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
