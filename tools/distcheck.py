"""Hold the process-group form of the peer grid against the stacked form.

One process a rank, started by ``torchrun`` or by :func:`start` (which
sets torchrun's environment: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``):

  PYTHONPATH=src torchrun --nproc-per-node 4 tools/distcheck.py \\
      build/distcheck --device cpu --arena 3,6000 --block 256

Each rank runs on ``cuda:(LOCAL_RANK % device_count())`` unless
``--device cpu`` (no card raises), joins the default process group
(``--backend``: nccl on the card, gloo on the CPU) and writes
``OUT/rank<r>.json`` (:func:`start` sends its output to
``OUT/rank<r>.log``):

- ``train``: for each ``--train`` JSON ``{"name": ..., "argv": [...]}``,
  the training launcher's records (``launch/train.run``), each step's
  digest of the parameters (with ``"state": true`` in the JSON, of the
  parameters and the optimizer state), the bytes of the parameters and
  optimizer state the rank holds, and each step's launches and start on
  the wall clock (:func:`watch_steps`; on the card the peak-memory counter
  is reset before each run); ``--save-params`` names runs whose last
  parameters rank 0 saves to ``OUT/<name>.pt``. With ``--wait-for PATH``
  each run's first step ends by waiting for the card, writing
  ``PATH.ready<r>`` and waiting until ``PATH`` exists (the time is
  ``wait_s``, inside the first step's ``step_s``), so a caller can run
  other work on the card during the ranks' start-up and cold first step
  and keep it out of the later steps (:func:`await_ready`). The launcher
  runs come first.
- ``sync``: its row of a seeded ``(P, B, E)`` arena (:func:`peer_rows`:
  row p drawn from the seed ``p`` on the rank's device)
  through every registered strategy in ``scan`` and ``pipelined`` (tail
  drops at ``--rate`` where the strategy's transport is lossy), the
  participation policies of :data:`POLICIES` on the small arena, ``pmax``
  over a row holding a NaN and a ``ppermute`` that names only some
  destinations: a case's SHA-256 of the result's bytes, its loss fraction,
  its ``permutes``, its kernel launches, the bytes the rank sent through
  the group and the host seconds in its calls (``OUT/rank<r>.npz`` keeps the
  results of up to 2^20 elements). ``--full B,E`` adds
  :data:`FULL_STRATEGIES` on a second, full-size arena, in ``pipelined``
  mode, digests only. ``--rs R,C`` adds the FSDP reduce-scatter of a
  seeded ``(P, R, C)`` bf16 gradient along dim 1 (the embedding's fsdp
  dim), plain and with the 8-bit wire (:func:`rs_cases`): each rank's
  reduced shard.

:func:`sync_cases`, :func:`rs_cases` and :func:`watch_steps` on the
stacked grid give the other side (``watch_steps(shards=)`` digests each
rank's slice of the stacked form's state, ``train/elastic.py``'s);
:func:`tree_digest` and :func:`digest` compare them.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import collectives, keys  # noqa: E402
from repro_torch.core.allreduce import rs_spec, sync_packed  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    Lossy, OptiReduceConfig, SyncContext, ThreefryDraws, resolve_spec,
    strategy_names)
from repro_torch.kernels.dequant_reduce import ops as dq_ops  # noqa: E402
from repro_torch.kernels.fwht import ops as fwht_ops  # noqa: E402
from repro_torch.kernels.ht_quant import ops as hq_ops  # noqa: E402
from repro_torch.kernels.masked_sum import ops as mm_ops  # noqa: E402
from repro_torch.kernels.quant import ops as gq_ops  # noqa: E402
from repro_torch.kernels.runtime import resolve_device  # noqa: E402
from repro_torch.kernels.threefry import ops as tf_ops  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

KERNELS = {"fwht": (fwht_ops, "launches"), "masked_mean": (mm_ops, "launches"),
           "ht_amax": (hq_ops, "amax_launches"),
           "ht_quant": (hq_ops, "quant_launches"),
           "dequant_mean": (dq_ops, "launches"),
           "grid_quant": (gq_ops, "launches"),
           "threefry": (tf_ops, "launches"),
           "permutes": (collectives, "permutes")}
MODES = ("scan", "pipelined")
# degraded participation, straggler-proportional shards and a dead link
POLICIES = (("optireduce", {"active_peers": (0, 1, 3)}, "scan"),
            ("optireduce_rounds", {"active_peers": (0, 1, 3)}, "pipelined"),
            ("tar_rounds_q", {"active_peers": (0, 1, 3)}, "scan"),
            ("ring_ht", {"active_peers": (0, 1, 3)}, "scan"),
            ("gloo_ring", {"active_peers": (0, 2, 3)}, "pipelined"),
            ("tar_rounds", {"shard_weights": (2, 2, 2, 1)}, "scan"),
            ("optireduce_rounds", {"shard_weights": (2, 2, 2, 1)}, "scan"),
            ("gloo_ring", {"shard_weights": (2, 2, 2, 1)}, "scan"),
            ("optireduce_rounds", {"dead_links": ((1, 2),)}, "pipelined"))
SMALL = 1 << 20                 # results up to this many elements are kept
FULL_STRATEGIES = ("optireduce", "optireduce_q")   # on the full arena


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its dtype's, row-major)."""
    t = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(t.cpu().numpy().data).hexdigest()


def tree_digest(tree) -> str:
    """SHA-256 over a tree's leaves' bytes, in tree order."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(digest(leaf).encode())
    return h.hexdigest()


def counts() -> dict[str, int]:
    return {k: getattr(mod, attr) for k, (mod, attr) in KERNELS.items()}


def peer_rows(rows, buckets: int, elems: int, seed: int,
              device) -> torch.Tensor:
    """``(len(rows), B, E)`` fp32: row p of the seeded arena is standard
    normal from the seed ``seed * 1009 + p``, drawn on ``device``."""
    out = []
    for p in rows:
        gen = torch.Generator(device=device).manual_seed(seed * 1009 + p)
        out.append(torch.randn((buckets, elems), generator=gen,
                               device=device))
    return torch.stack(out)


def cases(strategies=None, policies: bool = True, modes=MODES):
    """``(name, strategy, policy kwargs, mode)`` of every sync case."""
    for s in strategies or strategy_names():
        for mode in modes:
            yield f"{s}/{mode}", s, {}, mode
    if policies:
        for s, kw, mode in POLICIES:
            name = ",".join(f"{k}={v}" for k, v in kw.items())
            yield f"{s}/{mode}/{name}", s, kw, mode


def sync_cases(x: torch.Tensor, grid: collectives.Grid, *, rate: float,
               block: int, packet: int, strategies=None,
               policies: bool = True, modes=MODES):
    """Yield ``(name, synced stack, loss fraction, launches)`` of each case
    on the ``(P, B, E)`` stack ``x`` over ``grid`` (the draws keyed on
    ``key(5)``)."""
    for name, strategy, kw, mode in cases(strategies, policies, modes):
        cfg = OptiReduceConfig(strategy=strategy, hadamard_block=block,
                               packet_elems=packet, incast=2, **kw)
        lossy = (isinstance(resolve_spec(cfg).transport, Lossy)
                 and "shard_weights" not in kw)
        cfg = OptiReduceConfig(strategy=strategy, hadamard_block=block,
                               packet_elems=packet, incast=2,
                               drop_rate=rate if lossy else 0.0, **kw)
        ctx = SyncContext(cfg=cfg, draws=ThreefryDraws(keys.key(5), cfg,
                                                       x.device), grid=grid)
        before = counts()
        y = sync_packed(x, ctx, mode=mode)
        frac = float(ctx.loss_fraction())
        after = counts()
        yield name, y, frac, {k: after[k] - before[k] for k in after}


RS_BITS = (("rs/optireduce", 0), ("rs/rs_wire_bits=8", 8))


def rs_cases(x: torch.Tensor, grid: collectives.Grid, *, rate: float,
             block: int, packet: int):
    """Yield ``(name, reduced shards, loss fraction, launches)`` of the
    FSDP reduce-scatter (``rs_spec``: TAR stage 1 with tail drops at
    ``rate``) of ``x`` in bf16, the trainer's gradient dtype, along dim 1
    of each peer's tensor, once per entry of :data:`RS_BITS` (the draws
    keyed on ``key(5)``, the site ``()``)."""
    g = x.to(torch.bfloat16)
    for name, bits in RS_BITS:
        cfg = OptiReduceConfig(strategy="optireduce", hadamard_block=block,
                               packet_elems=packet, drop_rate=rate,
                               rs_wire_bits=bits)
        ctx = SyncContext(cfg=cfg, draws=ThreefryDraws(keys.key(5), cfg,
                                                       x.device),
                          bucket=(), grid=grid)
        before = counts()
        y = rs_spec(cfg).reduce_scatter(g, collectives.DATA, 1, ctx)
        frac = float(ctx.loss_fraction())
        after = counts()
        yield name, y, frac, {k: after[k] - before[k] for k in after}


def permute_pairs(n: int) -> list[tuple[int, int]]:
    """A ``ppermute`` that leaves some peers without a source (and, past 2
    peers, holds a self pair)."""
    return [(0, n - 1)] + ([(n - 1, 1), (2, 2)] if n > 2 else [])


def primitive_cases(x: torch.Tensor, grid: collectives.Grid):
    """Yield ``(name, result)``: ``pmax`` of the first 64 entries of
    bucket 0 with peer 1's entry 3 made NaN (every peer must hold NaN
    there), and a ``ppermute`` of them by :func:`permute_pairs`."""
    n = collectives.axis_size(x, grid)
    v = x[:, 0, :64].clone()
    rows = collectives.per_peer(tuple(range(n)), x.device, grid)
    v[rows == 1, 3] = float("nan")
    yield "pmax_nan", collectives.pmax(v, grid)
    yield "ppermute_partial", collectives.ppermute(v, permute_pairs(n), grid)


def state_bytes(tree) -> int:
    """Bytes of the distinct storages a tree's tensors live in: what a
    rank holds of it, views counted once and whole."""
    storages = {}
    for t in tree_leaves(tree):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


@contextlib.contextmanager
def watch_steps(keep: bool = False, wait_for: str | None = None, *,
                state: bool = False, shards: int | None = None,
                steps: int | None = None):
    """Wrap the training launcher's ``build_train_step``: after each step a
    copy of the parameters (with ``state``, and of the optimizer state) on
    their device (a copy only, so the launcher's step time barely moves),
    the bytes of parameters and optimizer state held
    (:func:`state_bytes`) in ``seen["state_bytes"]``, each step's kernel
    launches and permutes (:func:`counts`) in ``seen["launches"]``, and
    each step's start on the wall clock in ``seen["starts"]``; on leaving,
    each step's
    digest goes into ``seen["digests"]``, with ``state`` the digest of the
    leaves FSDP replicates into ``seen["replicated"]``, and, when
    ``keep``, the last step's copy (on the host) into ``seen["params"]``.
    With ``shards=n`` a step's digest is instead the list of the n
    workers' digests of their FSDP slices (``elastic.split_leaf``): what
    rank r of the one-rank-a-peer form must hold. ``steps`` copies only
    the first so many steps. With ``wait_for``, the first step
    ends by waiting for the card to finish it, writing
    :func:`ready_path` and waiting until ``wait_for`` exists (both waits
    are ``seen["wait_s"]``)."""
    from repro_torch.launch import train as launch_train
    seen = {"digests": [], "params": None, "starts": [], "wait_s": 0.0,
            "state_bytes": [], "replicated": [], "launches": []}
    copies = []
    dims = []
    inner = launch_train.build_train_step

    def build(*args, **kw):
        step_fn, opt = inner(*args, **kw)

        def watched(*a, **k):
            seen["starts"].append(time.time())
            before = counts()
            out = step_fn(*a, **k)
            after = counts()
            seen["launches"].append({n: after[n] - before[n] for n in after})
            seen["state_bytes"].append(state_bytes((out[0], out[1])))
            if (state or shards) and not dims:
                cfg = args[0]           # build_train_step(cfg, tc, ...)
                dims.extend(elastic.fsdp_dims(cfg) + (elastic.state_dims(
                    cfg, out[1], opt.state_like_params) if state else []))
            if wait_for and len(copies) == 0:
                t0 = time.perf_counter()
                leaf = tree_leaves(out[0])[0]
                if leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                Path(ready_path(wait_for, int(os.environ.get("RANK", 0)))
                     ).touch()
                while not os.path.exists(wait_for):
                    time.sleep(0.05)
                seen["wait_s"] = time.perf_counter() - t0
            if steps is None or len(copies) < steps:
                copies.append([p.detach().clone() for p in tree_leaves(
                    (out[0], out[1]) if state else out[0])])
            return out
        return watched, opt

    launch_train.build_train_step = build
    try:
        yield seen
    finally:
        launch_train.build_train_step = inner
        if shards is None:
            seen["digests"] = [tree_digest(c) for c in copies]
        else:
            seen["digests"] = [
                [tree_digest([elastic.split_leaf(leaf, d, shards)[r]
                              for leaf, d in zip(c, dims)])
                 for r in range(shards)] for c in copies]
        if state:
            seen["replicated"] = [
                tree_digest([leaf for leaf, d in zip(c, dims) if d is None])
                for c in copies]
        if keep and copies:
            seen["params"] = [p.cpu() for p in copies[-1]]
        copies.clear()


def ready_path(wait_for, rank: int) -> str:
    """The file rank ``rank`` writes when its first step is done on the
    card and it waits for ``wait_for``."""
    return f"{wait_for}.ready{rank}"


def await_ready(procs, wait_for, *, timeout: float = 600.0) -> None:
    """Wait until every rank of :func:`start` waits for ``wait_for``
    (:func:`ready_path`); raises if one exits first or the wait outlasts
    ``timeout``."""
    t0 = time.perf_counter()
    while not all(os.path.exists(ready_path(wait_for, r))
                  for r in range(len(procs))):
        if any(p.poll() is not None for p in procs):
            raise RuntimeError("distcheck: a rank exited before its first "
                               "step was done")
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"distcheck: ranks not ready in {timeout} s")
        time.sleep(0.05)


def arenas(args) -> list:
    """``(case prefix, (B, E), strategies, small)`` of each arena asked
    for: the small one through every case, the full one (``full:``)
    through :data:`FULL_STRATEGIES` in ``pipelined`` mode."""
    out = []
    if args.arena:
        out.append(("", args.arena, None, True))
    if args.full:
        out.append(("full:", args.full, FULL_STRATEGIES, False))
    return out


def _pair(text: str) -> tuple[int, int]:
    b, e = (int(v) for v in text.split(","))
    return b, e


def run(args, device) -> None:
    """Join the default group over ``--backend``, run the ``--train``
    launcher runs and the arenas' sync cases, leave the group, and write
    ``OUT/rank<r>.json`` (and ``.npz``)."""
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    grid = collectives.rank_grid()
    out_dir = Path(args.out)
    report = {"rank": rank, "world": world, "backend": backend,
              "device": str(device), "sync": {}, "train": {}}
    arrays = {}
    try:
        for spec in args.train:
            job = json.loads(spec)
            keep = job["name"] in args.save_params
            if device.type == "cuda":       # each run's own peak
                torch.cuda.reset_peak_memory_stats(device)
            before = counts()
            with watch_steps(keep, args.wait_for,
                             state=job.get("state", False)) as seen:
                records = launch_train.run(job["argv"])
            after = counts()
            report["train"][job["name"]] = {
                "records": records, "digests": seen["digests"],
                "replicated": seen["replicated"],
                "state_bytes": seen["state_bytes"],
                "step_launches": seen["launches"],
                "starts": seen["starts"], "wait_s": seen["wait_s"],
                "launches": {k: after[k] - before[k] for k in after}}
            if keep and rank == 0:
                torch.save(seen["params"], out_dir / f"{job['name']}.pt")
        for prefix, (b, e), strategies, small in arenas(args):
            x = peer_rows([rank], b, e, 0, device)
            sent, held = collectives.dist_bytes, collectives.dist_s
            for name, y, frac, launched in sync_cases(
                    x, grid, rate=args.rate, block=args.block,
                    packet=args.packet, strategies=strategies,
                    policies=small and world == 4,
                    modes=MODES if small else ("pipelined",)):
                report["sync"][prefix + name] = {
                    "digest": digest(y), "loss_frac": frac,
                    "launches": launched,
                    "dist_bytes": collectives.dist_bytes - sent,
                    "dist_s": collectives.dist_s - held}
                sent, held = collectives.dist_bytes, collectives.dist_s
                if y.numel() <= SMALL:
                    arrays[prefix + name] = y.cpu().numpy()
                del y
            if small:
                for name, y in primitive_cases(x, grid):
                    report["sync"][name] = {"digest": digest(y)}
                    arrays[name] = y.cpu().numpy()
            del x
        if args.rs:
            x = peer_rows([rank], *args.rs, 1, device)
            sent, held = collectives.dist_bytes, collectives.dist_s
            for name, y, frac, launched in rs_cases(
                    x, grid, rate=args.rate, block=args.block,
                    packet=args.packet):
                report["sync"][name] = {
                    "digest": digest(y), "loss_frac": frac,
                    "launches": launched,
                    "dist_bytes": collectives.dist_bytes - sent,
                    "dist_s": collectives.dist_s - held}
                sent, held = collectives.dist_bytes, collectives.dist_s
                if y.numel() <= SMALL:
                    arrays[name] = y.float().cpu().numpy()
                del y
            del x
    finally:
        dist.destroy_process_group()
    if arrays:
        np.savez(out_dir / f"rank{rank}.npz", **arrays)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One rank of the process-group check (see the module "
                    "docstring); runs on the card unless --device cpu.")
    ap.add_argument("out")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the rank's card) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--arena", type=_pair, default=None, metavar="B,E")
    ap.add_argument("--full", type=_pair, default=None, metavar="B,E")
    ap.add_argument("--rs", type=_pair, default=None, metavar="R,C")
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--packet", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--train", action="append", default=[],
                    help='JSON {"name": ..., "argv": [...]}')
    ap.add_argument("--save-params", action="append", default=[])
    ap.add_argument("--wait-for", default=None, metavar="PATH")
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)

    if args.threads:
        torch.set_num_threads(args.threads)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    run(args, device)
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(out_dir, world: int, argv=(), *,
          env: dict | None = None) -> list[subprocess.Popen]:
    """Start ``world`` ranks of this script (torchrun's environment on
    127.0.0.1 and a free port) and return them, running."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    port = free_port()
    path = os.pathsep.join(filter(None, [str(SRC),
                                         os.environ.get("PYTHONPATH")]))
    procs = []
    for r in range(world):
        e = {**os.environ, **(env or {}), "PYTHONPATH": path,
             "WORLD_SIZE": str(world), "RANK": str(r), "LOCAL_RANK": str(r),
             "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)}
        with open(Path(out_dir) / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 str(out_dir), *argv], env=e, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def wait(procs, *, timeout: float = 600.0) -> None:
    """Wait for the ranks of :func:`start`; raises with the end of their
    output (``OUT/rank<r>.log``) if any fails or the wait outlasts
    ``timeout``."""
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(0.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        out_dir = Path(procs[0].args[2])
        raise RuntimeError("distcheck ranks failed: " + " ".join(
            f"[rank {r} exit {p.returncode}]\n"
            f"{(out_dir / f'rank{r}.log').read_text()[-3000:]}"
            for r, p in enumerate(procs)))


def reports(out_dir, world: int) -> list[dict]:
    """The reports of ``world`` ranks, in rank order."""
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
            for r in range(world)]


def spawn(out_dir, world: int, argv=(), *, timeout: float = 600.0,
          env: dict | None = None) -> list[dict]:
    """:func:`start`, :func:`wait`, and the ranks' reports."""
    wait(start(out_dir, world, argv, env=env), timeout=timeout)
    return reports(out_dir, world)


if __name__ == "__main__":
    sys.exit(main())
