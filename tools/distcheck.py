"""Hold the process-group form of the peer grid against the stacked form.

One process a rank, started by ``torchrun`` or by :func:`start` (which
sets torchrun's environment: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``):

  PYTHONPATH=src torchrun --nproc-per-node 4 tools/distcheck.py \\
      build/distcheck --device cpu --arena 3,6000 --block 256
  PYTHONPATH=src torchrun --nproc-per-node 4 tools/distcheck.py \\
      build/distcheck --device cpu --pods 2 --arena 3,6000 --block 256 \\
      --rs 512,64
  PYTHONPATH=src torchrun --nproc-per-node 4 tools/distcheck.py \\
      build/distcheck --device cpu --tp 2 --arena 3,6000 --block 256 \\
      --tp-train '{"name": "tp", "argv": ["--smoke", "--device", "cpu", \\
      "--dp", "2", "--tp", "2", "--steps", "2"]}'

Each rank runs on ``cuda:(LOCAL_RANK % device_count())`` unless
``--device cpu`` (no card raises), joins the default process group
(``--backend``: nccl on the card, gloo on the CPU) and writes
``OUT/rank<r>.json`` (:func:`start` sends its output to
``OUT/rank<r>.log``):

- ``train``: for each ``--train`` JSON ``{"name": ..., "argv": [...]}``,
  the training launcher's records (``launch/train.run``), each step's
  digest of the parameters (with ``"state": true`` in the JSON, of the
  parameters and the optimizer state; with ``"stride": s`` of each
  leaf's :func:`sample`, every s-th entry and a checksum of them all, on
  the rank's device), the bytes of the parameters and
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

- ``--tp T``: the world as a ``(data N, model T)`` grid of ranks, model
  innermost (``collectives.rank_grid(tp=T)``: rank ``i * T + t`` is
  stacked row ``t * N + i``, :func:`tp_stacked_rows`), after the pod
  grids: its
  row of the small arena through :data:`TP_STRATEGIES` in ``scan`` and
  ``pipelined`` (the data-axis sync of each tp group) and
  :func:`tp_primitive_cases`, named ``tp<T>:<case>``. Then, last, each
  ``--tp-train`` JSON (:func:`tp_train`: the launcher with ``--dp N --tp
  T`` on the world, one tp rank a process, FSDP x TP with ``--dp-mode
  fsdp``; one world runs jobs of several layouts in turn, every rank the
  same jobs; ``"config"`` overrides fields of the config the launcher
  reads, :func:`job_config`): its records, each step's
  digests of the rank's state and of its leaves replicated over tp,
  launches, state bytes, and with ``"save"`` each step's leaves in
  ``OUT/<name>.rank<r>.pt``.
- ``--sp-unit T``: sequence parallelism's collectives on the ``(data N,
  model T)`` grid (:func:`sp_unit`: ``scatter_seq``, ``gather_seq`` and
  ``reduce_output`` around one norm, a column-parallel and a row-parallel
  product and a vocab-parallel head, values and gradients), each rank's
  in ``OUT/sp_unit.rank<r>.pt``, as written and with the "f" doubled or
  the norms' tp sum left out (:data:`SP_VARIANTS`). The launcher's jobs
  take ``--seq-parallel`` and ``--prefix`` in their ``argv`` as any flag.
- ``--pods G1,G2,...`` (default 1): the grids the sync cases above run
  on. G = 1 is the flat grid; G > 1 the same world as a ``(pod G, data
  N)`` grid of G x N ranks, pod-major (``collectives.rank_grid(pods=G)``,
  its groups made once), its cases named ``pods<G>:<case>``: the small
  arena at ``--pod-rate`` through every strategy in ``scan`` and
  ``pipelined`` and :data:`POD_POLICIES`, :data:`POD_FULL_STRATEGIES` on
  the full arena, ``pmax`` over a NaN and ``pmean`` over the pod axis and
  over both (:func:`pod_primitive_cases`), and the reduce-scatter over
  both hops, pod first (reliable), then data (drops at ``--rate``). Then
  each ``--pod-train`` JSON (:func:`pod_train`: ``build_train_step`` with
  ``pure_dp`` on a ``(data N, model G)`` mesh, since no launcher has a
  pod flag): its records, each step's digest of the parameters and
  optimizer state, launches, state bytes, bytes sent, host s in the
  group's calls, step s and peak bytes, and with ``"ckpt_dir"`` the
  checkpoint of its last step (the stacked format).

:func:`grid_cases`, :func:`pod_train` and :func:`watch_steps` on the
stacked grid give the other side (``watch_steps(shards=)`` and a stacked
FSDP ``pod_train`` digest each rank's slice of the stacked form's state,
``train/elastic.py``'s); :func:`tree_digest` and :func:`digest` compare
them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
from repro_torch.models.parallel import ParallelCtx  # noqa: E402
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
# the policies on a pod grid of 2 data peers (a dead link there has no
# relay)
POD_POLICIES = (("optireduce", {"active_peers": (0,)}, "scan"),
                ("optireduce_rounds", {"active_peers": (1,)}, "pipelined"),
                ("tar_rounds_q", {"active_peers": (0,)}, "scan"),
                ("ring_ht", {"active_peers": (0,)}, "pipelined"),
                ("gloo_ring", {"active_peers": (1,)}, "scan"),
                ("tar_rounds", {"shard_weights": (2, 1)}, "pipelined"),
                ("optireduce_rounds", {"shard_weights": (2, 1)}, "scan"),
                ("gloo_ring", {"shard_weights": (1, 2)}, "pipelined"))
SMALL = 1 << 20                 # results up to this many elements are kept
FULL_STRATEGIES = ("optireduce", "optireduce_q")   # on the full arena
POD_FULL_STRATEGIES = ("optireduce_q",)            # ... of a pod grid
TP_STRATEGIES = ("optireduce", "optireduce_q")     # on a grid of tp groups


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its dtype's, row-major)."""
    t = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(t.cpu().numpy().data).hexdigest()


CHECKSUM_CHUNK = 1 << 24           # entries a pass of :func:`checksum`
_INTS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def checksum(t: torch.Tensor) -> torch.Tensor:
    """Two 64-bit sums over the bits of every entry of ``t``, on its
    device, ``(2,)`` int64: the plain sum and the sum weighted by 2i + 1.
    An odd weight is a unit modulo 2^64, so a change of any one entry
    always changes the weighted sum."""
    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view(_INTS[flat.element_size()])
    sums = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for lo in range(0, bits.numel(), CHECKSUM_CHUNK):
        x = bits[lo:lo + CHECKSUM_CHUNK].to(torch.int64)
        odd = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                           device=x.device) * 2 + 1
        sums += torch.stack([x.sum(), (x * odd).sum()])
    return sums


def sample(t: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """What a digest of ``t`` covers: ``t`` itself at ``stride`` 1; else
    every ``stride``-th entry's bytes and the :func:`checksum` of all of
    them, one small uint8 tensor on ``t``'s device (a digest of it moves
    and hashes a ``stride``-th of ``t``'s bytes)."""
    t = t.detach()
    if stride == 1:
        return t
    flat = t.contiguous().reshape(-1)
    # a one-entry slice keeps its stride: copy it to a contiguous one
    every = flat[::stride].clone(memory_format=torch.contiguous_format)
    return torch.cat([every.view(torch.uint8),
                      checksum(flat).view(torch.uint8)])


def tree_digest(tree) -> str:
    """SHA-256 over a tree's leaves' digests, in tree order (the leaves
    copied and hashed on 4 threads: ``hashlib`` lets go of the GIL)."""
    h = hashlib.sha256()
    with ThreadPoolExecutor(4) as pool:
        for d in pool.map(digest, tree_leaves(tree)):
            h.update(d.encode())
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


def cases(strategies=None, policies=POLICIES, modes=MODES):
    """``(name, strategy, policy kwargs, mode)`` of every sync case
    (``policies``: a table like :data:`POLICIES`, or none)."""
    for s in strategies or strategy_names():
        for mode in modes:
            yield f"{s}/{mode}", s, {}, mode
    for s, kw, mode in policies or ():
        name = ",".join(f"{k}={v}" for k, v in kw.items())
        yield f"{s}/{mode}/{name}", s, kw, mode


def _pod_axis(grid: collectives.Grid) -> str | None:
    return "pod" if grid.pods > 1 else None


def sync_cases(x: torch.Tensor, grid: collectives.Grid, *, rate: float,
               block: int, packet: int, strategies=None,
               policies=POLICIES, modes=MODES):
    """Yield ``(name, synced stack, loss fraction, launches)`` of each case
    on the ``(P, B, E)`` stack ``x`` over ``grid`` (the draws keyed on
    ``key(5)``; on a grid of pods the configs name the pod axis)."""
    for name, strategy, kw, mode in cases(strategies, policies, modes):
        cfg = OptiReduceConfig(strategy=strategy, hadamard_block=block,
                               packet_elems=packet, incast=2, **kw)
        lossy = (isinstance(resolve_spec(cfg).transport, Lossy)
                 and "shard_weights" not in kw)
        cfg = OptiReduceConfig(strategy=strategy, hadamard_block=block,
                               packet_elems=packet, incast=2,
                               drop_rate=rate if lossy else 0.0,
                               pod_axis=_pod_axis(grid), **kw)
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
    keyed on ``key(5)``, the site ``()``). On a grid of pods the trainer's
    two hops: the pod hop first, reliable, then the data hop."""
    g = x.to(torch.bfloat16)
    for name, bits in RS_BITS:
        cfg = OptiReduceConfig(strategy="optireduce", hadamard_block=block,
                               packet_elems=packet, drop_rate=rate,
                               rs_wire_bits=bits, pod_axis=_pod_axis(grid))
        ctx = SyncContext(cfg=cfg, draws=ThreefryDraws(keys.key(5), cfg,
                                                       x.device),
                          bucket=(), grid=grid)
        hops = [(collectives.DATA, rs_spec(cfg))]
        if grid.pods > 1:
            hops.insert(0, (collectives.POD, rs_spec(cfg, with_drops=False)))
        before = counts()
        y = g
        for axis, spec in hops:
            y = spec.reduce_scatter(y, axis, 1, ctx)
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


def pod_primitive_cases(x: torch.Tensor, grid: collectives.Grid):
    """Yield ``(name, result)`` on a grid of pods: ``pmax`` over both axes
    of the first 64 entries of bucket 0 with peer 1's (pod-major) entry 3
    made NaN (every peer must hold NaN there), and ``pmean`` of them over
    the pod axis and over both."""
    v = x[:, 0, :64].clone()
    v[collectives.axis_index(v, grid, collectives.BOTH) == 1, 3] = \
        float("nan")
    yield "pmax_nan", collectives.pmax(v, grid, collectives.BOTH)
    w = x[:, 0, :64]
    yield "pmean_pod", collectives.pmean(w, grid, collectives.POD)
    yield "pmean_both", collectives.pmean(w, grid, collectives.BOTH)


def tp_primitive_cases(x: torch.Tensor, grid: collectives.Grid):
    """Yield ``(name, result)`` on a grid of tp groups: ``psum`` over the
    model axis of the first 64 entries of bucket 0 (every tp rank holding
    its group's ordered sum), and ``pmax`` over the data axis of them with
    data index 1's entry 3 made NaN (every peer of its tp group must hold
    NaN there)."""
    v = x[:, 0, :64].clone()
    yield "psum_model", collectives.psum(v, grid, collectives.MODEL)
    v[collectives.axis_index(v, grid) == 1, 3] = float("nan")
    yield "pmax_nan", collectives.pmax(v, grid)


def tp_stacked_rows(world: int, tp: int,
                    rank: int | None = None) -> list[int]:
    """The stacked rows of the ``(data N, model T)`` grid's ranks (rank
    ``i * T + t`` is stacked row ``t * N + i``, model outermost): every
    rank's in rank order, or ``rank``'s alone."""
    n = world // tp
    rows = [(r % tp) * n + r // tp for r in range(world)]
    return rows if rank is None else [rows[rank]]


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
                steps: int | None = None, tp: int = 1, stride: int = 1,
                keep_steps: bool = False, fsdp: bool = False):
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
    ``keep``, the last step's parameters (on the host) into
    ``seen["params"]``; ``seen["last"]`` and ``seen["last_state"]`` are the
    live parameters and optimizer state (the last step's), ``seen["cfg"]``
    the model's config.
    With ``shards=n`` a step's digest is instead the list of the n
    workers' digests of their FSDP slices (``elastic.split_leaf``): what
    rank r of the one-rank-a-peer form must hold. ``steps`` copies only
    the first so many steps. With ``tp`` > 1 the replicated leaves are
    those replicated over tp (``elastic.tp_dims``; with ``fsdp``, FSDP x
    TP, those neither tp nor FSDP shards), and ``stride`` > 1 digests the
    :func:`sample` of each sharded leaf (the replicated ones whole; of
    every leaf when neither ``state`` nor ``shards`` says which are
    sharded), taken on the device after each step; ``keep_steps`` keeps
    every step's leaves on the host in ``seen["leaves"]``. With
    ``wait_for``, the first step ends by waiting for the card to finish
    it, writing :func:`ready_path` and waiting until ``wait_for`` exists
    (both waits are ``seen["wait_s"]``)."""
    from repro_torch.launch import train as launch_train
    seen = {"digests": [], "params": None, "starts": [], "wait_s": 0.0,
            "state_bytes": [], "replicated": [], "launches": [],
            "leaves": [], "last": None, "last_state": None, "cfg": None}
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
                own = elastic.tp_dims(cfg, tp) if tp > 1 else None
                if own and fsdp:    # a leaf held whole has neither dim
                    own = [b if a is None else a for a, b in zip(
                        own, elastic.fsdp_dims(cfg, tp))]
                dims.extend((own or elastic.fsdp_dims(cfg)) + (
                    elastic.state_dims(cfg, out[1], opt.state_like_params,
                                       dims=own) if state else []))
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
            # updated in place: the last step's
            seen["last"], seen["last_state"] = out[0], out[1]
            seen["cfg"] = args[0]
            if steps is None or len(copies) < steps:
                leaves = tree_leaves((out[0], out[1]) if state else out[0])
                if keep_steps:
                    seen["leaves"].append([p.detach().cpu().clone()
                                           for p in leaves])
                sampled = [d is not None or not dims
                           for d in dims or [None] * len(leaves)]
                copies.append([
                    sample(p, stride) if stride > 1 and s and not shards
                    else p.detach().clone()
                    for p, s in zip(leaves, sampled)])
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
            seen["digests"] = [_step_digest(c, dims, shards, stride)
                               for c in copies]
        if state:
            seen["replicated"] = [
                tree_digest([leaf for leaf, d in zip(c, dims) if d is None])
                for c in copies]
        if keep and seen["last"] is not None:
            seen["params"] = [p.detach().cpu()
                              for p in tree_leaves(seen["last"])]
        copies.clear()


# sp_unit's shapes: batch, sequence, width, MLP width, vocab
SP_UNIT = (2, 8, 16, 32, 24)
# sp_unit's forms: as the model runs; the "f" doubled (``copy_tp`` on the
# gathered activation, whose gather sums its gradient already); the norms'
# sum over the tp group left out (``copy_seq`` as the identity)
SP_VARIANTS = ("sp", "doubled_f", "no_norm_sum")


def sp_unit(pctx, variant: str = "sp", seed: int = 0) -> dict:
    """One Megatron-SP sublayer and head on seeded fp32 tensors, under
    ``pctx`` (``sp`` over T tp ranks: the stacked form, or with
    ``tp_grid`` over ranks, this rank's shards): ``x`` ``(B, S, D)``,
    ``scatter_seq``, a norm, ``gather_seq``, a column-parallel product
    (``copy_act``), a row-parallel one (``reduce_output``), the residual,
    a second norm, ``gather_seq`` and a vocab-parallel head whose squared
    logits ``psum_tp`` adds. Returns the loss, the gathered residual and
    the gradients of ``x``, both norms and the three weights (a rank's
    chunk of the column-parallel ones' output dim and of ``w_down``'s
    rows). ``variant`` (:data:`SP_VARIANTS`) breaks the form on purpose."""
    from repro_torch.models.layers import rms_norm, row_parallel
    b, s, d, f, v = SP_UNIT
    g = torch.Generator().manual_seed(seed)
    full = {"x": torch.randn(b, s, d, generator=g),
            "ln1": 1 + 0.1 * torch.randn(d, generator=g),
            "ln2": 1 + 0.1 * torch.randn(d, generator=g),
            "w_up": torch.randn(d, f, generator=g) / d ** 0.5,
            "w_down": torch.randn(f, d, generator=g) / f ** 0.5,
            "head": torch.randn(d, v, generator=g) / d ** 0.5}
    t = pctx.tp_size()
    over = pctx.over_ranks()
    k = pctx.tp_grid.index_on(collectives.MODEL) if over else 0
    dims = {"w_up": 1, "w_down": 0, "head": 1}
    own = {n: (x.chunk(t, dims[n])[k] if over and n in dims else x)
           .clone().requires_grad_(True) for n, x in full.items()}
    copy_act = pctx.copy_tp if variant == "doubled_f" else pctx.copy_act
    copy_seq = ((lambda w: w) if variant == "no_norm_sum"
                else pctx.copy_seq)
    xs = pctx.scatter_seq(own["x"])
    h = pctx.gather_seq(rms_norm(xs, copy_seq(own["ln1"])))
    u = copy_act(h) @ own["w_up"]
    out = xs + row_parallel(u, own["w_down"], pctx)
    z = pctx.gather_seq(rms_norm(out, copy_seq(own["ln2"])))
    logits = copy_act(z) @ own["head"]
    part = (logits * logits).sum() / 2
    loss = pctx.psum_tp(part.reshape(1)) if over else part
    loss.backward()
    return {"loss": loss.detach(), "out": pctx.gather_seq(out).detach(),
            **{f"grad/{n}": x.grad for n, x in own.items()}}


def replicated_leaves(cfg, tp: int, params, state) -> dict:
    """The leaves replicated over tp (the router, ``wB`` and ``wC``,
    ``frontend_proj``, the norms) of ``params``
    and of the optimizer ``state`` (trees like the parameters: AdamW's two
    moments, momentum's one), tree order, on the host: ``{"params": [...],
    "state": [...]}``; a rank's own pieces of them under FSDP."""
    rep = [d is None for d in elastic.tp_dims(cfg, tp)]
    st = tree_leaves(state)
    return {"params": [p.detach().cpu() for p, r in zip(tree_leaves(params),
                                                         rep) if r],
            "state": [x.detach().cpu() for i, x in enumerate(st)
                      if rep[i % len(rep)]]}


def _step_digest(leaves: list, dims, shards: int | None, stride: int = 1):
    """A step's digest of the parameters and optimizer state: one, or with
    ``shards`` the list of each rank's digest of its FSDP slices
    (``elastic.split_leaf``, pod-major). With ``stride`` > 1 a sharded
    leaf's (or slice's) :func:`sample`, the others whole; without ``dims``
    every leaf's sample."""
    def cover(x, d):
        return sample(x, stride) if dims is None or d is not None else x
    if shards is None:
        return tree_digest([cover(x, d) for x, d in zip(
            leaves, dims or [None] * len(leaves))])
    return [tree_digest([cover(elastic.split_leaf(leaf, d, shards)[r], d)
                         for leaf, d in zip(leaves, dims)])
            for r in range(shards)]


def pod_train(job: dict, device, group=None, *, keep: bool = False) -> dict:
    """Train as ``job`` says on the ``(pod G, data N)`` grid, through
    ``build_train_step`` with ``pure_dp`` on ``make_host_mesh(dp=N,
    tp=G)`` (its ``model`` axis the pods; with ``"mesh": "pod"`` on
    ``HostMesh(("pod", "data"), (G, N))``): the stacked form (``group``
    None) or one rank a peer over ``group``'s G x N ranks, pod-major (under
    FSDP each rank drawing its shards as ``launch/train.py`` does).

    ``job``: ``name``, ``arch`` (``smoke``: its smoke config), ``pods``
    (G), ``peers`` (G x N), ``strategy``, ``dp_mode``, ``steps``,
    ``seq_len``, ``global_batch``, ``drop_rate`` (tail), ``block``,
    ``bucket_elems``, ``lr``, ``skip_threshold``, ``sync_mode``, ``seed``,
    and optionally ``stride`` (the digests of each sharded leaf's
    :func:`sample`, of every leaf when replicated), ``kernel_mode``,
    ``ckpt_dir`` (save the last step's
    state there, the stacked format, rank 0 writing) and ``resume`` (start
    from its newest checkpoint). Returns the records (loss, loss_frac, grad_norm, skipped,
    step_s, dist_bytes and dist_axis_bytes, dist_s, peak_bytes on the
    card), each step's digest of the parameters and optimizer state
    (stacked FSDP: each rank's slice digests), launches and state bytes,
    and the init's launches; with ``keep``, each step's leaves of the
    parameters and optimizer state, copied to the host."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import HostMesh, make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.trainer import TrainConfig, build_train_step

    device = torch.device(device)
    cfg = (get_smoke if job.get("smoke") else get_config)(job["arch"])
    world, pods = job["peers"], job["pods"]
    tc = TrainConfig(
        sync=OptiReduceConfig(strategy=job["strategy"],
                              drop_rate=job["drop_rate"],
                              drop_pattern="tail",
                              hadamard_block=job["block"],
                              skip_threshold=job["skip_threshold"]),
        optimizer=OptimizerConfig(lr=job["lr"]), dp_mode=job["dp_mode"],
        sync_mode=job["sync_mode"], bucket_elems=job["bucket_elems"],
        seq_chunk=min(512, job["seq_len"]),
        pure_dp=job.get("mesh") != "pod", kernel_mode=job.get("kernel_mode"))
    mesh = (HostMesh(("pod", "data"), (pods, world // pods))
            if job.get("mesh") == "pod"
            else make_host_mesh(dp=world // pods, tp=pods))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=job["seq_len"],
                                  global_batch=job["global_batch"],
                                  seed=job["seed"]))
    k = keys.key(job["seed"])
    fsdp = job["dp_mode"] == "fsdp"
    rank = 0 if group is None else dist.get_rank(group)
    sharded = fsdp and group is not None
    dims = elastic.fsdp_dims(cfg) if fsdp else None
    cuts = elastic.rank_cuts(cfg, ranks=world, rank=rank, fsdp=True)
    before = counts()
    params = init_params(k, cfg, device=device, keep=(
        (lambda i, w: elastic.cut_piece(w, cuts[i])) if sharded else None))
    init_launches = {n: v - before[n] for n, v in counts().items()}
    step_fn, opt = build_train_step(cfg, tc, mesh, device=device,
                                    group=group)
    state = opt.init(params)
    if fsdp:
        dims = dims + elastic.state_dims(cfg, state, opt.state_like_params)
        cuts = cuts + elastic.state_dims(cfg, state, opt.state_like_params,
                                         dims=cuts)
    start = 0
    if job.get("resume"):
        start, (params, state), _ = ckpt_lib.restore(
            job["ckpt_dir"], (params, state),
            device="cpu" if sharded else device)
        if sharded:
            params, state = elastic.cut_tree((params, state), cuts, device)
    shards = world if fsdp and group is None else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"records": [], "digests": [], "launches": [], "state_bytes": [],
           "init_launches": init_launches, "leaves": []}
    for step in range(start, job["steps"]):
        batch = data.host_batch(step, 0, 1)
        sent, held = collectives.dist_bytes, collectives.dist_s
        by_axis = dict(collectives.dist_axis_bytes)
        before = counts()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch, step, k)
        rec = {n: float(v) for n, v in metrics.items()}   # waits for it
        rec["step_s"] = time.perf_counter() - t0
        after = counts()
        rec["dist_bytes"] = collectives.dist_bytes - sent
        rec["dist_s"] = collectives.dist_s - held
        rec["dist_axis_bytes"] = {a: v - by_axis.get(a, 0) for a, v in
                                  collectives.dist_axis_bytes.items()}
        if device.type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["records"].append(rec)
        out["launches"].append({n: after[n] - before[n] for n in after})
        out["state_bytes"].append(state_bytes((params, state)))
        leaves = tree_leaves((params, state))
        out["digests"].append(_step_digest(leaves, dims, shards,
                                           job.get("stride", 1)))
        if keep:
            out["leaves"].append([t.detach().cpu().clone() for t in leaves])
    if job.get("ckpt_dir") and not job.get("resume"):
        tree = (params, state)
        if sharded:       # every rank joins each leaf's gather
            tree = elastic.gather_cut_tree(tree, cuts, collectives.rank_grid(
                group, pods=pods), keep=rank == 0)
        if rank == 0:
            ckpt_lib.save(job["ckpt_dir"], job["steps"], tree)
    return out


def with_overrides(cfg, overrides: dict | None):
    """``cfg`` with the fields ``overrides`` names replaced
    (``dataclasses.replace``); a ``param_dtype`` may be a torch dtype's
    name (``"float64"``), as JSON carries it."""
    if not overrides:
        return cfg
    fields = dict(overrides)
    if isinstance(fields.get("param_dtype"), str):
        fields["param_dtype"] = getattr(torch, fields["param_dtype"])
    return dataclasses.replace(cfg, **fields)


@contextlib.contextmanager
def job_config(overrides: dict | None):
    """The training launcher reads every config, full (``get_config``) or
    smoke (``get_smoke``), with ``overrides`` applied
    (:func:`with_overrides`: ``{"n_layers": 12}``, ``{"param_dtype":
    "float64"}``, ``{"ssm_heads": 2, "ssm_head_dim": 64}``)."""
    from repro_torch.launch import train as launch_train
    if not overrides:
        yield
        return
    readers = {name: getattr(launch_train, name)
               for name in ("get_config", "get_smoke")}
    for name, read in readers.items():
        setattr(launch_train, name,
                lambda arch, read=read: with_overrides(read(arch), overrides))
    try:
        yield
    finally:
        for name, read in readers.items():
            setattr(launch_train, name, read)


def tp_train(job: dict, out_dir=None, rank: int = 0) -> dict:
    """Run the training launcher with ``job["argv"]`` (``--dp N --tp T``,
    with ``--dp-mode fsdp`` FSDP x TP: under torchrun one tp rank a
    process, else the stacked form) and report each step's records, digest
    of the parameters and optimizer state the process holds (with
    ``job["stride"]`` each sharded leaf's :func:`sample`) and of
    its leaves replicated over tp (whole; under FSDP those no rank
    shards), its launches, the state bytes and the launches of the rest of
    the run (the init's draws). With ``job["save"]`` each step's leaves
    go to ``out_dir/<name>.rank<r>.pt`` (a list over steps of the
    parameters' and the state's leaves, on the host; without ``out_dir``
    in the report's ``leaves``), with ``job["save_last"]`` the last step's
    parameters alone (a list of leaves), with ``job["save_replicated"]``
    its :func:`replicated_leaves` to ``out_dir/<name>.rank<r>.rep.pt``.
    ``job["config"]`` overrides fields of the config the launcher reads
    (:func:`job_config`). On the card the peak-memory counter is reset
    first."""
    from repro_torch.launch import train as launch_train
    argv = job["argv"]
    tp = int(argv[argv.index("--tp") + 1])
    fsdp = "--dp-mode" in argv and argv[argv.index("--dp-mode") + 1] == "fsdp"
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()
    before = counts()
    with job_config(job.get("config")), \
            watch_steps(state=True, tp=tp, stride=job.get("stride", 1),
                        keep_steps=job.get("save", False),
                        fsdp=fsdp) as seen:
        t0 = time.time()
        records = launch_train.run(argv)
        t1 = time.time()
    after = counts()
    total = {k: after[k] - before[k] for k in after}
    rest = {k: v - sum(step[k] for step in seen["launches"])
            for k, v in total.items()}
    out = {"records": records, "digests": seen["digests"],
           "replicated": seen["replicated"],
           "state_bytes": seen["state_bytes"],
           "step_launches": seen["launches"], "other_launches": rest,
           "starts": seen["starts"], "run_s": [t0, t1]}
    path = Path(out_dir or ".") / f"{job['name']}.rank{rank}.pt"
    if job.get("save") and out_dir is None:
        out["leaves"] = seen["leaves"]
    elif job.get("save"):
        torch.save(seen["leaves"], path)
    elif job.get("save_last"):
        torch.save([p.detach().cpu() for p in tree_leaves(seen["last"])],
                   path)
    if job.get("save_replicated"):
        torch.save(replicated_leaves(seen["cfg"], tp, seen["last"],
                                     seen["last_state"]),
                   path.with_suffix(".rep.pt"))
    return out


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


def grid_cases(grid: collectives.Grid, rows, device, *, world: int,
               arena=None, full=None, rs=None, rate: float,
               pod_rate: float, block: int, packet: int):
    """Yield ``(name, result, loss fraction, launches)`` of every sync
    case on ``grid`` over the seeded arenas' ``rows`` (this rank's
    ``[rank]``, or every peer's on the stacked grid): the small ``arena``
    through every strategy in each mode, the policies (:data:`POLICIES` at
    4 flat peers, :data:`POD_POLICIES` at 2 data peers a pod) and the
    primitives (loss fraction and launches None), the ``full`` arena
    through :data:`FULL_STRATEGIES` (:data:`POD_FULL_STRATEGIES` on pods)
    in ``pipelined`` mode, and the reduce-scatter of ``rs``. On a grid of
    G > 1 pods the names take the prefix ``pods<G>:`` and the small arena
    drops at ``pod_rate``."""
    pods, tp, n = grid.pods, grid.tp, world // (grid.pods * grid.tp)
    prefix = ("" if pods == tp == 1 else f"pods{pods}:" if pods > 1
              else f"tp{tp}:")
    if tp > 1:                         # the small arena alone
        x = peer_rows(rows, *arena, 0, device)
        for name, y, frac, launched in sync_cases(
                x, grid, rate=rate, block=block, packet=packet,
                strategies=TP_STRATEGIES, policies=None):
            yield prefix + name, y, frac, launched
        for name, y in tp_primitive_cases(x, grid):
            yield prefix + name, y, None, None
        return
    if arena:
        x = peer_rows(rows, *arena, 0, device)
        policies = (POLICIES if (pods, n) == (1, 4) else POD_POLICIES
                    if pods > 1 and n == 2 else None)
        for name, y, frac, launched in sync_cases(
                x, grid, rate=rate if pods == 1 else pod_rate, block=block,
                packet=packet, policies=policies):
            yield prefix + name, y, frac, launched
        prims = primitive_cases if pods == 1 else pod_primitive_cases
        for name, y in prims(x, grid):
            yield prefix + name, y, None, None
        del x
    if full:
        x = peer_rows(rows, *full, 0, device)
        for name, y, frac, launched in sync_cases(
                x, grid, rate=rate, block=block, packet=packet,
                strategies=FULL_STRATEGIES if pods == 1
                else POD_FULL_STRATEGIES, policies=None,
                modes=("pipelined",)):
            yield prefix + "full:" + name, y, frac, launched
        del x
    if rs:
        x = peer_rows(rows, *rs, 1, device)
        for name, y, frac, launched in rs_cases(x, grid, rate=rate,
                                                block=block, packet=packet):
            yield prefix + name, y, frac, launched
        del x


def _pair(text: str) -> tuple[int, int]:
    b, e = (int(v) for v in text.split(","))
    return b, e


def run(args, device) -> None:
    """Join the default group over ``--backend``, run the ``--train``
    launcher runs, the arenas' sync cases on each grid of ``--pods`` and
    the ``--pod-train`` runs, leave the group, and write
    ``OUT/rank<r>.json`` (and ``.npz``)."""
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend)
    rank, world = dist.get_rank(), dist.get_world_size()
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
                             state=job.get("state", False),
                             stride=job.get("stride", 1)) as seen:
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
            del seen                    # the run's live state with it
        grids = [(collectives.rank_grid(pods=pods), [rank])
                 for pods in args.pods]
        if args.tp > 1:
            grids.append((collectives.rank_grid(tp=args.tp),
                          tp_stacked_rows(world, args.tp, rank)))
        for grid, rows in grids:
            sent, held = collectives.dist_bytes, collectives.dist_s
            for name, y, frac, launched in grid_cases(
                    grid, rows, device, world=world, arena=args.arena,
                    full=args.full, rs=args.rs, rate=args.rate,
                    pod_rate=args.rate if args.pod_rate is None
                    else args.pod_rate, block=args.block,
                    packet=args.packet):
                entry = report["sync"][name] = {"digest": digest(y)}
                if launched is not None:
                    entry.update(loss_frac=frac, launches=launched,
                                 dist_bytes=collectives.dist_bytes - sent,
                                 dist_s=collectives.dist_s - held)
                sent, held = collectives.dist_bytes, collectives.dist_s
                if y.numel() <= SMALL:
                    arrays[name] = y.float().cpu().numpy()
                del y
        for spec in args.pod_train:
            job = json.loads(spec)
            report["train"][job["name"]] = pod_train(job, device,
                                                     dist.group.WORLD)
        if args.sp_unit:
            grid = collectives.rank_grid(tp=args.sp_unit)
            pctx = ParallelCtx(tp_axis="model", sp=True, tp_grid=grid,
                               sizes={"model": args.sp_unit})
            torch.save({v: sp_unit(pctx, v) for v in SP_VARIANTS},
                       out_dir / f"sp_unit.rank{rank}.pt")
        for spec in args.tp_train:
            job = json.loads(spec)
            report["train"][job["name"]] = tp_train(job, out_dir, rank)
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
    ap.add_argument("--pods", type=lambda t: [int(v) for v in t.split(",")],
                    default=[1], metavar="G1,G2,...",
                    help="the grids the sync cases run on (1: flat)")
    ap.add_argument("--pod-rate", type=float, default=None,
                    help="the small arena's drop rate on a grid of pods "
                         "(default --rate)")
    ap.add_argument("--pod-train", action="append", default=[],
                    help="JSON of a pod_train run")
    ap.add_argument("--tp", type=int, default=1,
                    help="T > 1: the small arena's tp cases on the (data, "
                         "model) grid of the world's ranks, model innermost")
    ap.add_argument("--sp-unit", type=int, default=0, metavar="T",
                    help="sp_unit's forms on the (data, model) grid of tp "
                         "T, before the --tp-train runs")
    ap.add_argument("--tp-train", action="append", default=[],
                    help='JSON of a tp_train run {"name": ..., "argv": '
                         '[...], "save": ..., "stride": ...}')
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--packet", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--train", action="append", default=[],
                    help='JSON {"name": ..., "argv": [...], "state": ..., '
                         '"stride": ...}')
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
