"""Time-to-accuracy harness (paper §5.2, Fig 11/14/16, Table 1).

Counterpart of ``src/repro/sim/tta.py``. TTA factors as the paper argues:
*what* the model learns per step depends only on the gradient content
(drops / compression), *how long* a step takes only on the collective and
the network. This module is the first half: REAL training of the paper's
GPT-2 on the synthetic-grammar LM task with the gradient aggregation
emulated worker by worker (N replicas, per-worker gradients, drops, HT and
compression through the port's ``core/`` implementations), measuring
accuracy and steps-to-accuracy. The second half, the per-step wall clock,
is the network simulator's (``sim/netsim.py``), which runs on its own.

On the card the THC baseline runs kernels B1 (rotation) and B7 (quantizer),
one launch each for all N workers, and B1 again for the decode; the HT of
the OptiReduce paths is B1. The drop-compensated means stay plain PyTorch,
as the reference keeps them jnp.

Draws are the reference's own, bit for bit (threefry keys,
``core/keys.py``), on its key path name for name: the step key ``fold_in(seed, step)``; the HT and
THC sign from the step key; THC's noise from ``fold_in(step_key, 1)``, one
copy every worker shares (the reference hands every worker the same key);
stage-1 masks from ``fold_in(step_key, r)`` and stage-2 masks from
``fold_in(step_key, 100 + i)``; TernGrad's draw from ``fold_in(step_key,
i)``. A :class:`Draws` provider serves them (:class:`KeyDraws` by
default), so a test can hand in others.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.core import compression as comp_lib
from repro_torch.core import drops as drops_lib
from repro_torch.core.hadamard import ht_decode, ht_encode, rademacher_sign
from repro_torch.core import keys as keys_lib
from repro_torch.core.keys import Key, fold_in
from repro_torch.core.keys import key as seed_key
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import runtime
from repro_torch.models import forward_hidden, init_params, lm_loss
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainRunConfig:
    arch: str = "gpt2-paper"
    n_workers: int = 8
    per_worker_batch: int = 4
    seq_len: int = 64
    steps: int = 300
    eval_every: int = 10
    lr: float = 3e-3
    optimizer: str = "momentum"
    drop_rate: float = 0.0
    drop_pattern: str = "tail"
    # loss recovery (DESIGN §8): 'stale' fills lost stage-1 entries from
    # the previous step's mean bucket (plain mean over N); 'ef' adds per-
    # worker error-feedback residuals of the undelivered wire mass.
    recovery: str = "none"            # none | stale | ef
    use_hadamard: bool = True
    # per-coordinate compensation of missing contributions is what the HT
    # pipeline provides (§3.3 "unbiased estimate"); the naive no-HT path
    # sums received entries and divides by N (biased toward 0 at the
    # dropped coordinates) — which is why Fig 14's no-HT runs degrade.
    compensate: bool | None = None    # default: == use_hadamard
    hadamard_block: int = 1024
    compressor: str | None = None     # None | topk | terngrad | thc
    topk_frac: float = 0.01
    thc_bits: int = 4
    markov_weight: float = 0.85
    n_succ: int = 1
    seed: int = 0


class Draws(Protocol):
    """Where the harness's random operands come from, by key."""

    def sign(self, key: Key, block: int) -> torch.Tensor:
        """The ``(block,)`` fp32 +-1 Hadamard sign."""

    def uniform(self, key: Key, shape: tuple[int, ...]) -> torch.Tensor:
        """fp32 uniform [0, 1) of ``shape``."""

    def mask(self, key: Key, pattern: str, n: int, elems: int, *,
             rate: float, self_index: int | None = None) -> torch.Tensor:
        """``(n, elems)`` fp32 0/1 arrival mask (``core.drops.make_mask``)."""


@dataclasses.dataclass(frozen=True)
class KeyDraws:
    """The default provider: the reference's threefry draws under each key
    (``core/keys.py``), on the run's device."""
    device: torch.device

    def sign(self, key: Key, block: int) -> torch.Tensor:
        return rademacher_sign(key, block, self.device)

    def uniform(self, key: Key, shape: tuple[int, ...]) -> torch.Tensor:
        return keys_lib.uniform(key, shape, self.device)

    def mask(self, key: Key, pattern: str, n: int, elems: int, *,
             rate: float, self_index: int | None = None) -> torch.Tensor:
        return drops_lib.make_mask(pattern, key, n, elems, rate=rate,
                                   self_index=self_index, device=self.device)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: the sum over ``dim`` divided by the count, a true
    division on every device (``torch.mean`` multiplies by 1/count)."""
    s = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    count = x.numel() // max(s.numel(), 1)
    return s / torch.full_like(s, count)


def _layout(tree):
    leaves = tree_leaves(tree)
    return (tree_map(lambda _: None, tree), [tuple(l.shape) for l in leaves],
            [l.numel() for l in leaves])


def _flatten(tree):
    """Leaves in tree order -> one flat fp32 vector, and the layout."""
    flat = torch.cat([l.reshape(-1).to(torch.float32)
                      for l in tree_leaves(tree)])
    return flat, _layout(tree)


def _unflatten(flat: torch.Tensor, meta):
    """Inverse of :func:`_flatten`; leading axes of ``flat`` (the worker
    axis) lead every leaf."""
    like, shapes, sizes = meta
    lead = flat.shape[:-1]
    out, off = [], 0
    for sh, sz in zip(shapes, sizes):
        out.append(flat[..., off:off + sz].reshape(*lead, *sh))
        off += sz
    return tree_unflatten(like, out)


def _aggregate_per_receiver(worker_flats: torch.Tensor, key: Key,
                            rc: TrainRunConfig,
                            stale: torch.Tensor | None = None,
                            want_resid: bool = False, *, draws: Draws
                            ) -> tuple[torch.Tensor, float, dict]:
    """Full two-stage TAR emulation with per-receiver outcomes.

    Stage 1: owner r reduces peers' shard-r contributions under its arrival
    mask. Stage 2: each receiver gets every owner's aggregate under its own
    (tail-drop) mask — so receivers end up with *different* buckets, the
    replica-divergence pathology HT exists to tame (Fig 6/14). All owners'
    and all receivers' masks are stacked, so the encode and the decode are
    one B1 launch each for every worker.

    ``stale`` (recovery='stale'/'ef'): previous step's mean bucket (L,) —
    every lost stage-1 entry is filled from it (re-encoded under this
    step's sign) and the owner takes the plain mean over N instead of
    renormalizing. ``want_resid`` (recovery='ef'): also return, in value
    space, the gap between each worker's contribution and the stale fill
    applied in its stead (lost entries only).
    Returns (per-receiver buckets (N, L), drop fraction, extras) with
    extras = {'stale': next step's (L,) cache, 'resid': (N, L) or None}.
    """
    n, length = worker_flats.shape
    block = rc.hadamard_block
    pad = (-length) % (n * block)
    g = F.pad(worker_flats, (0, pad))
    lp = g.shape[1]
    chunk = lp // n
    compensate = rc.use_hadamard if rc.compensate is None else rc.compensate

    if rc.drop_rate <= 0.0:
        mean = _mean(g, 0)
        out = mean[None].expand(n, lp)[:, :length]
        return out, 0.0, {"stale": mean[:length],
                          "resid": torch.zeros_like(worker_flats)
                          if want_resid else None}

    sign = draws.sign(key, block) if rc.use_hadamard else None
    if rc.use_hadamard:
        g = ht_encode(g, sign, block=block)
    st_shards = None
    if stale is not None:
        st = F.pad(stale.to(g.dtype), (0, pad))
        if rc.use_hadamard:
            st = ht_encode(st, sign, block=block)
        st_shards = st.view(n, chunk)                     # [owner, chunk]

    shards = g.view(n, n, chunk)                          # [worker, owner, .]
    # stage 1: owner r's mask over the workers, stacked [worker, owner, .]
    m1 = torch.stack([draws.mask(fold_in(key, r), rc.drop_pattern, n, chunk,
                                 rate=rc.drop_rate, self_index=r)
                      for r in range(n)], dim=1)
    if st_shards is not None:
        # cross-step prediction (DESIGN §8): lost entries filled from the
        # previous step's mean, plain mean over all N (arrived entries weigh
        # exactly 1/N — the EF split relies on this)
        agg_all = _mean(shards * m1 + (1.0 - m1) * st_shards[None], 0)
    elif compensate:
        cnt = m1.sum(0)
        agg_all = torch.where(cnt > 0, (shards * m1).sum(0)
                              / torch.clamp(cnt, min=1), 0.0)
    else:
        agg_all = (shards * m1).sum(0) / torch.full((), n, device=g.device)
    dropped = (1.0 - m1).sum()                            # (owner, chunk)
    total = m1.numel()

    resid = None
    if want_resid:
        # worker i's stage-1 arrival across owners, in its wire layout;
        # residual vs the stale fill applied in its stead — carrying the
        # full lost mass on top of the fill would apply it twice
        arrival = m1.reshape(n, lp)
        resid = (1.0 - arrival) * (g if st_shards is None
                                   else g - st_shards.reshape(lp)[None])
        if rc.use_hadamard:
            resid = ht_decode(resid, sign, block=block)
        resid = resid[:, :length]

    # stage 2: receiver i's mask over the owners, stacked [receiver, owner, .]
    m2 = torch.stack([draws.mask(fold_in(key, 100 + i), rc.drop_pattern, n,
                                 chunk, rate=rc.drop_rate, self_index=i)
                      for i in range(n)])
    if compensate:
        # §3.3: receiver rescales by its known received fraction
        frac = _mean(m2, 2, keepdim=True)
        recv = agg_all[None] * m2 / torch.clamp(frac, min=1e-3)
    else:
        recv = agg_all[None] * m2
    dropped = dropped + (1.0 - m2).sum()
    total += m2.numel()
    out = recv.reshape(n, lp)
    if rc.use_hadamard:
        out = ht_decode(out, sign, block=block)
    drop_frac = float(dropped / torch.full_like(dropped, total))
    return out[:, :length], drop_frac, \
        {"stale": _mean(out, 0)[:length], "resid": resid}


def _aggregate(worker_flats: torch.Tensor, key: Key, rc: TrainRunConfig,
               state: dict, *, draws: Draws) -> tuple[torch.Tensor, float]:
    """Emulate the collective on N per-worker flat gradients -> (mean,
    observed drop fraction). ``state`` carries Top-K's error memory
    (``state["topk"]``, a :class:`TopKState`, made on first use)."""
    n, length = worker_flats.shape
    block = rc.hadamard_block
    pad = (-length) % (n * block)
    g = F.pad(worker_flats, (0, pad))
    lp = g.shape[1]

    if rc.compressor == "topk":
        k = max(1, int(rc.topk_frac * lp))
        if "topk" not in state:
            state["topk"] = comp_lib.topk_init(n, lp, g.device)
        sparse, state["topk"] = comp_lib.topk_compress(g, state["topk"], k=k)
        return _mean(sparse, 0)[:length], 0.0
    if rc.compressor == "terngrad":
        u = torch.stack([draws.uniform(fold_in(key, i), (lp,))
                         for i in range(n)])
        return _mean(comp_lib.terngrad_compress(g, u), 0)[:length], 0.0
    if rc.compressor == "thc":
        lohi = torch.stack([g.min() * 1.2 - 1e-3, g.max() * 1.2 + 1e-3])
        sign = draws.sign(key, block)
        noise = draws.uniform(fold_in(key, 1), (lp // block, block))
        codes = comp_lib.thc_compress(g, sign, noise, lohi, bits=rc.thc_bits,
                                      block=block).codes
        del g, noise
        code_sum = codes[0].to(torch.int32)
        for c in codes[1:]:
            code_sum += c
        del codes
        out = comp_lib.thc_decompress_sum(code_sum, sign, lohi,
                                          bits=rc.thc_bits, block=block,
                                          nsum=n)
        return out[:length], 0.0
    if rc.compressor is not None:
        raise ValueError(f"unknown compressor {rc.compressor!r} "
                         "(topk | terngrad | thc)")

    # --- OptiReduce path (or reliable mean when drop_rate == 0) ----------
    if rc.drop_rate <= 0.0:
        return _mean(g, 0)[:length], 0.0
    compensate = rc.use_hadamard if rc.compensate is None else rc.compensate
    sign = draws.sign(key, block) if rc.use_hadamard else None
    if rc.use_hadamard:
        g = ht_encode(g, sign, block=block)
    mask = draws.mask(key, rc.drop_pattern, n, lp, rate=rc.drop_rate)
    if compensate:
        cnt = mask.sum(0)
        mean = torch.where(cnt > 0, (g * mask).sum(0)
                           / torch.clamp(cnt, min=1), 0.0)
    else:
        mean = (g * mask).sum(0) / torch.full((), n, device=g.device)
    if rc.use_hadamard:
        mean = ht_decode(mean, sign, block=block)
    return mean[:length], float(1.0 - _mean(mask))


class ReplicaRun:
    """The state of one :func:`run_training`: N model replicas (leaves
    stacked on a leading worker axis), their optimizer state, the
    compressors' state and the recovery carries; :meth:`step` takes one
    training step, :meth:`accuracy` and :meth:`divergence` read it.

    Runs on the card unless ``device`` asks for another. ``cfg`` defaults
    to ``get_smoke(rc.arch)``, the reference's choice; ``params`` (one
    replica's tree) to ``init_params`` from the seed's key; ``draws`` to
    :class:`KeyDraws` on the run's device.
    """

    def __init__(self, rc: TrainRunConfig, *,
                 device: torch.device | str | None = None,
                 cfg: ModelConfig | None = None, params=None,
                 draws: Draws | None = None):
        if rc.recovery not in ("none", "stale", "ef"):
            raise ValueError(f"unknown recovery mode {rc.recovery!r} "
                             "(none | stale | ef)")
        if rc.recovery != "none" and rc.compressor is not None:
            raise ValueError("recovery emulation rides the TAR path; "
                             "clear compressor or set recovery='none'")
        self.rc = rc
        self.device = runtime.resolve_device(device)
        self.cfg = cfg or get_smoke(rc.arch)
        self.draws = draws or KeyDraws(self.device)
        self.key = seed_key(rc.seed)
        n = rc.n_workers
        if params is None:
            params = init_params(self.key, self.cfg, device=self.device)
        self.meta = _layout(params)
        self.length = sum(self.meta[2])
        self.params = tree_map(
            lambda p: p.detach().to(self.device)[None].repeat(
                n, *(1,) * p.dim()), params)
        self.opt = make_optimizer(OptimizerConfig(
            name=rc.optimizer, lr=rc.lr, weight_decay=0.0))
        self.opt_state = self.opt.init(self.params)
        self.data = SyntheticLM(DataConfig(
            vocab_size=self.cfg.vocab_size, seq_len=rc.seq_len,
            global_batch=n * rc.per_worker_batch, seed=rc.seed,
            markov_weight=rc.markov_weight, n_succ=rc.n_succ))
        ev = self.data.global_batch(10**6)
        self.eval_tokens = torch.as_tensor(ev["tokens"]).to(self.device)
        self.eval_labels = torch.as_tensor(ev["labels"]).to(self.device)
        self.state: dict = {}
        self.stale = None
        self.ef = torch.zeros((n, self.length), device=self.device) \
            if rc.recovery == "ef" else None

    def worker_flats(self, batch: dict) -> torch.Tensor:
        """Each worker's gradient of the loss on its rows of the global
        batch, at its own replica, flattened in tree order: (N, L) fp32."""
        rc, b = self.rc, self.rc.per_worker_batch
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        labels = torch.as_tensor(batch["labels"]).to(self.device)
        flats = torch.empty((rc.n_workers, self.length), device=self.device)
        leaves = tree_leaves(self.params)
        for i in range(rc.n_workers):
            mine = [p[i].detach().requires_grad_(True) for p in leaves]
            rows = slice(i * b, (i + 1) * b)
            loss = lm_loss(tree_unflatten(self.params, mine),
                           {"tokens": tokens[rows], "labels": labels[rows]},
                           self.cfg, seq_chunk=rc.seq_len, remat=False)
            off = 0
            for gr in torch.autograd.grad(loss, mine):
                flats[i, off:off + gr.numel()] = gr.reshape(-1)
                off += gr.numel()
        return flats

    def step(self, step: int) -> float:
        """One step: per-worker gradients, the emulated collective, each
        replica's update with its own received bucket. Returns the observed
        drop fraction."""
        rc = self.rc
        flats = self.worker_flats(self.data.global_batch(step))
        skey = fold_in(self.key, step)
        if self.ef is not None:
            flats += self.ef
        if rc.compressor is not None:
            mean_flat, drop = _aggregate(flats, skey, rc, self.state,
                                         draws=self.draws)
            del flats
            buckets = mean_flat[None].expand(rc.n_workers, -1)
        else:
            buckets, drop, extras = _aggregate_per_receiver(
                flats, skey, rc,
                stale=self.stale if rc.recovery != "none" else None,
                want_resid=self.ef is not None, draws=self.draws)
            del flats
            if rc.recovery != "none":
                self.stale = extras["stale"]
            if self.ef is not None:
                self.ef = extras["resid"]
        # each replica's gradient in its parameters' dtype, then its update
        grads = tree_map(lambda g, p: g.to(p.dtype),
                         _unflatten(buckets, self.meta), self.params)
        del buckets
        self.opt.update(grads, self.opt_state, self.params, rc.lr, step)
        return drop

    @torch.no_grad()
    def accuracy(self) -> float:
        """Next-token accuracy of worker 0's replica on the eval batch."""
        p = tree_map(lambda x: x[0], self.params)
        x = forward_hidden(p, {"tokens": self.eval_tokens}, self.cfg,
                           remat=False)
        logits = x.to(torch.float32) @ p["embed"].to(torch.float32).T
        return float(_mean((logits.argmax(-1) == self.eval_labels)
                           .to(torch.float32)))

    @torch.no_grad()
    def divergence(self) -> float:
        """Sum over leaves of the mean population std across replicas."""
        return float(sum(x.to(torch.float32).std(dim=0, correction=0).mean()
                         for x in tree_leaves(self.params)))

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_training(rc: TrainRunConfig, *,
                 device: torch.device | str | None = None,
                 cfg: ModelConfig | None = None, params=None,
                 draws: Draws | None = None) -> dict:
    """Per-worker replica training (the real DDP topology): each of the N
    workers holds a model copy, computes gradients on its batch shard, and
    updates with *its own received bucket* — so stage-2 drops produce real
    replica divergence, the pathology Fig 14 measures. Arguments past
    ``rc`` as for :class:`ReplicaRun`.

    Returns {'steps', 'acc', 'drops', 'divergence', 'mean_drop'} as the
    reference does, and 'step_s': each training step's wall time (the
    device synchronised, the evaluation excluded)."""
    run = ReplicaRun(rc, device=device, cfg=cfg, params=params, draws=draws)
    hist = {"steps": [], "acc": [], "drops": [], "divergence": [],
            "step_s": []}
    for step in range(rc.steps):
        t0 = time.perf_counter()
        hist["drops"].append(run.step(step))
        run.synchronize()
        hist["step_s"].append(time.perf_counter() - t0)
        if step % rc.eval_every == 0 or step == rc.steps - 1:
            hist["steps"].append(step)
            hist["acc"].append(run.accuracy())
            hist["divergence"].append(run.divergence())
    hist["mean_drop"] = float(np.mean(hist["drops"]))
    return hist


def steps_to_accuracy(hist: dict, target: float) -> int | None:
    for s, a in zip(hist["steps"], hist["acc"]):
        if a >= target:
            return s + 1
    return None
