"""Deterministic synthetic LM data pipeline, host-sharded and resumable.

Each (step, host) pair maps to a unique PRNG stream, so:
  * every host loads only its shard (no cross-host I/O),
  * a restarted job regenerates exactly the batches it would have seen
    (checkpoint/restart determinism — fault-tolerance story),
  * elastic rescaling (N -> N') re-partitions the same global stream.

Tokens follow a Zipf-like marginal with short-range Markov structure so a
small LM has actual signal to learn (used by the TTA benchmarks, where real
convergence curves are required).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.3
    markov_weight: float = 0.7     # next-token dependence strength
    n_succ: int = 4                # successors per token (1 = deterministic)


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.marginal = p / p.sum()
        # a sparse deterministic "grammar": each token prefers a few successors
        self.succ = rng.integers(0, v, size=(v, cfg.n_succ))

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.marginal)
        follow = rng.random((b, s)) < cfg.markov_weight
        succ_pick = rng.integers(0, cfg.n_succ, size=(b, s))
        fresh = rng.choice(cfg.vocab_size, size=(b, s), p=self.marginal)
        for t in range(s):
            nxt = self.succ[toks[:, t], succ_pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_batch(self, step: int, host: int, n_hosts: int
                   ) -> dict[str, np.ndarray]:
        """This host's contiguous slice of the global batch."""
        g = self.global_batch(step)
        b = self.cfg.global_batch
        assert b % n_hosts == 0, (b, n_hosts)
        lo = host * (b // n_hosts)
        hi = lo + b // n_hosts
        return {k: v[lo:hi] for k, v in g.items()}
