"""Gradient-drop models: the stand-in for UBT packet loss (DESIGN §2).

Counterpart of ``src/repro/core/drops.py``. A mask entry of 0 means "this
sender's packet for these entries did not arrive before the adaptive
timeout". Masks are drawn at packet granularity (``packet_elems``
consecutive entries share one fate) and then expanded elementwise.

Patterns: ``bernoulli`` (i.i.d. packet loss), ``tail`` (a timed-out peer
loses the end of its stream), ``straggler`` (whole peers miss the round) and
``burst`` (Gilbert–Elliott two-state Markov loss).

Draws come from an explicit ``torch.Generator``: the same generator state
gives the same mask, but not the reference's threefry bits, so the tests
compare these masks with the reference's by distribution and inject the
reference's own masks where values must agree.
"""
from __future__ import annotations

import torch


def _expand(packet_mask: torch.Tensor, n_elems: int,
            packet_elems: int) -> torch.Tensor:
    m = torch.repeat_interleave(packet_mask, packet_elems, dim=-1)
    return m[..., :n_elems]


def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def bernoulli_mask(gen: torch.Generator, n_peers: int, n_elems: int, *,
                   rate: float, packet_elems: int = 256) -> torch.Tensor:
    """(n_peers, n_elems) 0/1 mask; P(drop a packet) = rate."""
    n_pkts = -(-n_elems // packet_elems)
    keep = _rand(gen, (n_peers, n_pkts)) < (1.0 - rate)
    return _expand(keep.to(torch.float32), n_elems, packet_elems)


def tail_mask(gen: torch.Generator, n_peers: int, n_elems: int, *,
              rate: float, packet_elems: int = 256) -> torch.Tensor:
    """Drop the trailing packets of a random subset of peers: each peer
    times out with probability min(1, 4*rate) and then loses its last
    rate/p_timeout fraction of packets, so the expected loss is ``rate``."""
    n_pkts = -(-n_elems // packet_elems)
    # fp32 throughout, as the reference computes the cut
    rate_t = torch.tensor(rate, dtype=torch.float32, device=gen.device)
    p_timeout = torch.clamp(4.0 * rate_t, max=1.0)
    timed_out = _rand(gen, (n_peers, 1)) < p_timeout
    cut_frac = torch.where(p_timeout > 0,
                           rate_t / torch.clamp(p_timeout, min=1e-9),
                           torch.zeros_like(rate_t))
    cut_start = torch.floor((1.0 - cut_frac) * n_pkts)
    idx = torch.arange(n_pkts, device=gen.device)[None, :]
    keep = ~(timed_out & (idx >= cut_start))
    return _expand(keep.to(torch.float32), n_elems, packet_elems)


def straggler_mask(gen: torch.Generator, n_peers: int, n_elems: int, *,
                   rate: float, packet_elems: int = 256) -> torch.Tensor:
    """Whole peers miss the round with probability ``rate``."""
    del packet_elems
    keep = _rand(gen, (n_peers, 1)) < (1.0 - rate)
    return keep.to(torch.float32).expand(n_peers, n_elems).contiguous()


BURST_MEAN_PKTS = 8.0


def gilbert_elliott_params(rate: float, mean_burst: float = BURST_MEAN_PKTS
                           ) -> tuple[float, float]:
    """(p, r) transition probabilities of a two-state Gilbert–Elliott chain:
    stationary loss p/(p+r) == ``rate``, mean bad run 1/r == ``mean_burst``."""
    rate = min(max(float(rate), 0.0), 0.999)
    r = 1.0 / max(float(mean_burst), 1.0)
    p = min(1.0, r * rate / max(1.0 - rate, 1e-6))
    return p, r


def _geometric(gen: torch.Generator, q: torch.Tensor) -> torch.Tensor:
    """Run lengths >= 1 with P(leave after each packet) = q (broadcast)."""
    u = _rand(gen, q.shape).clamp_min(torch.finfo(torch.float32).tiny)
    stay = torch.log1p(-q.clamp(max=1.0 - 1e-7))
    return 1 + torch.floor(torch.log(u) / stay).clamp(max=2 ** 30)


def burst_mask(gen: torch.Generator, n_peers: int, n_elems: int, *,
               rate: float, packet_elems: int = 256,
               mean_burst: float = BURST_MEAN_PKTS) -> torch.Tensor:
    """Gilbert–Elliott bursty loss, packet-granular, one chain per peer.

    The reference steps the chain packet by packet (``lax.scan``); here the
    same chain is drawn as alternating geometric run lengths (Good runs
    leave with probability p, Bad runs with r), started from the stationary
    state, which is the same process without a loop over packets.
    """
    n_pkts = -(-n_elems // packet_elems)
    p, r = gilbert_elliott_params(rate, mean_burst)
    dev = gen.device
    bad0 = _rand(gen, (n_peers,)) < min(rate, 0.999)
    # enough runs to cover n_pkts with overwhelming probability; extended
    # below in the rare case they do not
    n_runs = max(8, int(2.5 * n_pkts * 2 * p * r / max(p + r, 1e-9)) + 16)
    leave = torch.empty((n_peers, 0), device=dev)
    while True:
        extra = torch.arange(leave.shape[1], leave.shape[1] + n_runs,
                             device=dev)
        # run j is Bad iff bad0 xor (j odd)
        is_bad = bad0[:, None] ^ (extra[None, :] % 2 == 1)
        q = torch.where(is_bad, torch.tensor(r, device=dev),
                        torch.tensor(p, device=dev))
        leave = torch.cat([leave, _geometric(gen, q)], dim=1)
        if bool((leave.sum(dim=1) >= n_pkts).all()):
            break
    ends = torch.cumsum(leave, dim=1)                      # run end offsets
    pkt = torch.arange(n_pkts, device=dev, dtype=ends.dtype)
    run = torch.searchsorted(ends, pkt.expand(n_peers, n_pkts).contiguous(),
                             right=True)
    bad = bad0[:, None] ^ (run % 2 == 1)
    return _expand((~bad).to(torch.float32), n_elems, packet_elems)


_PATTERNS = {
    "bernoulli": bernoulli_mask,
    "tail": tail_mask,
    "straggler": straggler_mask,
    "burst": burst_mask,
}


def make_mask(pattern: str, gen: torch.Generator, n_peers: int,
              n_elems: int, *, rate: float, packet_elems: int = 256,
              self_index: int | None = None) -> torch.Tensor:
    """Dispatch on drop pattern. A node never drops its own contribution
    (it is local), so row ``self_index`` is forced to 1 when given."""
    if rate <= 0.0:
        return torch.ones((n_peers, n_elems), dtype=torch.float32,
                          device=gen.device)
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown drop pattern {pattern!r}; one of "
                         f"{tuple(_PATTERNS)}")
    mask = _PATTERNS[pattern](gen, n_peers, n_elems, rate=rate,
                              packet_elems=packet_elems)
    if self_index is not None:
        mask[self_index] = 1.0
    return mask


def loss_fraction(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of gradient entries lost this round (monitored by §3.4)."""
    return 1.0 - mask.to(torch.float32).mean()

