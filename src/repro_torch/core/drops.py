"""Gradient-drop models: the stand-in for UBT packet loss (DESIGN §2).

Counterpart of ``src/repro/core/drops.py``. A mask entry of 0 means "this
sender's packet for these entries did not arrive before the adaptive
timeout". Masks are drawn at packet granularity (``packet_elems``
consecutive entries share one fate) and then expanded elementwise.

Patterns: ``bernoulli`` (i.i.d. packet loss), ``tail`` (a timed-out peer
loses the end of its stream), ``straggler`` (whole peers miss the round) and
``burst`` (Gilbert–Elliott two-state Markov loss).

Every pattern draws from its key as the reference does, with the same
threefry bits (``core/keys.py``), so a mask equals the reference's bit for
bit: ``bernoulli`` and ``straggler`` one Bernoulli draw, ``tail`` a
Bernoulli ``(n_peers, 1)`` draw under ``split(key)[0]``, ``burst`` a
``(n_peers,)`` and a ``(n_pkts, n_peers)`` uniform draw under the two keys
of ``split(key)``. The functions take a batch of ``(K, 2)`` keys (one
receiver's mask a key) and draw each pattern's operands for all K in one
kernel launch on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from . import keys as keys_lib
from .collectives import index


def _expand(packet_mask: torch.Tensor, n_elems: int,
            packet_elems: int) -> torch.Tensor:
    m = torch.repeat_interleave(packet_mask, packet_elems, dim=-1)
    return m[..., :n_elems]


def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def _split_keys(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``split(k)`` for a batch: the keys folded with 0 and with 1."""
    return (keys_lib.fold_in_many(keys, np.zeros(len(keys), np.int64)),
            keys_lib.fold_in_many(keys, np.ones(len(keys), np.int64)))


def _bernoulli(keys, n_peers: int, n_elems: int, *, rate: float,
                   packet_elems: int = 256, device="cpu") -> torch.Tensor:
    """(K, n_peers, n_elems) 0/1 masks; P(drop a packet) = rate."""
    n_pkts = -(-n_elems // packet_elems)
    keep = keys_lib.bernoulli_batch(keys, 1.0 - rate, n_peers * n_pkts,
                                    device)
    return _expand(keep.to(torch.float32).view(-1, n_peers, n_pkts),
                   n_elems, packet_elems)


def _tail(keys, n_peers: int, n_elems: int, *, rate: float,
              packet_elems: int = 256, device="cpu") -> torch.Tensor:
    """Drop the trailing packets of a random subset of peers: each peer
    times out with probability min(1, 4*rate) and then loses its last
    rate/p_timeout fraction of packets, so the expected loss is ``rate``."""
    n_pkts = -(-n_elems // packet_elems)
    k_to, _ = _split_keys(keys_lib.batch_keys(keys))
    # fp32 throughout, as the reference computes the cut
    p_timeout = float(np.float32(min(1.0, 4.0 * rate)))
    timed_out = keys_lib.bernoulli_batch(k_to, p_timeout, n_peers, device)
    rate_t, p_t = _f32(rate, device), _f32(p_timeout, device)
    cut_frac = torch.where(p_t > 0, rate_t / torch.clamp(p_t, min=1e-9),
                           torch.zeros_like(rate_t))
    cut_start = torch.floor((1.0 - cut_frac) * n_pkts)
    idx = torch.arange(n_pkts, device=device)[None, None, :]
    keep = ~(timed_out[:, :, None] & (idx >= cut_start))
    return _expand(keep.to(torch.float32), n_elems, packet_elems)


def _straggler(keys, n_peers: int, n_elems: int, *, rate: float,
                   packet_elems: int = 256, device="cpu") -> torch.Tensor:
    """Whole peers miss the round with probability ``rate``."""
    del packet_elems
    keep = keys_lib.bernoulli_batch(keys, 1.0 - rate, n_peers, device)
    return keep.to(torch.float32)[:, :, None].expand(
        -1, n_peers, n_elems).contiguous()


BURST_MEAN_PKTS = 8.0


def gilbert_elliott_params(rate: float, mean_burst: float = BURST_MEAN_PKTS
                           ) -> tuple[float, float]:
    """(p, r) transition probabilities of a two-state Gilbert–Elliott chain:
    stationary loss p/(p+r) == ``rate``, mean bad run 1/r == ``mean_burst``."""
    rate = min(max(float(rate), 0.0), 0.999)
    r = 1.0 / max(float(mean_burst), 1.0)
    p = min(1.0, r * rate / max(1.0 - rate, 1e-6))
    return p, r


def _burst(keys, n_peers: int, n_elems: int, *, rate: float,
               packet_elems: int = 256, mean_burst: float = BURST_MEAN_PKTS,
               device="cpu") -> torch.Tensor:
    """Gilbert–Elliott bursty loss, packet-granular, one chain a peer.

    The reference steps the chain packet by packet (``lax.scan``:
    ``bad_t = u_t >= r if bad_{t-1} else u_t < p``) over the same uniforms.
    Each step maps the previous state through one of four functions of it:
    a constant (both branches agree), the identity or the negation. So the
    state at t is the value of the last constant step at or before t (the
    initial state when there is none), flipped once per negating step since:
    a cumulative max and a cumulative sum over the packets, the same
    booleans without a loop."""
    n_pkts = -(-n_elems // packet_elems)
    p, r = gilbert_elliott_params(rate, mean_burst)
    k0, k1 = _split_keys(keys_lib.batch_keys(keys))
    bad0 = keys_lib.uniform_batch(k0, n_peers, device) < _f32(
        min(rate, 0.999), device)                              # (K, n)
    u = keys_lib.uniform_batch(k1, n_pkts * n_peers, device)
    u = u.view(-1, n_pkts, n_peers).transpose(1, 2)            # (K, n, T)
    from_good = u < _f32(p, device)
    from_bad = u >= _f32(r, device)
    const = from_good == from_bad
    flip = from_good & ~from_bad
    t = torch.arange(n_pkts, device=device)
    last = torch.cummax(torch.where(const, t, -1), dim=-1).values
    seen = last >= 0
    at = last.clamp(min=0)
    value = torch.where(seen, from_good.gather(-1, at), bad0[:, :, None])
    flips = torch.cumsum(flip.to(torch.int64), dim=-1)
    since = flips - torch.where(seen, flips.gather(-1, at),
                                torch.zeros_like(flips))
    bad = value ^ (since % 2 == 1)
    return _expand((~bad).to(torch.float32), n_elems, packet_elems)


_PATTERNS = {
    "bernoulli": _bernoulli,
    "tail": _tail,
    "straggler": _straggler,
    "burst": _burst,
}


def _single(pattern: str):
    def one(key: keys_lib.Key, n_peers: int, n_elems: int, *, rate: float,
            packet_elems: int = 256, device="cpu", **kw) -> torch.Tensor:
        return _PATTERNS[pattern]([key], n_peers, n_elems, rate=rate,
                                  packet_elems=packet_elems, device=device,
                                  **kw)[0]
    one.__name__ = f"{pattern}_mask"
    one.__doc__ = (f"One ``(n_peers, n_elems)`` {pattern} mask under "
                   "``key`` (the reference's function of the same name).")
    return one


bernoulli_mask = _single("bernoulli")
tail_mask = _single("tail")
straggler_mask = _single("straggler")
burst_mask = _single("burst")


def make_masks(pattern: str, keys, n_peers: int, n_elems: int, *,
               rate: float, packet_elems: int = 256,
               self_index=None, device="cpu") -> torch.Tensor:
    """``(K, n_peers, n_elems)``: one mask a key of the ``(K, 2)`` batch.
    A node never drops its own contribution (it is local), so row
    ``self_index[k]`` of mask k is forced to 1 when given."""
    k = keys_lib.batch_keys(keys)
    if rate <= 0.0:
        return torch.ones((k.shape[0], n_peers, n_elems),
                          dtype=torch.float32, device=device)
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown drop pattern {pattern!r}; one of "
                         f"{tuple(_PATTERNS)}")
    mask = _PATTERNS[pattern](k, n_peers, n_elems, rate=rate,
                              packet_elems=packet_elems, device=device)
    if self_index is not None:
        device = mask.device
        mask[index(tuple(range(k.shape[0])), device),
             index(tuple(int(i) for i in self_index), device)] = 1.0
    return mask


def make_mask(pattern: str, key: keys_lib.Key, n_peers: int, n_elems: int,
              *, rate: float, packet_elems: int = 256,
              self_index: int | None = None, device="cpu") -> torch.Tensor:
    """One ``(n_peers, n_elems)`` mask under ``key`` (the reference's
    ``make_mask``)."""
    return make_masks(pattern, [key], n_peers, n_elems, rate=rate,
                      packet_elems=packet_elems,
                      self_index=None if self_index is None else [self_index],
                      device=device)[0]


def loss_fraction(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of gradient entries lost this round (monitored by §3.4)."""
    return 1.0 - mask.to(torch.float32).mean()
