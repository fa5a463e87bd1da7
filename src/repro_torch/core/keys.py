"""Counter-based keys for the port's draws: the counterpart of
``jax.random.PRNGKey`` / ``fold_in``.

A key is a tuple of integers and ``fold_in`` appends one, so the reference's
derivations carry over name for name: the step key ``fold_in(key, step)``,
the sync key ``fold_in(step_key, 7)``, a bucket's key ``fold_in(sync_key,
b)`` and a receiver's mask key ``fold_in(bucket_key, r)``. A key seeds a
``torch.Generator`` through a hash of the whole tuple. The numbers are the
port's own: they do not reproduce threefry's bits (ROADMAP A2).
"""
from __future__ import annotations

import hashlib
import struct

import torch

Key = tuple[int, ...]


def key(seed: int) -> Key:
    return (int(seed),)


def fold_in(k: Key, data: int) -> Key:
    return (*k, int(data))


def seed_of(k: Key) -> int:
    raw = struct.pack(f"<{len(k)}q", *k)
    digest = hashlib.blake2b(raw, digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x7FFF_FFFF_FFFF_FFFF


def generator(k: Key, device: torch.device | str = "cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(k))
    return gen
