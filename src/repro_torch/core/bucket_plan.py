"""Static bucketization plan for the gradient-sync engine.

Counterpart of ``src/repro/core/bucket_plan.py``. A ``BucketPlan`` is built
once from a tree's leaf shapes; ``pack`` lays the flat gradient stream (leaf
order of ``jax.tree.flatten``: dict keys sorted) into one ``(B,
bucket_elems)`` batch with the last bucket zero-padded, and ``unpack``
restores leaf shapes and dtypes. When everything fits in one bucket,
``bucket_elems`` shrinks to the total (no padding), as in the reference.

Leading axes ride along: packing a tree whose leaves carry a leading peer
axis ``(P, *shape)`` gives ``(P, B, bucket_elems)``, and ``unpack`` of such a
stack gives leaves ``(P, *shape)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

from .keys import Key, fold_in


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    like: object                          # tree structure (leaves ignored)
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    bucket_elems: int
    num_buckets: int

    @classmethod
    def for_tree(cls, tree, bucket_elems: int) -> "BucketPlan":
        leaves = tree_leaves(tree)
        shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        dtypes = tuple(leaf.dtype for leaf in leaves)
        total = sum(math.prod(s) for s in shapes)
        num_buckets = max(1, -(-total // bucket_elems))
        if num_buckets == 1:
            bucket_elems = total          # single bucket: no tail padding
        return cls(like=tree, shapes=shapes, dtypes=dtypes,
                   bucket_elems=bucket_elems, num_buckets=num_buckets)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def padded(self) -> int:
        return self.num_buckets * self.bucket_elems

    @property
    def offsets(self) -> tuple[int, ...]:
        """Flat-stream start offset of each leaf (tree order)."""
        offs, off = [], 0
        for size in self.sizes:
            offs.append(off)
            off += size
        return tuple(offs)

    def _lead(self, leaf: torch.Tensor) -> tuple[int, ...]:
        return tuple(leaf.shape[:leaf.dim() - len(self.shapes[0])])

    def pack(self, tree, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Flatten leaves (tree order) into ``lead + (B, bucket_elems)``."""
        leaves = tree_leaves(tree)
        lead = self._lead(leaves[0])
        out = torch.zeros(lead + (self.padded,), dtype=dtype,
                          device=leaves[0].device)
        self._write(out, leaves, accumulate=False)
        return out.view(lead + (self.num_buckets, self.bucket_elems))

    def pack_into(self, arena: torch.Tensor, tree, *,
                  accumulate: bool = False) -> torch.Tensor:
        """Pack (or, with ``accumulate``, add) ``tree`` into the contiguous
        ``(B, bucket_elems)`` arena in place — the trainer's packed
        gradient arena, with no per-leaf accumulator tree. Padding is left
        as it is (zero from the arena's allocation)."""
        if arena.shape[-2:] != (self.num_buckets, self.bucket_elems) or \
                not arena.is_contiguous():
            raise ValueError("arena must be a contiguous (B, bucket_elems) "
                             "tensor of this plan")
        self._write(arena.view(arena.shape[:-2] + (self.padded,)),
                    tree_leaves(tree), accumulate=accumulate)
        return arena

    def _write(self, flat: torch.Tensor, leaves, *, accumulate: bool):
        lead = flat.shape[:-1]
        for leaf, off, size in zip(leaves, self.offsets, self.sizes):
            dst = flat[..., off:off + size]
            src = leaf.reshape(lead + (size,)).to(flat.dtype)
            if accumulate:
                dst += src
            else:
                dst.copy_(src)

    def unpack(self, batch: torch.Tensor):
        """Inverse of ``pack``: ``lead + (B, bucket_elems)`` -> the tree,
        each leaf cast back to its dtype."""
        lead = tuple(batch.shape[:-2])
        flat = batch.reshape(lead + (-1,))
        leaves = [flat[..., off:off + size].reshape(lead + shape).to(dtype)
                  for off, size, shape, dtype in
                  zip(self.offsets, self.sizes, self.shapes, self.dtypes)]
        return tree_unflatten(self.like, leaves)

    def bucket_keys(self, k: Key) -> list[Key]:
        return bucket_keys(k, self.num_buckets)


def bucket_keys(k: Key, num_buckets: int) -> list[Key]:
    """Per-bucket keys ``fold_in(key, b)``: the reference's derivation
    (``core/bucket_plan.py:107-112``)."""
    return [fold_in(k, b) for b in range(num_buckets)]
