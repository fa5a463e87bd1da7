"""Checkpoints: one ``.npy`` file a leaf plus a JSON manifest, written in
the background, a ring of the last few, and exact restart.

Counterpart of ``src/repro/train/checkpoint.py``, in its on-disk layout:

  <dir>/step_00000100/
      manifest.json        # step, tree structure, leaf dtypes/shapes, meta
      leaf_00000.npy ...   # one file a leaf, in ``tree_leaves`` order

Leaves are taken in ``repro_torch.tree.tree_leaves`` order, which is
``jax.tree.flatten``'s, so leaf i of a checkpoint of the port is leaf i of
the reference's for the same tree, and either package restores the other's
fp32 leaves. numpy has no bfloat16 without ``ml_dtypes``: a bf16 leaf is
written as its ``uint16`` bits with ``"dtype": "bfloat16"`` in the manifest
and read back by that dtype (a reference checkpoint's bf16 leaves load as
``|V2`` bytes, the same bits, and restore the same way).

The launcher checkpoints ``(params, opt_state)``, or ``(params, opt_state,
rec_state)`` with ``--recovery`` on; :func:`restore` rejects a manifest
whose leaf count differs from the tree it restores into (a resume whose
``--recovery`` changed). A write that fails raises, from
:meth:`AsyncCheckpointer.wait` when it ran in the background.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _structure(tree) -> str:
    return str(tree_map(lambda _: "*", tree))


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    t = leaf.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save(ckpt_dir: str, step: int, tree: Any, *, meta: dict | None = None,
         keep: int = 3) -> str:
    """Synchronous checkpoint write. Returns the step directory."""
    leaves = tree_leaves(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {
        "step": int(step),
        "treedef": _structure(tree),
        "n_leaves": len(leaves),
        "leaves": [],
        "meta": meta or {},
        "process_index": 0,
    }
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp_dir, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({"dtype": dtype, "shape": list(arr.shape)})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # the rename makes a partly written checkpoint invisible to restore
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    _gc(ckpt_dir, keep)
    return step_dir


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


class AsyncCheckpointer:
    """Background-thread saver: the loop blocks only for the host copy.

    :meth:`save` copies every leaf to the host before it returns (the next
    step updates parameters, moments and recovery state in place), then
    writes on a thread. :meth:`wait` joins it and re-raises its error.
    ``copy_s`` and ``write_s`` hold each save's host-copy and write
    seconds."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.copy_s: list[float] = []
        self.write_s: list[float] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self.copy_s.append(time.perf_counter() - t0)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, meta), daemon=True)
        self._thread.start()

    def _write(self, step: int, tree: Any, meta: dict | None) -> None:
        t0 = time.perf_counter()
        try:
            save(self.ckpt_dir, step, tree, meta=meta, keep=self.keep)
        except BaseException as e:          # handed to wait(), not logged
            self._error = e
            return
        self.write_s.append(time.perf_counter() - t0)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, *, step: int | None = None,
            device: torch.device | str = "cpu") -> tuple[int, Any, dict]:
    """Restore into the structure of ``tree_like``, every leaf on
    ``device``. Returns ``(step, tree, meta)``. Raises FileNotFoundError if
    there is nothing to restore and ValueError if the leaf counts differ."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    n_like = len(tree_leaves(tree_like))
    if manifest["n_leaves"] != n_like:
        raise ValueError(f"checkpoint {step_dir} holds {manifest['n_leaves']} "
                         f"leaves, the tree to restore {n_like}")
    leaves = [_from_numpy(np.load(os.path.join(step_dir, f"leaf_{i:05d}.npy")),
                          info["dtype"]).to(device)
              for i, info in enumerate(manifest["leaves"])]
    return step, tree_unflatten(tree_like, leaves), manifest["meta"]
