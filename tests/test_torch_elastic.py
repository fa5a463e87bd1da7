"""The port's elastic resharding (``repro_torch/train/elastic.py``) on the
CPU: shards -> full -> shards round trips across worker counts, and
bitwise equality with the reference's ``repro.train.elastic`` on the same
weights.

The reference side runs once, in one child process: ``gpt2-smoke`` weights
from ``init_params(PRNGKey(0), cfg, tp=T)`` for T = 1, 2, its ``reshard``
to 4 workers, ``gather_shards`` of those and ``reshard`` of that to 2,
every leaf written to an ``.npz``. The port takes the same weights
(``repro_torch.weights.tensor_from_numpy``) and must give the same shards
and the same gathered leaves bit for bit: the functions only split and
join.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.keys import key
from repro_torch.models import init_params
from repro_torch.models.transformer import param_table, _map_table
from repro_torch.train.elastic import gather_shards, reshard
from repro_torch.tree import tree_leaves, tree_unflatten
from repro_torch.weights import tensor_from_numpy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TPS = (1, 2)

CHILD = r"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams
import sys
import jax
import numpy as np
from repro.configs import get_smoke
from repro.models import init_params
from repro.train.elastic import gather_shards, reshard

out_path = sys.argv[1]
cfg = get_smoke("gpt2-paper")
save = {}
for tp in (1, 2):
    params = init_params(jax.random.PRNGKey(0), cfg, tp=tp)
    trees = {"init": [params]}
    trees["shards4"] = reshard(params, cfg, 4, tp=tp)
    full = gather_shards(trees["shards4"], cfg, tp=tp)
    trees["full"] = [full]
    trees["shards2"] = reshard(full, cfg, 2, tp=tp)
    for name, ts in trees.items():
        for w, t in enumerate(ts):
            for i, leaf in enumerate(jax.tree.leaves(t)):
                save[f"tp{tp}/{name}/{w}/{i}"] = np.asarray(leaf)
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_elastic") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _params(seed=0, tp=1):
    cfg = get_smoke("gpt2-paper")
    return cfg, init_params(key(seed), cfg, device="cpu", tp=tp)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _ref_trees(ref, like, tp, name, n):
    return [tree_unflatten(like, [
        tensor_from_numpy(ref[f"tp{tp}/{name}/{w}/{i}"])
        for i in range(len(tree_leaves(like)))]) for w in range(n)]


def test_reshard_roundtrip():
    """4 shards -> full -> 2 shards -> full, bitwise at every stage."""
    cfg, params = _params()
    shards4 = reshard(params, cfg, 4)
    assert len(shards4) == 4
    full = gather_shards(shards4, cfg)
    assert _equal(full, params)
    shards2 = reshard(full, cfg, 2)
    assert len(shards2) == 2
    assert _equal(gather_shards(shards2, cfg), params)


@pytest.mark.parametrize("tp", TPS)
def test_shards_partition_fsdp_dims(tp):
    """Every sharded leaf splits evenly along its fsdp dim and the pieces
    concatenate back to it; replicated leaves go whole to every worker."""
    cfg, params = _params(1, tp)
    n = 2
    shards = reshard(params, cfg, n, tp=tp)
    dims = tree_leaves(_map_table(lambda leaf: leaf.fsdp_dim, param_table(
        cfg, tp=tp, fsdp_axes=("data",))))
    flats = [tree_leaves(s) for s in shards]
    assert any(d is not None for d in dims) and None in dims
    for i, (leaf, dim) in enumerate(zip(tree_leaves(params), dims)):
        parts = [f[i] for f in flats]
        if dim is None:
            assert all(p is leaf for p in parts)
            continue
        assert all(p.shape[dim] * n == leaf.shape[dim] for p in parts)
        assert torch.equal(torch.cat(parts, dim), leaf)
    # w_gate's fsdp dim is 1 (D) in the (L, D, F) layout, as the
    # reference's test pins
    w_full = params["stages"][0]["w_gate"]
    assert shards[0]["stages"][0]["w_gate"].shape[1] * 2 == w_full.shape[1]


@pytest.mark.parametrize("tp", TPS)
def test_matches_reference(ref, tp):
    """On the reference's weights, the port's shards and gathered trees
    are the reference's bit for bit."""
    cfg, like = _params(0, tp)
    (params,) = _ref_trees(ref, like, tp, "init", 1)
    shards4 = reshard(params, cfg, 4, tp=tp)
    assert all(_equal(a, b) for a, b in zip(
        shards4, _ref_trees(ref, like, tp, "shards4", 4)))
    full = gather_shards(shards4, cfg, tp=tp)
    (want_full,) = _ref_trees(ref, like, tp, "full", 1)
    assert _equal(full, want_full) and _equal(full, params)
    shards2 = reshard(full, cfg, 2, tp=tp)
    assert all(_equal(a, b) for a, b in zip(
        shards2, _ref_trees(ref, like, tp, "shards2", 2)))


def test_indivisible_split_raises():
    """A worker count that does not divide a leaf's fsdp dim raises, as the
    reference's assert does (d_model 64 over 3 workers)."""
    cfg, params = _params()
    with pytest.raises(ValueError, match="does not split over 3 workers"):
        reshard(params, cfg, 3)
