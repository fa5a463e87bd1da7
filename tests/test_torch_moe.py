"""The port's Mixture-of-Experts (``repro_torch/models/moe.py``) against the
JAX package's ``moe_block`` and ``moe_aux_loss`` on the same numpy inputs,
in fp32, forward and gradients.

The reference runs once for the file in a subprocess (results handed over
as an ``.npz``). Its routing decisions (each token's top-k experts and
which assignments fit their expert's capacity) are taken with the
reference's own expressions (``src/repro/models/moe.py:45-61``) in the
child; the port's come from ``moe.route``.

Cases: the default capacity factor 1.25 (some experts overflow at random
routing), 0.5 (many assignments dropped), a router wider than the experts
(the padded experts masked to -1e30, never picked) with GELU, and top-1.

Tolerances: routing exactly equal (top-k indices, the kept mask, the
dropped count); outputs and every gradient within 1e-4 of that tensor's
largest magnitude (fp32 products summed in other orders); the auxiliary
loss 1e-5 relative.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models.moe import moe_aux_loss, moe_block, route

REL_TOL = 1e-4
# case -> (batch, seq, d, router width, n_experts, top_k, d_ff,
#          capacity_factor, activation)
CASES = {
    "cap125": (2, 12, 16, 6, 6, 2, 24, 1.25, "silu"),
    "cap050": (2, 12, 16, 6, 6, 2, 24, 0.5, "silu"),
    "padded_gelu": (2, 8, 16, 8, 6, 2, 20, 1.25, "gelu"),
    "top1": (1, 16, 8, 4, 4, 1, 12, 1.0, "silu"),
}
WEIGHTS = ("router", "we_gate", "we_up", "we_down")

CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.models import SINGLE
from repro.models.moe import moe_aux_loss, moe_block

out_path = sys.argv[1]
cases = eval(sys.argv[2])
save = {}
for name, (b, s, d, e_pad, e, k, f, cf, act) in cases.items():
    rng = np.random.default_rng(len(save))
    arrs = {"x": rng.standard_normal((b, s, d)),
            "router": rng.standard_normal((d, e_pad)),
            "we_gate": rng.standard_normal((e_pad, d, f)) / np.sqrt(d),
            "we_up": rng.standard_normal((e_pad, d, f)) / np.sqrt(d),
            "we_down": rng.standard_normal((e_pad, f, d)) / np.sqrt(f),
            "cot": rng.standard_normal((b, s, d))}
    arrs = {n: v.astype(np.float32) for n, v in arrs.items()}
    for n, v in arrs.items():
        save[f"{name}/in/{n}"] = v
    def fwd(x, w):
        return moe_block(x, w, SINGLE, top_k=k, n_experts=e,
                         capacity_factor=cf, activation=act)
    w = {n: jnp.asarray(arrs[n]) for n in ("router", "we_gate", "we_up",
                                           "we_down")}
    x = jnp.asarray(arrs["x"])
    out, vjp = jax.vjp(fwd, x, w)
    gx, gw = vjp(jnp.asarray(arrs["cot"]))
    save[f"{name}/out"] = np.asarray(out)
    save[f"{name}/grad/x"] = np.asarray(gx)
    for n, g in gw.items():
        save[f"{name}/grad/{n}"] = np.asarray(g)
    # the routing, by the reference's expressions
    t = b * s
    xt = x.reshape(t, d)
    logits = jnp.einsum("td,de->te", xt, w["router"]).astype(jnp.float32)
    if e_pad > e:
        logits = jnp.where((jnp.arange(e_pad) >= e)[None, :], -1e30, logits)
    _, gate_idx = jax.lax.top_k(logits, k)
    capacity = max(1, int(cf * k * t / e_pad))
    onehot = jax.nn.one_hot(gate_idx, e_pad, dtype=jnp.int32)
    pos_flat = jnp.cumsum(onehot.reshape(t * k, e_pad), axis=0) - 1
    pos = jnp.take_along_axis(pos_flat.reshape(t, k, e_pad),
                              gate_idx[..., None], axis=-1)[..., 0]
    save[f"{name}/gate_idx"] = np.asarray(gate_idx)
    save[f"{name}/keep"] = np.asarray(pos < capacity)
    save[f"{name}/capacity"] = np.asarray(capacity)
    aux, gaux = jax.value_and_grad(
        lambda lg: moe_aux_loss(lg, gate_idx, e))(logits)
    save[f"{name}/aux"] = np.asarray(aux)
    save[f"{name}/aux_grad"] = np.asarray(gaux)
    save[f"{name}/logits"] = np.asarray(logits)
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_moe") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out),
                           repr(CASES)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _inputs(ref, case, grad=False):
    t = {n: torch.from_numpy(ref[f"{case}/in/{n}"]).requires_grad_(grad)
         for n in ("x", *WEIGHTS)}
    return t["x"], {n: t[n] for n in WEIGHTS}


def _run(ref, case):
    _, _, _, _, e, k, _, cf, act = CASES[case]
    x, w = _inputs(ref, case, grad=True)
    out = moe_block(x, w, top_k=k, n_experts=e, capacity_factor=cf,
                    activation=act)
    cot = torch.from_numpy(ref[f"{case}/in/cot"])
    grads = torch.autograd.grad(out, [x, *w.values()], cot)
    return out.detach(), dict(zip(("x", *WEIGHTS), grads))


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= REL_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_matches_reference(ref, case):
    """The top-k experts and the capacity's kept mask are exactly the
    reference's, so the same tokens are dropped."""
    b, s, d, _, e, k, _, cf, _ = CASES[case]
    x, w = _inputs(ref, case)
    r = route(x.reshape(b * s, d), w["router"], top_k=k, n_experts=e,
              capacity_factor=cf)
    assert r.capacity == int(ref[f"{case}/capacity"])
    np.testing.assert_array_equal(r.gate_idx.numpy(), ref[f"{case}/gate_idx"])
    np.testing.assert_array_equal(r.keep.numpy(), ref[f"{case}/keep"])
    dropped = int((~r.keep).sum())
    assert dropped == int((~ref[f"{case}/keep"]).sum())
    assert int(r.gate_idx.max()) < e          # padded experts never picked
    if case == "cap050":
        assert dropped > 0


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(ref, case):
    out, _ = _run(ref, case)
    _close(out, ref[f"{case}/out"], "out")


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_grads_match_reference(ref, case):
    _, grads = _run(ref, case)
    for name, g in grads.items():
        _close(g, ref[f"{case}/grad/{name}"], name)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_aux_loss_matches_reference(ref, case):
    e = CASES[case][4]
    logits = torch.from_numpy(ref[f"{case}/logits"]).requires_grad_(True)
    idx = torch.from_numpy(ref[f"{case}/gate_idx"]).long()
    aux = moe_aux_loss(logits, idx, e)
    (g,) = torch.autograd.grad(aux, [logits])
    assert float(aux.detach()) == pytest.approx(float(ref[f"{case}/aux"]),
                                                rel=1e-5)
    _close(g, ref[f"{case}/aux_grad"], "aux grad")


def test_dropped_assignments_contribute_nothing(ref):
    """A token whose every assignment is dropped gets exactly zero, and the
    dispatch's zero contributions leave the kept ones exact: the block's
    output equals the per-token sum over the kept experts computed
    directly."""
    case = "cap050"
    b, s, d, _, e, k, _, cf, act = CASES[case]
    x, w = _inputs(ref, case)
    with torch.no_grad():
        out = moe_block(x, w, top_k=k, n_experts=e, capacity_factor=cf,
                        activation=act).reshape(b * s, d)
        r = route(x.reshape(b * s, d), w["router"], top_k=k, n_experts=e,
                  capacity_factor=cf)
        xt = x.reshape(b * s, d)
        want = torch.zeros_like(xt)
        for i in range(b * s):
            for j in range(k):
                if r.keep[i, j]:
                    ex = int(r.gate_idx[i, j])
                    h = torch.nn.functional.silu(xt[i] @ w["we_gate"][ex]) * (
                        xt[i] @ w["we_up"][ex])
                    want[i] += (h @ w["we_down"][ex]) * r.gates[i, j]
    none_kept = ~r.keep.any(dim=1)
    assert bool(none_kept.any())
    assert bool((out[none_kept] == 0).all())
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_weights_stationary_raises():
    """The weights-stationary form (serving) raises where d_model does not
    split over the data peers; where it does, with one batch every peer
    holds, it is the plain form up to the rounding of the partial sums."""
    from repro_torch.models.parallel import ParallelCtx
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 4, generator=gen)
    w = {"router": torch.randn(4, 2, generator=gen),
         "we_gate": torch.randn(2, 4, 3, generator=gen),
         "we_up": torch.randn(2, 4, 3, generator=gen),
         "we_down": torch.randn(2, 3, 4, generator=gen)}
    three = ParallelCtx(dp_axis="data", fsdp=True, sizes={"data": 3})
    with pytest.raises(ValueError, match="split"):
        moe_block(x, w, top_k=1, n_experts=2, weights_stationary=True,
                  pctx=three)
    two = ParallelCtx(dp_axis="data", fsdp=True, moe_stationary=True,
                      sizes={"data": 2})
    got = moe_block(x, w, top_k=1, n_experts=2, weights_stationary=True,
                    pctx=two)
    torch.testing.assert_close(got, moe_block(x, w, top_k=1, n_experts=2),
                               atol=1e-6, rtol=1e-6)
