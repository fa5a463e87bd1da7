"""The port's Mamba-2 layer (``repro_torch/models/ssm.py``) against the JAX
package's ``src/repro/models/ssm.py`` on the same numpy inputs, in fp32,
forward and gradients; and the chunked form against the one-token
recurrence, the port's counterpart of ``tests/test_ssd.py``.

The reference runs once for the file in a subprocess (results handed over
as an ``.npz``): ``_causal_conv`` without and with a carried state;
``ssd_chunked`` with a whole number of chunks, with a padded tail (13
steps in chunks of 8), and with an ``init_state``; ``ssd_decode_step``;
``mamba2_forward`` with ``decode`` False (a padded tail, with and without a
carried ``SSMState``) and True. Gradients are the VJP of a fixed random
cotangent on every output.

Tolerances: outputs, states and every gradient within 1e-4 of that
tensor's largest magnitude (fp32 sums in other orders: the port's
two-operand einsums multiply the third factor in first); the chunked form
against the recurrence 1e-4 absolute, split runs 1e-5, as
``tests/test_ssd.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models.ssm import (SSMState, _causal_conv, _segsum,
                                    mamba2_forward, ssd_chunked,
                                    ssd_decode_step)

REL_TOL = 1e-4
B, H, P, N, G = 2, 4, 8, 16, 2
# ssd case -> (seq, chunk, with init_state)
SSD_CASES = {"whole": (16, 8, False), "padded": (13, 8, False),
             "init_state": (16, 4, True)}
D, K = 24, 4          # mamba2_forward: d_model, conv width
M_H, M_P, M_N = 4, 12, 8   # heads, head dim (d_inner 48), state
# mamba case -> (seq, chunk, decode, carried state)
MAMBA_CASES = {"train": (12, 8, False, False),
               "train_state": (12, 8, False, True),
               "decode": (1, 8, True, True)}

CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams
from repro.models import SINGLE
from repro.models.ssm import (SSMState, _causal_conv, _segsum,
                              mamba2_forward, ssd_chunked, ssd_decode_step)

out_path = sys.argv[1]
B, H, P, N, G, D, K, MH, MP, MN = (int(v) for v in sys.argv[2:12])
ssd_cases, mamba_cases = eval(sys.argv[12]), eval(sys.argv[13])
save = {}
rng = np.random.default_rng(0)
def rnd(*shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)
def put(prefix, **arrs):
    for n, v in arrs.items():
        save[f"{prefix}/{n}"] = np.asarray(v)

seg_x = rnd(3, 6)
put("segsum", x=seg_x, out=_segsum(jnp.asarray(seg_x)))

cx, cw, cs = rnd(2, 9, 12), rnd(4, 12), rnd(2, 3, 12)
for name, st in (("nostate", None), ("state", cs)):
    y, new = _causal_conv(jnp.asarray(cx), jnp.asarray(cw),
                          None if st is None else jnp.asarray(st))
    put(f"conv/{name}", y=y, state=new)
put("conv/in", x=cx, w=cw, state=cs)

for name, (s, chunk, with_init) in ssd_cases.items():
    x, b, c = rnd(B, s, H, P), rnd(B, s, G, N, scale=0.3), \
        rnd(B, s, G, N, scale=0.3)
    dt = np.log1p(np.exp(rnd(B, s, H))).astype(np.float32)
    a_log = np.log(rng.uniform(1.0, 4.0, H)).astype(np.float32)
    init = rnd(B, H, P, N, scale=0.5)
    cy, cst = rnd(B, s, H, P), rnd(B, H, P, N)
    put(f"ssd/{name}/in", x=x, dt=dt, a_log=a_log, b=b, c=c, init=init,
        cy=cy, cst=cst)
    def f(x, dt, a_log, b, c, init):
        return ssd_chunked(x, dt, a_log, b, c, chunk=chunk,
                           init_state=init if with_init else None)
    args = [jnp.asarray(v) for v in (x, dt, a_log, b, c, init)]
    (y, st), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(cy), jnp.asarray(cst)))
    put(f"ssd/{name}", y=y, state=st)
    for n, g in zip(("x", "dt", "a_log", "b", "c", "init"), grads):
        save[f"ssd/{name}/grad/{n}"] = np.asarray(g)

x1, b1, c1 = rnd(B, 1, H, P), rnd(B, 1, G, N), rnd(B, 1, G, N)
dt1 = np.log1p(np.exp(rnd(B, 1, H))).astype(np.float32)
a1 = np.log(rng.uniform(1.0, 4.0, H)).astype(np.float32)
st1 = rnd(B, H, P, N)
y1, new1 = ssd_decode_step(*(jnp.asarray(v) for v in (x1, dt1, a1, b1, c1,
                                                       st1)))
put("decode_step/in", x=x1, dt=dt1, a_log=a1, b=b1, c=c1, state=st1)
put("decode_step", y=y1, state=new1)

di = MH * MP
w = {"wx": rnd(D, di, scale=D ** -0.5), "wz": rnd(D, di, scale=D ** -0.5),
     "wB": rnd(D, MN, scale=D ** -0.5), "wC": rnd(D, MN, scale=D ** -0.5),
     "wdt": rnd(D, MH, scale=D ** -0.5), "dt_bias": rnd(MH, scale=0.1),
     "conv_w": rnd(K, di, scale=0.5),
     "a_log": np.log(rng.uniform(1.0, 16.0, MH)).astype(np.float32),
     "d_skip": rnd(MH), "out_proj": rnd(di, D, scale=di ** -0.5)}
put("mamba/w", **w)
for name, (s, chunk, decode, carried) in mamba_cases.items():
    x = rnd(B, s, D)
    conv0, ssm0 = rnd(B, K - 1, di), rnd(B, MH, MP, MN, scale=0.5)
    cy = rnd(B, s, D)
    cconv, cssm = rnd(B, K - 1, di), rnd(B, MH, MP, MN)
    put(f"mamba/{name}/in", x=x, conv=conv0, ssm=ssm0, cy=cy, cconv=cconv,
        cssm=cssm)
    def f(x, w, conv0, ssm0):
        st = SSMState(conv=conv0, ssm=ssm0) if carried else None
        return mamba2_forward(x, {**w, "d_state": MN, "n_groups": 1},
                              SINGLE, chunk=chunk, state=st, decode=decode)
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    (y, st), vjp = jax.vjp(f, jnp.asarray(x), wj, jnp.asarray(conv0),
                           jnp.asarray(ssm0))
    gx, gw, gconv, gssm = vjp((jnp.asarray(cy), SSMState(
        conv=jnp.asarray(cconv), ssm=jnp.asarray(cssm))))
    put(f"mamba/{name}", y=y, conv=st.conv, ssm=st.ssm, gx=gx, gconv=gconv,
        gssm=gssm)
    for n, g in gw.items():
        save[f"mamba/{name}/grad/{n}"] = np.asarray(g)
np.savez(out_path, **save)
print("child OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_ssm") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(out),
         *(str(v) for v in (B, H, P, N, G, D, K, M_H, M_P, M_N)),
         repr(SSD_CASES), repr(MAMBA_CASES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return dict(z)


def _t(ref, name, grad=False):
    return torch.from_numpy(ref[name]).requires_grad_(grad)


def _close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= REL_TOL * scale, (what, err, scale)


def test_segsum_matches_reference(ref):
    got = _segsum(_t(ref, "segsum/x"))
    want = ref["segsum/out"]
    assert torch.equal(torch.isinf(got), torch.from_numpy(np.isinf(want)))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], atol=1e-6)


@pytest.mark.parametrize("case", ["nostate", "state"])
def test_causal_conv_matches_reference(ref, case):
    state = None if case == "nostate" else _t(ref, "conv/in/state")
    y, new = _causal_conv(_t(ref, "conv/in/x"), _t(ref, "conv/in/w"), state)
    _close(y, ref[f"conv/{case}/y"], "y")
    np.testing.assert_array_equal(new.numpy(), ref[f"conv/{case}/state"])


def _ssd(ref, case):
    s, chunk, with_init = SSD_CASES[case]
    names = ("x", "dt", "a_log", "b", "c", "init")
    args = [_t(ref, f"ssd/{case}/in/{n}", grad=True) for n in names]
    y, st = ssd_chunked(*args[:5], chunk=chunk,
                        init_state=args[5] if with_init else None)
    grads = torch.autograd.grad(
        (y, st), args if with_init else args[:5],
        (_t(ref, f"ssd/{case}/in/cy"), _t(ref, f"ssd/{case}/in/cst")))
    return y, st, dict(zip(names, grads))


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_reference(ref, case):
    y, st, _ = _ssd(ref, case)
    assert tuple(y.shape) == ref[f"ssd/{case}/y"].shape
    _close(y, ref[f"ssd/{case}/y"], "y")
    _close(st, ref[f"ssd/{case}/state"], "state")


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_grads_match_reference(ref, case):
    _, _, grads = _ssd(ref, case)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        _close(g, ref[f"ssd/{case}/grad/{name}"], name)


def test_ssd_decode_step_matches_reference(ref):
    names = ("x", "dt", "a_log", "b", "c", "state")
    y, st = ssd_decode_step(*(_t(ref, f"decode_step/in/{n}")
                              for n in names))
    _close(y, ref["decode_step/y"], "y")
    _close(st, ref["decode_step/state"], "state")


def _mamba(ref, case):
    s, chunk, decode, carried = MAMBA_CASES[case]
    pre = f"mamba/{case}/in"
    w = {k[len("mamba/w/"):]: _t(ref, k, grad=True)
         for k in ref if k.startswith("mamba/w/")}
    x = _t(ref, f"{pre}/x", grad=True)
    conv0, ssm0 = _t(ref, f"{pre}/conv", True), _t(ref, f"{pre}/ssm", True)
    state = SSMState(conv=conv0, ssm=ssm0) if carried else None
    y, st = mamba2_forward(x, {**w, "d_state": M_N, "n_groups": 1},
                           chunk=chunk, state=state, decode=decode)
    inputs = [x, *w.values()] + ([conv0, ssm0] if carried else [])
    grads = torch.autograd.grad(
        (y, st.conv, st.ssm), inputs,
        (_t(ref, f"{pre}/cy"), _t(ref, f"{pre}/cconv"),
         _t(ref, f"{pre}/cssm")))
    named = dict(zip(["gx", *(f"grad/{k}" for k in w)]
                     + (["gconv", "gssm"] if carried else []), grads))
    return y, st, named


@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba2_forward_matches_reference(ref, case):
    y, st, _ = _mamba(ref, case)
    _close(y, ref[f"mamba/{case}/y"], "y")
    _close(st.conv, ref[f"mamba/{case}/conv"], "conv state")
    _close(st.ssm, ref[f"mamba/{case}/ssm"], "ssm state")


@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba2_forward_grads_match_reference(ref, case):
    _, _, grads = _mamba(ref, case)
    for name, g in grads.items():
        _close(g, ref[f"mamba/{case}/{name}"], name)


def _inputs(seed, b=2, s=32, h=4, p=8, n=16, g=1):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)
    x = rnd(b, s, h, p)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    a_log = torch.log(1.0 + 3.0 * torch.rand((h,), generator=gen))
    return x, dt, a_log, rnd(b, s, g, n) * 0.3, rnd(b, s, g, n) * 0.3


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_matches_sequential(chunk):
    x, dt, a_log, b, c = _inputs(0)
    y_chunk, final = ssd_chunked(x, dt, a_log, b, c, chunk=chunk)
    state = torch.zeros((2, 4, 8, 16))
    ys = []
    for t in range(32):
        y, state = ssd_decode_step(x[:, t:t + 1], dt[:, t:t + 1], a_log,
                                   b[:, t:t + 1], c[:, t:t + 1], state)
        ys.append(y)
    torch.testing.assert_close(y_chunk, torch.cat(ys, 1), atol=1e-4, rtol=0)
    torch.testing.assert_close(final, state, atol=1e-4, rtol=0)


def test_state_carry_split_runs():
    x, dt, a_log, b, c = _inputs(1)
    y_full, _ = ssd_chunked(x, dt, a_log, b, c, chunk=8)
    y1, st = ssd_chunked(x[:, :16], dt[:, :16], a_log, b[:, :16], c[:, :16],
                         chunk=8)
    y2, _ = ssd_chunked(x[:, 16:], dt[:, 16:], a_log, b[:, 16:], c[:, 16:],
                        chunk=8, init_state=st)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-5,
                               rtol=0)


def test_decay_stability_and_finite_grads():
    """Large dt*A gives no NaN or inf, forward or backward (the segment
    sums are masked to -inf before the exp)."""
    x, dt, a_log, b, c = _inputs(2)
    dt = (dt * 100).requires_grad_(True)
    y, final = ssd_chunked(x, dt, a_log, b, c, chunk=8)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    (g,) = torch.autograd.grad(y.sum() + final.sum(), [dt])
    assert torch.isfinite(g).all()



def test_fp64_inputs_scan_in_fp64():
    """fp64 inputs run the scan (and the RMSNorm) in fp64, not in fp32: the
    chunked and the sequential forms then agree to fp64 rounding (1e-12),
    which an fp32 scan cannot (7e-7 here), and the state stays fp64.
    fp32 and bf16 inputs still scan in fp32."""
    from repro_torch.models.layers import rms_norm

    x, dt, a_log, b, c = (t.double() for t in _inputs(3))
    y_chunk, final = ssd_chunked(x, dt, a_log, b, c, chunk=8)
    state = torch.zeros((2, 4, 8, 16), dtype=torch.float64)
    ys = []
    for t in range(32):
        y, state = ssd_decode_step(x[:, t:t + 1], dt[:, t:t + 1], a_log,
                                   b[:, t:t + 1], c[:, t:t + 1], state)
        ys.append(y)
    assert final.dtype == state.dtype == torch.float64
    torch.testing.assert_close(y_chunk, torch.cat(ys, 1), atol=1e-12, rtol=0)
    torch.testing.assert_close(final, state, atol=1e-12, rtol=0)
    assert ssd_chunked(x.bfloat16(), dt, a_log, b, c,
                       chunk=8)[1].dtype == torch.float32
    v = x.reshape(2, 32, 32) * 1e3
    want = v / torch.sqrt((v * v).mean(-1, keepdim=True) + 1e-5)
    torch.testing.assert_close(rms_norm(v, torch.ones(32, dtype=v.dtype)),
                               want, atol=1e-12, rtol=0)
