"""Mamba-2 (SSD, state-space duality) layer: the chunked training form and
the O(1) recurrent decode form.

Counterpart of ``src/repro/models/ssm.py`` at one tensor-parallel rank (SSM
heads over tp are ROADMAP A21c; ``param_table`` refuses them), so no
``pctx`` is taken. It follows the minimal SSD listing of Dao & Gu
(arXiv:2405.21060): an intra-chunk quadratic term plus an inter-chunk
state scan, here a loop over the chunks. The reference's three-operand
einsums run as two-operand ones with the third factor multiplied in first
(the same sums in another order, fp32 throughout), so no contraction
materialises a (..., C, C, P) intermediate. ``_segsum`` masks to -inf
before the ``exp``, so the masked entries' gradient is 0, not ``inf * 0``.
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``. Decode carries
``(conv_state, ssm_state)`` per layer, constant in the sequence length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F



class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_inner)
    ssm: torch.Tensor    # (B, H, P, N) fp32


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i>=j),
    -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, torch.full_like(out, -torch.inf))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C). Returns (y, new_state)
    where state holds the trailing K-1 inputs for decode continuation."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return y, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
                init_state: torch.Tensor | None = None):
    """SSD forward. x: (B, S, H, P); dt: (B, S, H) (post-softplus);
    a_log: (H,); b, c: (B, S, G, N) with H % G == 0.
    Returns y: (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    in fp32.
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    s_out = s
    pad = (-s) % chunk
    if pad:
        # zero-pad the tail: dt=0 makes padded steps identity transitions
        # (decay exp(0)=1, zero state contribution), so the final state and
        # the first s outputs are exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g
    f32 = torch.float32

    a = -torch.exp(a_log.to(f32))                                 # (H,)
    dtac = (dt.to(f32) * a).reshape(bs, nc, chunk, h)
    xc = x.reshape(bs, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bs, nc, chunk, h).to(f32)
    bc = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(f32)
    cc = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(f32)

    # intra-chunk (quadratic) term
    decay = torch.exp(_segsum(dtac.transpose(2, 3)))          # (B,NC,H,C,C)
    scores = torch.einsum("zcihn,zcjhn->zchij", cc, bc) * decay
    y_intra = torch.einsum("zchij,zcjhp->zcihp", scores,
                           xc * dtc[..., None])

    # chunk states: contribution of each chunk to the running state
    cum = torch.cumsum(dtac, dim=2)                               # (B,NC,C,H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("zcjhn,zcjhp->zchpn",
                          bc * (decay_to_end * dtc)[..., None], xc)

    # inter-chunk scan: carry the state with each chunk's total decay
    chunk_decay = torch.exp(dtac.sum(dim=2))                      # (B,NC,H)
    st = (torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
          if init_state is None else init_state.to(f32))
    states_in = []
    for i in range(nc):
        states_in.append(st)
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    states_in = torch.stack(states_in, dim=1)                 # (B,NC,H,P,N)

    # inter-chunk output: y_inter[t] = C_t . (decay into t) state_in
    decay_from_start = torch.exp(cum)
    y_inter = torch.einsum("zcihn,zchpn->zcihp",
                           cc * decay_from_start[..., None], states_in)

    y = (y_intra + y_inter).reshape(bs, s, h, p)[:, :s_out]
    return y.to(x.dtype), st


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, state: torch.Tensor):
    """One-token recurrence. x: (B, 1, H, P); dt: (B, 1, H);
    b, c: (B, 1, G, N); state: (B, H, P, N) fp32. Returns (y, new_state)."""
    h = x.shape[2]
    rep = h // b.shape[2]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    dta = torch.exp(dt[:, 0].to(f32) * a[None, :])                # (B, H)
    bh = b[:, 0].repeat_interleave(rep, dim=1).to(f32)            # (B, H, N)
    ch = c[:, 0].repeat_interleave(rep, dim=1).to(f32)
    xf = x[:, 0].to(f32)                                          # (B, H, P)
    dtf = dt[:, 0].to(f32)
    new_state = state * dta[:, :, None, None] + \
        (xf * dtf[..., None])[..., None] * bh[:, :, None, :]
    y = torch.einsum("zhn,zhpn->zhp", ch, new_state)
    return y[:, None].to(x.dtype), new_state


def mamba2_forward(x: torch.Tensor, w: dict, *, chunk: int = 256,
                   state: SSMState | None = None, decode: bool = False):
    """Mamba-2 block. x: (B, S, D).

    w: wx/wz (D, d_inner), wB/wC (D, G*N), wdt (D, H), conv_w (K, d_inner),
    a_log (H,), d_skip (H,), dt_bias (H,), out_proj (d_inner, D), and the
    ints d_state (N) and n_groups (G). Returns (y, new_state).
    """
    bsz, s, _ = x.shape
    n, g = w["d_state"], w["n_groups"]
    xz = x @ w["wx"].to(x.dtype)
    z = x @ w["wz"].to(x.dtype)
    bproj = x @ w["wB"].to(x.dtype)
    cproj = x @ w["wC"].to(x.dtype)
    dt = x @ w["wdt"].to(x.dtype)
    dt = dt.to(torch.float32) + w["dt_bias"].to(torch.float32)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))         # softplus

    conv_state = state.conv if state is not None else None
    xz, new_conv = _causal_conv(F.silu(xz), w["conv_w"].to(x.dtype),
                                conv_state)

    h = w["a_log"].shape[0]
    p = xz.shape[-1] // h
    xh = xz.reshape(bsz, s, h, p)
    bmat = bproj.reshape(bsz, s, g, n)
    cmat = cproj.reshape(bsz, s, g, n)
    if decode:
        ssm_in = state.ssm if state is not None else torch.zeros(
            (bsz, h, p, n), dtype=torch.float32, device=x.device)
        y, new_ssm = ssd_decode_step(xh, dt, w["a_log"], bmat, cmat, ssm_in)
    else:
        ssm_in = state.ssm if state is not None else None
        y, new_ssm = ssd_chunked(xh, dt, w["a_log"], bmat, cmat, chunk=chunk,
                                 init_state=ssm_in)
    y = y + xh * w["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * p) * F.silu(z)        # gated output
    out = y @ w["out_proj"].to(x.dtype)
    return out, SSMState(conv=new_conv, ssm=new_ssm)
