"""Mamba-2 (SSD, state-space duality) layer: the chunked training form and
the O(1) recurrent decode form.

Counterpart of ``src/repro/models/ssm.py``. Under tensor parallelism the
reference shards the SSM heads (and the d_inner channels they own) over
the tp ranks, replicates the one B/C group onto each rank's heads and
psums ``out_proj``'s row-parallel partials; the port runs the tp group's
heads in one pass over the global weights (every product but ``out_proj``
is per channel or per head, so the concatenation of the ranks' values is
the global value) and reduces ``out_proj``'s T partial products as the
reference's ranks do.

Over ranks (``pctx.over_ranks()``: one tp rank a process) a rank holds
and runs only its own ``H / T`` heads: ``wx`` and ``wz`` ``(D, d_inner /
T)``, ``wdt`` ``(D, H / T)``, ``conv_w`` ``(K, d_inner / T)``, ``a_log``,
``dt_bias`` and ``d_skip`` ``(H / T,)`` and ``out_proj`` ``(d_inner / T,
D)``, its one partial product summed over the tp group; ``wB`` and ``wC``
arrive whole. The block's input goes through ``pctx.copy_tp`` (Megatron's
"f"), and so do ``wB`` and ``wC``: the one B/C group feeds every head, but
a rank's B and C feed only its own heads, so each rank's gradient of them
(and of the input) is its heads' share, and "f" sums the shares over the
tp group; every tp rank then holds the whole ``wB`` / ``wC`` gradient
before the trainer takes tp rank 0's copy of a leaf replicated over tp.

It follows the minimal SSD listing of Dao & Gu (arXiv:2405.21060): an
intra-chunk quadratic term plus an inter-chunk state scan, here a loop
over the chunks. The reference's three-operand einsums run as two-operand
ones with the third factor multiplied in first (the same sums in another
order, fp32 throughout), so no contraction materialises a (..., C, C, P)
intermediate. ``_segsum`` masks to -inf before the ``exp``, so the masked
entries' gradient is 0, not ``inf * 0``.
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``. Decode carries
``(conv_state, ssm_state)`` per layer, constant in the sequence length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import row_parallel
from .parallel import SINGLE, ParallelCtx


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
    in fp32 (fp64 for fp64 x: the scan runs in the wider of x's dtype and
    fp32).
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
    acc = torch.promote_types(x.dtype, torch.float32)

    a = -torch.exp(a_log.to(acc))                                 # (H,)
    dtac = (dt.to(acc) * a).reshape(bs, nc, chunk, h)
    xc = x.reshape(bs, nc, chunk, h, p).to(acc)
    dtc = dt.reshape(bs, nc, chunk, h).to(acc)
    bc = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(acc)
    cc = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3).to(acc)

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
    st = (torch.zeros((bs, h, p, n), dtype=acc, device=x.device)
          if init_state is None else init_state.to(acc))
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
    b, c: (B, 1, G, N); state: (B, H, P, N) fp32 (fp64 for fp64 x).
    Returns (y, new_state)."""
    h = x.shape[2]
    rep = h // b.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    a = -torch.exp(a_log.to(acc))
    dta = torch.exp(dt[:, 0].to(acc) * a[None, :])                # (B, H)
    bh = b[:, 0].repeat_interleave(rep, dim=1).to(acc)            # (B, H, N)
    ch = c[:, 0].repeat_interleave(rep, dim=1).to(acc)
    xf = x[:, 0].to(acc)                                          # (B, H, P)
    dtf = dt[:, 0].to(acc)
    new_state = state * dta[:, :, None, None] + \
        (xf * dtf[..., None])[..., None] * bh[:, :, None, :]
    y = torch.einsum("zhn,zhpn->zhp", ch, new_state)
    return y[:, None].to(x.dtype), new_state


def mamba2_forward(x: torch.Tensor, w: dict, *,
                   pctx: ParallelCtx | None = None, chunk: int = 256,
                   state: SSMState | None = None, decode: bool = False):
    """Mamba-2 block. x: (B, S, D), the one activation of the tp group.

    w: wx/wz (D, d_inner), wB/wC (D, G*N), wdt (D, H), conv_w (K, d_inner),
    a_log (H,), d_skip (H,), dt_bias (H,), out_proj (d_inner, D), and the
    ints d_state (N) and n_groups (G); H is the padded head count of the
    tree, each head ``d_inner / H`` channels wide (the reference's ``p``).
    Under tensor parallelism ``out_proj`` is row-parallel (its T partial
    products reduced by ``pctx.reduce_output``); every other product is
    per channel or per head, so it runs over the global weights. Returns
    (y, new_state); the state at the global head count. Over ranks every
    weight but ``wB`` / ``wC`` is the rank's chunk (see the module's
    docstring).
    """
    pctx = pctx or SINGLE
    bsz, s, _ = x.shape
    n, g = w["d_state"], w["n_groups"]
    wb, wc = w["wB"], w["wC"]
    if pctx.over_ranks():
        # a rank's B / C feed only its own heads: "f" sums their gradient
        x, wb, wc = pctx.copy_tp(x), pctx.copy_tp(wb), pctx.copy_tp(wc)
    xz = x @ w["wx"].to(x.dtype)
    z = x @ w["wz"].to(x.dtype)
    bproj = x @ wb.to(x.dtype)
    cproj = x @ wc.to(x.dtype)
    dt = x @ w["wdt"].to(x.dtype)
    acc = torch.promote_types(x.dtype, torch.float32)
    dt = dt.to(acc) + w["dt_bias"].to(acc)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))         # softplus

    conv_state = state.conv if state is not None else None
    xz, new_conv = _causal_conv(F.silu(xz), w["conv_w"].to(x.dtype),
                                conv_state)

    h = w["a_log"].shape[0]
    p = xz.shape[-1] // h
    if state is not None and state.ssm.shape[-2] != p:
        raise ValueError(
            f"the SSM state's head dim {state.ssm.shape[-2]} is not the "
            f"block's {p} (d_inner {xz.shape[-1]} over {h} padded heads): "
            "padding the SSM heads for tp changes the head dim (ROADMAP C)")
    xh = xz.reshape(bsz, s, h, p)
    bmat = bproj.reshape(bsz, s, g, n)
    cmat = cproj.reshape(bsz, s, g, n)
    if decode:
        ssm_in = state.ssm if state is not None else torch.zeros(
            (bsz, h, p, n), dtype=acc, device=x.device)
        y, new_ssm = ssd_decode_step(xh, dt, w["a_log"], bmat, cmat, ssm_in)
    else:
        ssm_in = state.ssm if state is not None else None
        y, new_ssm = ssd_chunked(xh, dt, w["a_log"], bmat, cmat, chunk=chunk,
                                 init_state=ssm_in)
    y = y + xh * w["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * p) * F.silu(z)        # gated output
    if pctx.tp_size() > 1:
        out = row_parallel(y, w["out_proj"], pctx)
    else:
        out = y @ w["out_proj"].to(x.dtype)
    return out, SSMState(conv=new_conv, ssm=new_ssm)
