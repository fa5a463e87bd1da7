"""The port's host wire datapath (``repro_torch/net``: ``HostPeer``,
``HostRing`` and the ``WireTransport`` bridge) on the CPU.

Parity, the subsystem's load-bearing result: with the inproc backend
scripted to drop exactly the packets the engine's ``Lossy`` masks name
(``mask_scripted_drops``), ``HostRing.allreduce`` — every byte really
crossing the backend, each peer's stage functions on one-row stacks — is
**bitwise** the port's ``sync_packed`` on the same draws, for
``optireduce``, ``optireduce_q``, ``tar_rounds_q`` and ``optireduce`` with
``recovery="stale"``; and ``sync_packed`` through ``WireTransport`` is
bitwise the same after one priming call (the bridge is one exchange
behind, and these masks do not depend on the exchange).

Against the reference: the JAX package's ``HostRing.allreduce`` runs
in-process on the same buckets, masks and draws (its key's sign, noises
and masks, served to the port by ``RefDraws``). Tolerance 1e-5 absolute on
values of order 1: the port rotates with the butterfly, the reference's
jnp path with Kronecker matmuls (as ``tests/test_torch_rounds_sync.py``);
a quantized code on a floor boundary could differ by one, which these
inputs do not hit (measured: 2.5e-7 for ``optireduce``, 8.1e-6 for the
quantized two, all codes equal). The telemetry — loss fraction, per-peer
stage times, round times — is equal exactly (virtual time, the same
headers).

The rest are counterparts of the reference's ``tests/test_net_transport.py``
cases: late packets masked and never blocked, the adaptive deadline and the
early timeout, telemetry into the straggler detector, the dead-link relay,
weighted shards bitwise the uniform ones, the refusals, and a 2-peer UDP
allreduce where the environment lets a process bind a socket; and the bridge's
call order held with the interpreter switching threads every microsecond.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import net as ref_net  # noqa: E402
from repro.core import drops as jdrops  # noqa: E402
from repro.core.hadamard import rademacher_sign as jsign  # noqa: E402
from repro.core.pipeline import OptiReduceConfig as RefConfig  # noqa: E402
from repro_torch.core import collectives, tar  # noqa: E402
from repro_torch.core.allreduce import sync_packed  # noqa: E402
from repro_torch.core.keys import key as tkey  # noqa: E402
from repro_torch.core.pipeline import (ThreefryDraws,  # noqa: E402
                                       OptiReduceConfig, SyncContext,
                                       WireTransport, resolve_spec)
from repro_torch.core.ubt import AdaptiveTimeout  # noqa: E402
from repro_torch.launch import multiproc  # noqa: E402
from repro_torch.net import (HostPeer, HostRing,  # noqa: E402
                             InprocBackend, bernoulli_drops, mask_scripted_drops,
                             peer_factor_delays, udp_available, wire_spec)
from repro_torch.net.wire import (KIND_DATA1, KIND_DATA2,  # noqa: E402
                                  n_packets)
from repro_torch.runtime import ControlPlane  # noqa: E402

N = 4
L = 1000                  # not block-aligned: the pad and tail-packet paths
KEY = tkey(5)
REF_TOL = 1e-5
CPU = torch.device("cpu")
# (strategy, drop rate, recovery): the reference's parity set, and the
# stale-fill codec over the wire
PARITY = {"optireduce": ("optireduce", 0.1, "none"),
          "optireduce_q": ("optireduce_q", 0.05, "none"),
          "tar_rounds_q": ("tar_rounds_q", 0.05, "none"),
          "optireduce_stale": ("optireduce", 0.1, "stale")}


def _cfg(**kw):
    base = dict(strategy="optireduce", drop_rate=0.0, hadamard_block=256,
                packet_elems=64, incast=2)
    base.update(kw)
    return OptiReduceConfig(**base)


def _buckets(elems=L, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (N, elems)).astype(np.float32))


def _ring(cfg, **kw):
    return HostRing(N, cfg, device="cpu", **kw)


def _shard(cfg, length=L):
    padded, _ = tar.pad_for_tar(torch.zeros(length), N,
                                resolve_spec(cfg).codec.block(cfg))
    return padded.shape[0] // N


def _scripted(draws, cfg, s):
    """Each receiver's Lossy mask of bucket 0, and the drop script that
    loses exactly those packets."""
    masks = {r: draws.mask(0, r, N, s).numpy() for r in range(N)}
    return masks, mask_scripted_drops(masks, cfg.packet_elems)


def _sync(x, cfg, draws, spec=None, stale=None):
    ctx = SyncContext(cfg=cfg, draws=draws)
    out = sync_packed(x[:, None], ctx, mode="pipelined", spec=spec,
                      stale=None if stale is None else stale[None])
    return out[:, 0], float(ctx.loss_fraction())


@pytest.mark.parametrize("case", list(PARITY))
def test_ring_and_bridge_are_sync_packed_bitwise(case):
    strategy, rate, recovery = PARITY[case]
    cfg = _cfg(strategy=strategy, drop_rate=rate, recovery=recovery)
    draws = ThreefryDraws(KEY, cfg, CPU)
    x = _buckets()
    stale = (torch.from_numpy(np.random.default_rng(9).standard_normal(L)
                              .astype(np.float32))
             if recovery != "none" else None)
    ref, ref_frac = _sync(x, cfg, draws, stale=stale)
    masks, drop_fn = _scripted(draws, cfg, _shard(cfg))

    ring = _ring(cfg, backend=InprocBackend(N, drop_fn=drop_fn))
    out, tel = ring.allreduce(x, draws, stale=stale)
    assert torch.equal(out, ref)
    assert tel.loss_frac == pytest.approx(ref_frac, abs=1e-7)
    assert len(tel.peer_stage_times) == N
    ring.close()

    # the bridge: the engine's own datapath under wire-observed masks
    cfg_w = dataclasses.replace(cfg, drop_rate=0.0)
    bridge = _ring(cfg_w, backend=InprocBackend(N, drop_fn=drop_fn))
    spec = wire_spec(cfg_w, bridge)
    assert isinstance(spec.transport, WireTransport)
    _, prime_frac = _sync(x, cfg_w, ThreefryDraws(KEY, cfg_w, CPU), spec,
                          stale)
    assert prime_frac == 0.0                    # the priming call: all-ones
    assert bridge.flush()
    got, frac = _sync(x, cfg_w, ThreefryDraws(KEY, cfg_w, CPU), spec, stale)
    assert torch.equal(got, ref)
    assert frac == pytest.approx(ref_frac, abs=1e-7)
    assert bridge.bridge_misses == 0 and bridge.bridge_error is None
    assert bridge.flush()
    wt = bridge.drain_telemetry()
    assert wt is not None and len(wt.peer_stage_times) == N
    # both exchanges' observed masks: each receiver's Lossy mask, twice
    want = 1.0 - np.mean([masks[r] for r in range(N)])
    assert wt.loss_frac == pytest.approx(want, abs=1e-7)
    bridge.close()


class RefDraws:
    """The reference ring's draws for its key, whatever the site: the sign
    ``rademacher_sign(key)``, noise ``uniform(fold_in(key, salt))`` and
    receiver r's mask from ``fold_in(key, r)``, its own row forced."""

    def __init__(self, key, cfg):
        self.key, self.cfg = key, cfg

    def sign(self, bucket, block):
        return torch.from_numpy(np.array(jsign(self.key, block)))

    def noise(self, bucket, salt, shape):
        k = jax.random.fold_in(self.key, salt)
        return torch.from_numpy(np.array(jax.random.uniform(k, shape)))

    def mask(self, bucket, receiver, n, s, self_index=None):
        si = receiver if self_index is None else self_index
        return torch.from_numpy(np.array(jdrops.make_mask(
            self.cfg.drop_pattern, jax.random.fold_in(self.key, receiver), n,
            s, rate=self.cfg.drop_rate, packet_elems=self.cfg.packet_elems,
            self_index=jnp.int32(si))))


@pytest.mark.parametrize("case", ["optireduce", "optireduce_q",
                                  "tar_rounds_q"])
def test_ring_matches_the_reference_ring(case):
    strategy, rate, _ = PARITY[case]
    kw = dict(strategy=strategy, drop_rate=rate, hadamard_block=256,
              packet_elems=64, incast=2)
    cfg = OptiReduceConfig(**kw)
    key = jax.random.PRNGKey(5)
    draws = RefDraws(key, cfg)
    x = _buckets()
    masks, _ = _scripted(draws, cfg, _shard(cfg))
    want, want_tel = ref_net.HostRing(N, RefConfig(**kw), backend=ref_net.
                                      InprocBackend(N, drop_fn=ref_net.
                                                    mask_scripted_drops(
                                                        masks, 64))
                                      ).allreduce(x.numpy(), key)
    got, tel = _ring(cfg, drop_fn=mask_scripted_drops(masks, 64)).allreduce(
        x, draws)
    np.testing.assert_allclose(got.numpy(), want, atol=REF_TOL, rtol=0)
    assert tel.loss_frac == want_tel.loss_frac > 0
    assert tel.peer_stage_times == want_tel.peer_stage_times
    assert tel.round_times == want_tel.round_times
    assert tel.round_frac_received == want_tel.round_frac_received


def test_no_drop_allreduce_is_the_mean_and_deterministic():
    x = _buckets()
    out1, tel1 = _ring(_cfg()).allreduce(x, KEY)
    out2, _ = _ring(_cfg()).allreduce(x, KEY)
    assert torch.equal(out1, out2)
    assert tel1.loss_frac == 0.0 and not tel1.timed_out
    for p in range(N):
        torch.testing.assert_close(out1[p], x.mean(0), atol=1e-5, rtol=0)
        assert torch.equal(out1[0], out1[p])
    assert len(tel1.round_times) == 2 * (N - 1)
    assert tel1.round_frac_received == (1.0,) * (2 * (N - 1))


def test_late_packets_are_masked_never_blocked():
    """A peer slower than the deadline is loss: its stage-1 entries are
    masked at every receiver (the compensated mean over the 3 on-time
    peers), its own stage-2 shard is a zero-filled hole, and it is charged
    the deadline."""
    slow = 2
    factors = tuple(50.0 if p == slow else 1.0 for p in range(N))
    ring = _ring(_cfg(), backend=InprocBackend(
        N, delay_fn=peer_factor_delays(1e-4, factors)),
        default_deadline=1e-3)
    x = _buckets()
    out, tel = ring.allreduce(x, KEY)
    assert tel.timed_out and tel.loss_frac > 0.0
    assert tel.peer_stage_times[slow] == pytest.approx(1e-3)
    assert max(tel.peer_stage_times[p] for p in range(N) if p != slow) < 1e-3
    s = 256
    mean3 = x[[p for p in range(N) if p != slow]].mean(0)
    torch.testing.assert_close(out[0][:slow * s], mean3[:slow * s],
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(out[0][(slow + 1) * s:],
                               mean3[(slow + 1) * s:], atol=1e-5, rtol=0)
    assert not out[0][slow * s:(slow + 1) * s].any()


def test_adaptive_timeout_drives_the_deadline():
    at = AdaptiveTimeout(warmup_iters=3)
    ring = _ring(_cfg(), timeout=at, default_deadline=7.0)
    assert ring.peers[0].round_deadline() == 7.0
    for t in (0.1, 0.2, 0.3):
        at.observe_warmup(t)
    assert at.ready
    assert ring.peers[0].round_deadline() == at.round_deadline(False) < 7.0


def test_early_timeout_shaves_the_straggling_tail():
    """§3.2.1 on the wire: once 99% of a stream is in, the receiver waits
    x% of t_C more, so one stalled packet is masked early."""
    elems, pe = 4096, 64
    n_pkts = n_packets(elems // N, pe)

    def delay(src, dst, hdr):
        return 0.5 if hdr.kind == KIND_DATA1 and hdr.seq == n_pkts - 1 \
            else 1e-4

    at = AdaptiveTimeout()
    at.t_b, at.t_c, at.x = 1.0, 1e-3, 0.1
    ring = _ring(_cfg(), backend=InprocBackend(N, delay_fn=delay),
                 timeout=at)
    _, tel = ring.allreduce(_buckets(elems), KEY)
    assert all(t < 5e-4 for t in tel.round_times[:N - 1])
    assert tel.timed_out
    want = (1.0 - (n_pkts - 1) / n_pkts) * (N - 1) / N
    assert tel.loss_frac == pytest.approx(want, abs=1e-6)


def test_wire_telemetry_feeds_straggler_detection():
    slow = 1
    factors = tuple(6.0 if p == slow else 1.0 for p in range(N))
    ring = _ring(_cfg(), backend=InprocBackend(
        N, delay_fn=peer_factor_delays(1e-4, factors)))
    control = ControlPlane.create(n_nodes=N)
    x = _buckets(512)
    for step in range(12):
        _, tel = ring.allreduce(x, KEY, step=step)
        assert len(tel.peer_stage_times) == N
        control.observe(tel)
    assert control.detector.ejected_peers() == (slow,)
    assert slow not in control.policy().active_peers


def test_bernoulli_wire_loss_tracks_the_rate():
    ring = _ring(_cfg(), drop_fn=bernoulli_drops(0.05, seed=3))
    dropped = total = 0.0
    for step in range(4):
        _, tel = ring.allreduce(_buckets(4096), KEY, step=step)
        dropped, total = dropped + tel.dropped, total + tel.total
    assert 0.01 < dropped / total < 0.12


def _kill(src, dst):
    def drop(s, d, hdr):
        return s == src and d == dst and hdr.kind in (KIND_DATA1, KIND_DATA2)
    return drop


def test_dead_link_relay_completes_bitwise_without_ejection():
    x = _buckets(2048)
    base, _ = _ring(_cfg()).allreduce(x, KEY)
    ring = _ring(_cfg(), drop_fn=_kill(2, 0), dead_links=((2, 0),))
    out, tel = ring.allreduce(x, KEY)
    assert torch.equal(out, base)
    assert tel.loss_frac == 0.0 and tel.dead_link_events == ()
    # untold, the same fault is reported as a link suspect
    _, tel = _ring(_cfg(), drop_fn=_kill(2, 0)).allreduce(x, KEY)
    assert (2, 0) in tel.dead_link_events and tel.loss_frac > 0


def test_weighted_shards_are_bitwise_the_uniform_ones():
    x = _buckets(2048)
    base, _ = _ring(_cfg()).allreduce(x, KEY)
    out, tel = _ring(_cfg(), shard_weights=(2, 2, 1, 2)).allreduce(x, KEY)
    assert torch.equal(out, base) and tel.loss_frac == 0.0
    out, _ = _ring(_cfg(), drop_fn=_kill(1, 3), shard_weights=(2, 1, 2, 2),
                   dead_links=((1, 3),)).allreduce(x, KEY)
    assert torch.equal(out, base)
    uniform = _ring(_cfg(), shard_weights=(3, 3, 3, 3))
    assert all(p.shard_weights is None for p in uniform.peers)
    with pytest.raises(ValueError, match="linear"):
        _ring(_cfg(strategy="optireduce_q"), shard_weights=(2, 2, 1, 2))


def test_refusals():
    """Non-TAR strategies, and what the bridge cannot model: a degraded
    round schedule's virtual ring, a grid of pods, a miss on a changed
    geometry (all-ones, counted)."""
    with pytest.raises(ValueError, match="TAR"):
        _ring(_cfg(strategy="gloo_ring"))
    ring = _ring(_cfg())
    spec = wire_spec(_cfg(), ring)
    x = _buckets()
    degraded = _cfg(strategy="optireduce_rounds", active_peers=(0, 1, 3))
    with pytest.raises(NotImplementedError, match="payload"):
        sync_packed(x[:, None], SyncContext(
            cfg=degraded, draws=ThreefryDraws(KEY, degraded, CPU)),
            spec=dataclasses.replace(resolve_spec(degraded),
                                     transport=spec.transport))
    pods = _cfg(pod_axis="pod")
    with pytest.raises(NotImplementedError, match="one data axis"):
        sync_packed(torch.cat([x, x])[:, None], SyncContext(
            cfg=pods, draws=ThreefryDraws(KEY, pods, CPU),
            grid=collectives.Grid(pods=2)), spec=spec)
    ring.bridge_exchange(torch.zeros((N, N, 8)))
    assert ring.flush()
    mask = ring.bridge_exchange(torch.zeros((N, N, 16)))
    assert ring.bridge_misses == 1 and bool((mask == 1).all())
    ring.close()


@pytest.mark.parametrize("entry", ["HostPeer", "HostRing", "multiproc"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Built without a device, a peer or a ring runs its stage functions on
    the card, and raises where there is none instead of falling back to
    the CPU's plain versions; so does the multi-process launcher without
    ``--device``, before it starts a worker."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "HostPeer":
            HostPeer(0, InprocBackend(N), _cfg())
        elif entry == "HostRing":
            HostRing(N, _cfg())
        else:
            multiproc.main(["--backend", "inproc", "--steps", "1",
                            "--elems", "256"])
    peer = HostPeer(0, InprocBackend(N), _cfg(), device="cpu")
    assert peer.device == CPU


def test_udp_two_peer_allreduce():
    if not udp_available():
        pytest.skip("this environment forbids binding a localhost UDP "
                    "socket")
    ring = HostRing(2, _cfg(), backend="udp", default_deadline=2.0,
                    device="cpu")
    try:
        x = _buckets()[:2, :600]
        out, tel = ring.allreduce(x, KEY)
        torch.testing.assert_close(out[0], x.mean(0), atol=1e-5, rtol=0)
        assert torch.equal(out[0], out[1])
        assert len(tel.peer_stage_times) == 2
    finally:
        ring.close()


def test_bridge_keeps_order_under_thread_switching():
    """The bridge's worker and the calling thread share its queue and
    results: with the interpreter switching threads every microsecond,
    each of 40 calls still returns exactly the previous exchange's mask
    (the scripted drops depend on the receiver only, so every mask after
    the priming call is the same), with no miss, and every exchange's
    telemetry is drained once."""
    import sys
    cfg = _cfg(drop_rate=0.1)
    draws = ThreefryDraws(KEY, cfg, CPU)
    s = 64 * 4
    masks, drop_fn = _scripted(draws, cfg, s)
    want = torch.from_numpy(np.stack([masks[r] for r in range(N)]))
    ring = _ring(cfg, drop_fn=drop_fn)
    shards = torch.zeros((N, N, s))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [ring.bridge_exchange(shards) for _ in range(40)]
        assert ring.flush(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
        ring.close()
    assert bool((got[0] == 1).all())
    assert all(torch.equal(m, want) for m in got[1:])
    assert ring.bridge_misses == 0 and ring.bridge_error is None
    tel = ring.drain_telemetry()
    assert len(tel.round_times) == 40 * (N - 1)
    assert ring.drain_telemetry() is None
