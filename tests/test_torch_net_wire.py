"""The port's wire codec, drop scripts and rendezvous (``repro_torch/net``)
against the JAX package's ``repro/net``, in-process (the compared modules
are host Python and numpy; importing the reference's package needs the
``TPUCompilerParams`` alias).

Everything here is exact: the datagrams ``packetize`` and ``wrap_relay``
emit are the reference's bytes; ``bernoulli_drops``, ``burst_drops``,
``mask_scripted_drops`` and ``peer_factor_delays`` give every header the
reference's verdict and delay; reassembly is order-free and its mask is
the port's ``core/drops.py`` expansion of the packet mask; the rendezvous
messages encode to the reference's bytes and its state machine takes the
same decisions.
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import net as ref_net  # noqa: E402
from repro_torch import net  # noqa: E402
from repro_torch.core import drops as drops_lib  # noqa: E402
from repro_torch.net import wire  # noqa: E402


def _payload(n_elems, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(n_elems)
    if dtype == np.uint8:
        return (np.abs(x) * 50).astype(np.uint8)
    return x.astype(dtype)


@pytest.mark.parametrize("n_elems,packet_elems,dtype", [
    (1000, 64, np.float32), (1003, 256, np.uint8), (7, 3, np.float32),
    (256, 256, np.float32), (1, 1, np.uint8)])
def test_packetize_emits_the_reference_bytes(n_elems, packet_elems, dtype):
    payload = _payload(n_elems, dtype, n_elems)
    kw = dict(kind=wire.KIND_DATA1, sender=3, step=70_000, bucket=2,
              round=1, packet_elems=packet_elems)
    got = net.packetize(payload, **kw)
    want = ref_net.packetize(payload, **kw)
    assert got == want
    assert len(got) == net.n_packets(n_elems, packet_elems)
    hdr, frag = net.PacketHeader.decode(got[-1])
    assert (hdr.seq, hdr.n_seq) == (len(got) - 1, len(got))
    assert hdr == net.PacketHeader(**vars(ref_net.PacketHeader.decode(
        want[-1])[0]))
    assert len(got[0]) == net.HEADER_BYTES + \
        min(n_elems, packet_elems) * payload.itemsize
    # the dead-link reroute wraps a whole datagram the same way
    assert wire.wrap_relay(1, 3, 9, got[0]) == \
        ref_net.wire.wrap_relay(1, 3, 9, got[0])
    assert wire.unwrap_relay(wire.wrap_relay(1, 3, 9, got[0])) == (3, got[0])


def test_header_rejects_garbage():
    with pytest.raises(net.WireError):
        net.PacketHeader.decode(b"short")
    hdr = net.PacketHeader(kind=net.KIND_DATA1, sender=0, step=0, bucket=0,
                           round=1, seq=0, n_seq=1)
    with pytest.raises(net.WireError):
        net.PacketHeader.decode(bytes([99]) + hdr.encode()[1:])
    with pytest.raises(net.WireError):
        net.PacketHeader.decode(hdr.encode()[:1] + bytes([77])
                                + hdr.encode()[2:])
    assert net.HEADER_BYTES == ref_net.HEADER_BYTES == 16


def _headers(kinds=(wire.KIND_DATA1, wire.KIND_DATA2, wire.KIND_CTRL)):
    for kind in kinds:
        for step in (0, 5):
            for bucket in (0, 3):
                for rnd in (1, 2, 3):
                    for seq in range(0, 96, 1):
                        yield net.PacketHeader(kind=kind, sender=0, step=step,
                                               bucket=bucket, round=rnd,
                                               seq=seq, n_seq=96)


def _ref_header(hdr):
    return ref_net.PacketHeader(**vars(hdr))


@pytest.mark.parametrize("script", ["bernoulli", "burst", "mask", "delay"])
def test_drop_scripts_decide_as_the_reference(script):
    """Every (src, dst, header) gets the reference's verdict (or delay):
    the scripts are host integer hashes of the header, so equal bit for
    bit; the burst chain also answers the same when asked out of order."""
    n, pe = 4, 64
    if script == "bernoulli":
        mine, theirs = net.bernoulli_drops(0.05, 3), \
            ref_net.bernoulli_drops(0.05, 3)
    elif script == "burst":
        mine, theirs = net.burst_drops(0.1, 2), ref_net.burst_drops(0.1, 2)
    elif script == "mask":
        rng = np.random.default_rng(0)
        masks = {r: np.repeat((rng.random((n, 96)) > 0.2)
                              .astype(np.float32), pe, axis=1)
                 for r in range(n)}
        mine, theirs = net.mask_scripted_drops(masks, pe), \
            ref_net.mask_scripted_drops(masks, pe)
    else:
        mine = net.peer_factor_delays(1e-4, (1.0, 6.0, 1.0, 2.0))
        theirs = ref_net.peer_factor_delays(1e-4, (1.0, 6.0, 1.0, 2.0))
    hdrs = list(_headers())
    if script == "burst":
        hdrs = hdrs[::-1]                       # out of order on our side
    got = [mine(s, d, h) for h in hdrs for s in range(n) for d in range(n)
           if s != d]
    hdrs_ref = [_ref_header(h) for h in list(_headers())]
    if script == "burst":
        hdrs_ref = hdrs_ref[::-1]
    want = [theirs(s, d, h) for h in hdrs_ref for s in range(n)
            for d in range(n) if s != d]
    assert got == want
    if script != "delay":
        assert any(got) and not all(got)


@pytest.mark.parametrize("n_elems,packet_elems,seed", [
    (700, 64, 0), (1, 1, 1), (255, 3, 2), (1024, 256, 3), (97, 5, 4)])
def test_reassembly_is_order_free_and_masks_like_drops(n_elems,
                                                       packet_elems, seed):
    """Any arrival order, with duplicates, rebuilds the exact payload; a
    lost packet set gives the port's ``drops._expand`` of the packet mask
    (the tail packet short), and the missing spans read zero."""
    payload = _payload(n_elems, np.float32, seed)
    pkts = net.packetize(payload, kind=net.KIND_DATA1, sender=3, step=1,
                         bucket=2, round=1, packet_elems=packet_elems)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pkts))
    reas = net.Reassembly(n_elems, np.float32, packet_elems)
    for i in list(order) + list(order[:2]):
        reas.add(*net.PacketHeader.decode(pkts[i]))
    assert reas.complete and reas.duplicates == min(2, len(pkts))
    np.testing.assert_array_equal(reas.payload(), payload)
    np.testing.assert_array_equal(reas.mask(), np.ones(n_elems, np.float32))

    keep = rng.random(len(pkts)) > 0.4
    part = net.Reassembly(n_elems, np.float32, packet_elems)
    for i in rng.permutation(len(pkts)):
        if keep[i]:
            part.add(*net.PacketHeader.decode(pkts[i]))
    expect = drops_lib._expand(torch.from_numpy(keep.astype(np.float32)),
                               n_elems, packet_elems).numpy()
    np.testing.assert_array_equal(part.mask(), expect)
    np.testing.assert_array_equal(part.payload()[expect == 1.0],
                                  payload[expect == 1.0])
    assert not np.any(part.payload()[expect == 0.0])
    assert part.frac_received() == pytest.approx(keep.mean())


def test_reassembly_rejects_wrong_geometry_and_sizes():
    payload = _payload(100, np.float32, 0)
    pkts = net.packetize(payload, kind=net.KIND_DATA1, sender=0, step=0,
                         bucket=0, round=1, packet_elems=30)
    reas = net.Reassembly(100, np.float32, 30)
    hdr, frag = net.PacketHeader.decode(pkts[0])
    bad = net.PacketHeader(kind=hdr.kind, sender=hdr.sender, step=hdr.step,
                           bucket=hdr.bucket, round=hdr.round, seq=0,
                           n_seq=9)
    assert not reas.add(bad, frag)
    assert not reas.add(hdr, frag[:-4])
    tail_hdr, tail_frag = net.PacketHeader.decode(pkts[-1])
    assert len(tail_frag) == 10 * 4
    assert reas.add(tail_hdr, tail_frag)
    assert reas.frac_received() == pytest.approx(0.25)


def test_rendezvous_messages_and_state_are_the_reference():
    """The copied rendezvous: a JOIN and a membership view encode to the
    reference's bytes, and both state machines assign ranks, bump
    generations and release barriers alike (a leave mid-run included)."""
    rv, ref_rv = net.rendezvous, ref_net.rendezvous
    assert rv.encode_join(7, "127.0.0.1", 4242) == \
        ref_rv.encode_join(7, "127.0.0.1", 4242)
    mine, theirs = rv.RendezvousState(3), ref_rv.RendezvousState(3)
    log = []
    for st in (mine, theirs):
        out = [st.join(uid, "127.0.0.1", 9000 + uid, now=0.0)
               for uid in (10, 11, 12)]
        for rank in range(3):
            st.barrier_arrive(rank, 0)
        out.append(st.release_ready())
        out.append(st.leave(1))
        out.append(st.membership().encode())
        st.barrier_arrive(0, 1)
        st.barrier_arrive(2, 1)
        out.append(st.release_ready())
        log.append(out)
    assert log[0] == log[1]
    assert rv.PHASES_PER_STEP == ref_rv.PHASES_PER_STEP
    coord = net.LocalCoordinator(2)
    a, b = coord.client(1), coord.client(2)
    assert (a.join()[0], b.join()[0]) == (0, 1)
    assert a.is_live(1) and net.StaticMembership(2).is_live(1)
    coord.close()
