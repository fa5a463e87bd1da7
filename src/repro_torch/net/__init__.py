"""Host-datapath UBT wire transport (DESIGN §7): the port's counterpart of
``src/repro/net``, the same public names.

The paper's core artifact — best-effort packetized gradient exchange with
an adaptive per-round receive deadline, where *actually missing* packets
become the arrival mask the compensated mean absorbs — as a host-side
subsystem:

    wire.py        packet codec: sequenced datagrams <-> payload + mask
                   (bit-compatible with core/drops.py masks)
    backend.py     the Backend datagram-fabric protocol
    inproc.py      deterministic in-memory loopback (scripted drop/delay)
    udp.py         real non-blocking UDP sockets on localhost (threaded
                   UdpBackend + single-socket UdpProcessBackend)
    rendezvous.py  socket rendezvous: rank assignment, generation-numbered
                   elastic membership, heartbeat liveness, phase barriers
    peer.py        HostPeer: one rank's TAR schedule over the wire,
                   membership-view aware
    host_ring.py   HostRing: N peers on one fabric + the bridge feeding
                   WireTransport / StepTelemetry

See ``repro_torch.core.pipeline.WireTransport`` for the sync engine's side
of the bridge and ``launch/train.py --transport={lossy,inproc,udp}`` for
the launcher integration. The multi-process peer runtime on top of the
rendezvous is ROADMAP A18's second half.
"""
from .backend import Backend
from .host_ring import HostRing, aggregate_reports, make_backend, wire_spec
from .inproc import (InprocBackend, bernoulli_drops, burst_drops,
                     mask_scripted_drops, peer_factor_delays)
from .peer import HostPeer, PeerReport, RoundReport
from .rendezvous import (PHASES_PER_STEP, FrameBuffer, LocalCoordinator,
                         LocalClient, Member, Membership, RendezvousClient,
                         RendezvousError, RendezvousFull, RendezvousMessage,
                         RendezvousServer, RendezvousState, RendezvousTimeout,
                         StaticMembership, tcp_available)
from .udp import UdpBackend, UdpProcessBackend, udp_available
from .wire import (HEADER_BYTES, KIND_CTRL, KIND_DATA1, KIND_DATA2,
                   WIRE_VERSION, PacketHeader, Reassembly, WireError,
                   n_packets, packetize)

__all__ = [
    "Backend", "HostRing", "aggregate_reports", "make_backend", "wire_spec",
    "InprocBackend", "bernoulli_drops", "burst_drops", "mask_scripted_drops",
    "peer_factor_delays", "HostPeer", "PeerReport", "RoundReport",
    "UdpBackend", "UdpProcessBackend", "udp_available",
    "PHASES_PER_STEP", "FrameBuffer", "LocalCoordinator", "LocalClient",
    "Member", "Membership", "RendezvousClient", "RendezvousError",
    "RendezvousFull", "RendezvousMessage", "RendezvousServer",
    "RendezvousState", "RendezvousTimeout", "StaticMembership",
    "tcp_available",
    "HEADER_BYTES", "KIND_CTRL", "KIND_DATA1", "KIND_DATA2", "WIRE_VERSION",
    "PacketHeader", "Reassembly", "WireError", "n_packets", "packetize",
]
