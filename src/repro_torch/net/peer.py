"""HostPeer: one rank of the host wire datapath (DESIGN §7).

Counterpart of ``src/repro/net/peer.py``. A peer executes the TAR round
schedule *over the wire*: it encodes its bucket with the strategy's codec,
packetizes each stage-1 shard into sequenced datagrams, exchanges them
through a :class:`~repro_torch.net.backend.Backend`, reassembles whatever
arrived before the adaptive per-round deadline into a received matrix plus
an observed arrival mask, and runs the same drop-compensated reduce /
stage-2 broadcast / decode the sync engine runs.

The engine (``core/pipeline.py``) works on stacks of P peers; a peer is one
rank, so its stage functions call the *same* codec objects on P = 1 stacks
on the peer's ``device`` (on the card: the same kernel launches, one row
each): encode (pre-exchange), reduce + re-encode (between the stages),
decode (post-exchange). Each kernel computes a row from that row alone, so
the result is bitwise the engine's under ``Lossy`` with the same arrival
masks. The only cross-peer arithmetic, the quantizing codec's grid ``pmax``,
is an elementwise max and therefore order-free: max-sharing the amax
vectors over the control channel reproduces it exactly. A peer's random
operands (the Hadamard sign, the quantizer's noises) come from a
:class:`~repro_torch.core.pipeline.Draws` provider at the bucket's site,
as the engine's do.

Telemetry is the other product: per-round stage completion times, t_B
expiry flags, and received fractions (exactly ``AdaptiveTimeout.update``'s
inputs), plus per-sender last-arrival times (the straggler detector's
signal), accumulate in a :class:`PeerReport` per exchange.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import tar as tar_lib
from repro_torch.core.pipeline import (Draws, Encoded, HTQuant,
                                       OptiReduceConfig, SyncContext,
                                       TarTopology, resolve_spec)
from repro_torch.core.ubt import AdaptiveTimeout, LossBudget
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import trace as obs_trace

from .backend import Backend
from .wire import (KIND_CTRL, KIND_DATA1, KIND_DATA2, KIND_RELAY,
                   PacketHeader, Reassembly, WireError, n_packets, packetize,
                   unwrap_relay, wrap_relay)


@dataclasses.dataclass
class RoundReport:
    """One receive round as this peer observed it."""
    time: float                 # completion (or expiry) time, stage-relative
    timed_out: bool             # missing packets at the deadline
    frac_received: float        # fraction of expected packets that arrived


@dataclasses.dataclass
class PeerReport:
    """One exchange's observations at this receiver."""
    rounds: list[RoundReport] = dataclasses.field(default_factory=list)
    # last-arrival time per sender (NaN = nothing observed; a fully-dropped
    # sender is charged the deadline — waiting on it cost exactly that)
    sender_last_t: np.ndarray | None = None
    dropped: float = 0.0        # stage-1 mask entries lost
    total: float = 0.0          # stage-1 mask entries expected
    stage2_dropped: float = 0.0
    stage2_total: float = 0.0
    stage_time: float = 0.0     # sum of round completion times
    # senders skipped because the membership view says they are dead: their
    # rounds cost nothing, their mask rows are excluded from loss accounting
    # (a known-dead peer is degradation the control plane already decided,
    # not packet loss for the Hadamard/incast controllers to react to)
    skipped_senders: tuple[int, ...] = ()
    # directed (src, dst=this receiver) links observed *fully* lossy while
    # at least one other sender's stream completed — a link-fault suspect
    # (not a straggler: a slow peer still lands some packets), folded into
    # StepTelemetry.dead_link_events by ``host_ring.aggregate_reports``
    lost_links: tuple[tuple[int, int], ...] = ()

    def merge(self, other: "PeerReport") -> None:
        self.rounds.extend(other.rounds)
        self.lost_links = tuple(sorted(set(self.lost_links)
                                       | set(other.lost_links)))
        if other.sender_last_t is not None:
            if self.sender_last_t is None:
                self.sender_last_t = other.sender_last_t.copy()
            else:
                self.sender_last_t = np.fmax(self.sender_last_t,
                                             other.sender_last_t)
        self.dropped += other.dropped
        self.total += other.total
        self.stage2_dropped += other.stage2_dropped
        self.stage2_total += other.stage2_total
        self.stage_time += other.stage_time
        self.skipped_senders = self.skipped_senders + other.skipped_senders


class _PacketStore:
    """Per-peer buffer of drained datagrams keyed by reassembly stream."""

    def __init__(self):
        self._streams: dict[tuple, list[tuple[PacketHeader, bytes, float]]] \
            = {}

    def ingest(self, datagrams: list[tuple[bytes, float]], step: int) -> None:
        for dgram, t in datagrams:
            try:
                hdr, frag = PacketHeader.decode(dgram)
            except Exception:
                continue                      # garbage datagram: drop it
            if hdr.step != step:
                continue                      # stale step: discard
            self._streams.setdefault(hdr.stream(), []).append((hdr, frag, t))

    def take(self, stream: tuple) -> list[tuple[PacketHeader, bytes, float]]:
        return self._streams.pop(stream, [])

    def clear(self) -> None:
        self._streams.clear()


class HostPeer:
    """One rank's engine over a wire backend (see module docstring)."""

    def __init__(self, rank: int, backend: Backend, cfg: OptiReduceConfig, *,
                 timeout: AdaptiveTimeout | None = None,
                 default_deadline: float | None = None,
                 budget: LossBudget | None = None,
                 membership=None,
                 shard_weights: tuple[int, ...] | None = None,
                 dead_links: tuple[tuple[int, int], ...] = (),
                 device: torch.device | str | None = None):
        self.rank = int(rank)
        # where the stage functions run: the card unless the caller asks
        # for the CPU
        self.device = resolve_device(device)
        self.n = backend.n_peers
        self.backend = backend
        self.cfg = cfg
        # membership view (rendezvous client or StaticMembership): which of
        # the n rank slots are live *right now*.  None = fixed full world.
        # A dead rank's rounds are skipped outright — no deadline burned,
        # nothing sent its way — which is how rendezvous leave/death events
        # map onto the same degraded-participation schedules the
        # ControlPlane's ejections use (DESIGN §9).
        self.membership = membership
        spec = resolve_spec(cfg)
        if not isinstance(spec.topology, TarTopology):
            raise ValueError(
                f"strategy {cfg.strategy!r} resolves to "
                f"{type(spec.topology).__name__}; the host wire datapath "
                "executes TAR schedules (ring/tree reduce in flight — "
                "there is no receive stage to mask)")
        if cfg.pod_axis is not None or cfg.active_peers is not None:
            raise ValueError("host wire datapath: single data axis, "
                             "full participation only")
        self.codec = spec.codec
        # straggler-proportional shard ownership: rank p owns shard_weights[p]
        # units of the bucket (uniform normalizes to None so the default
        # wire trace stays bitwise-identical to the seed)
        if shard_weights is not None:
            w = tuple(int(u) for u in shard_weights)
            if len(w) != self.n:
                raise ValueError(f"shard_weights has {len(w)} entries for "
                                 f"{self.n} peers")
            if any(u < 1 for u in w):
                raise ValueError("shard_weights must be positive")
            if not self.codec.linear:
                raise ValueError(
                    "shard_weights require a linear codec: a quantizing "
                    "codec keys its grids on uniform shard geometry")
            if cfg.recovery != "none":
                raise ValueError("shard_weights: recovery codecs assume "
                                 "uniform shard geometry")
            shard_weights = None if len(set(w)) == 1 else w
        self.shard_weights = shard_weights
        # directed edges the control plane declared dead: sends crossing one
        # are relay-wrapped through a live third peer instead of ejecting
        # either endpoint
        dl = set()
        for (src, dst) in dead_links:
            src, dst = int(src), int(dst)
            if not (0 <= src < self.n and 0 <= dst < self.n) or src == dst:
                raise ValueError(f"dead link ({src}, {dst}) is not a "
                                 f"directed edge between distinct ranks "
                                 f"< {self.n}")
            dl.add((src, dst))
        self.dead_links = tuple(sorted(dl))
        # padding denominator: total shard units (== n when uniform)
        self._pad_n = (self.n if self.shard_weights is None
                       else sum(self.shard_weights))
        self.timeout = timeout
        self.budget = budget
        self.default_deadline = (default_deadline if default_deadline
                                 is not None else
                                 (1.0 if backend.virtual_time else 0.25))
        self.packet_elems = cfg.packet_elems
        self._store = _PacketStore()
        # in-flight state between phases of one exchange
        self._held: dict = {}
        # last exchange's observed (n, s) stage-1 / stage-2 arrival masks —
        # what the EF residual accounting reconstructs lost mass from
        self.last_mask1: np.ndarray | None = None
        self.last_mask2: np.ndarray | None = None

    # ---------------------------------------------------------- stage fns
    # The codec on one-row stacks: (1, L) buckets, (1, N, S) received
    # shards, shard_index (1,) naming this rank's shard.
    def _ctx(self, draws: Draws, bucket: int,
             stale: torch.Tensor | None = None) -> SyncContext:
        return SyncContext(cfg=self.cfg, draws=draws, bucket=bucket,
                           stale=stale)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _padded(self, x) -> torch.Tensor:
        # pad to the shard-unit total, not the peer count: with weighted
        # shards each unit must stay block-aligned (uniform: pad_n == n)
        x, _ = tar_lib.pad_for_tar(self._tensor(x)[None], self._pad_n,
                                   self.codec.block(self.cfg))
        return x

    def _enc(self, x, draws, bucket, stale):
        """(wire (L',), stale_w): the encoded bucket and, for a stale-fill
        codec, the previous step's bucket under this step's sign."""
        e = self.codec.encode(self._padded(x),
                              self._ctx(draws, bucket, stale))
        return e.data[0], e.stale

    def _enc_local(self, x, draws, bucket):
        """Quantizing codec, before the grid max-share: (x, amax (nblk,))."""
        x1, amax = self.codec.local_amax(self._padded(x),
                                         self._ctx(draws, bucket))
        return x1, amax[0]

    def _enc_finish(self, x1, amax, draws, bucket):
        """Quantizing codec, after it: the codes (L',) and the grids."""
        e = self.codec.encode_given_amax(x1, amax, self._ctx(draws, bucket))
        return e.data[0], e.lo, e.step

    def _red(self, received, mask, lo, step, stale_w, draws, bucket):
        """This rank's compensated reduce and stage-2 encode, (S,)."""
        ctx = self._ctx(draws, bucket)
        enc = Encoded(None, lo=lo, step=step, stale=stale_w)
        me = torch.tensor([self.rank], device=self.device)
        own = self.codec.reduce(self._tensor(received)[None],
                                self._tensor(mask)[None], enc, ctx,
                                shard_index=me)
        return self.codec.encode_shard(own, enc, ctx, shard_index=me)[0]

    def _dec(self, gathered, lo, step, draws, bucket):
        return self.codec.decode_gathered(
            self._tensor(gathered)[None], Encoded(None, lo=lo, step=step),
            self._ctx(draws, bucket))[0]

    # ------------------------------------------------------- receive loop
    def _ingest(self, step: int) -> None:
        """Drain the backend mailbox into the packet store, forwarding any
        relay-wrapped datagram (dead-link reroute) to its final destination
        — this peer is the relay hop for it, not the receiver."""
        me = self.rank
        direct: list[tuple[bytes, float]] = []
        for dgram, t in self.backend.poll(me):
            if len(dgram) >= 2 and dgram[1] == KIND_RELAY:
                try:
                    dst, inner = unwrap_relay(dgram)
                except WireError:
                    continue              # garbage wrap: drop it
                if dst == me:             # degenerate wrap: just ingest
                    direct.append((inner, t))
                else:
                    self.backend.send(me, dst, inner)
            else:
                direct.append((dgram, t))
        self._store.ingest(direct, step)

    def relay_pump(self, step: int) -> None:
        """One explicit mailbox drain so relay-wrapped datagrams move on.

        Virtual-time backends deliver everything in a single drain and
        ``wait`` never blocks, so a relay hop that is itself busy in a
        send phase would otherwise forward its wrapped datagrams only
        after the final receiver stopped polling — the ring pumps
        every peer between send and receive phases to make two-hop
        delivery deterministic.  Direct datagrams drained here are kept
        in the packet store for the coming receive phase."""
        self._ingest(step)

    def round_deadline(self) -> float:
        if self.timeout is not None:
            d = self.timeout.round_deadline_or(self.default_deadline)
        else:
            d = self.default_deadline
        if self.budget is not None:
            # accept-or-extend (DESIGN §8): while the observed loss EMA
            # overruns the phase-tightening budget, wait up to max_stretch×
            # longer so late packets are recovered instead of masked out
            d = self.budget.stretch(d)
        return d

    #: fraction of a stream's packets counting as "last percentile seen"
    last_pctile = 0.99

    def _early_deadline(self, arrivals: dict, n_seq: int,
                        hard: float) -> float:
        """§3.2.1 early timeout: once the last-percentile markers of the
        stream are in, wait only x% of t_C more — bounded by the hard t_B
        budget (inactive until the AdaptiveTimeout is fully profiled)."""
        at = self.timeout
        if at is None or at.t_b is None or at.t_c is None:
            return hard
        need = min(n_seq, max(1, int(self.last_pctile * n_seq)))
        if len(arrivals) < need:
            return hard
        t_seen = sorted(rel for rel, _, _ in arrivals.values())[need - 1]
        return min(hard, t_seen + at.x * at.t_c)

    def _recv_stream(self, kind: int, step: int, bucket: int, rnd: int,
                     sender: int, n_elems: int, dtype, deadline: float,
                     packet_elems: int | None = None
                     ) -> tuple[Reassembly, float, float]:
        """Receive one (round, sender) stream until complete or expired.

        The budget is two-phase: the hard bound ``deadline`` (t_B), then —
        once the last-percentile of expected packets has arrived — the
        early deadline x%*t_C past that point.  Returns the reassembly,
        the last *accepted* arrival time relative to the round start (0.0
        when nothing arrived in time), and the effective deadline charged
        (what the receiver actually budgeted for this stream).
        """
        be, me = self.backend, self.rank
        t0 = be.now(me)
        pe = packet_elems or self.packet_elems
        n_seq = n_packets(n_elems, pe)
        stream = (kind, bucket, rnd, sender)
        # first arrival per seq; duplicates and beyond-hard-late packets
        # drop here, the rest replays through Reassembly after the
        # effective deadline is known (deterministic for virtual time too)
        arrivals: dict[int, tuple[float, PacketHeader, bytes]] = {}
        eff = deadline
        while True:
            self._ingest(step)
            for hdr, frag, t in self._store.take(stream):
                rel = max(0.0, t - t0)
                if rel <= deadline and 0 <= hdr.seq < n_seq \
                        and hdr.seq not in arrivals:
                    arrivals[hdr.seq] = (rel, hdr, frag)
            eff = self._early_deadline(arrivals, n_seq, deadline)
            if len(arrivals) >= n_seq:
                break
            if be.now(me) - t0 >= eff or not be.wait(me, 1e-3):
                break
        reas = Reassembly(n_elems, dtype, pe)
        last_t = 0.0
        for rel, hdr, frag in sorted(arrivals.values(), key=lambda a: a[0]):
            if rel <= eff and reas.add(hdr, frag):
                last_t = max(last_t, rel)
        return reas, last_t, eff

    def _recv_rounds(self, kind: int, step: int, bucket: int, n_elems,
                     dtype) -> tuple[dict[int, Reassembly], PeerReport]:
        """Run the N-1 receive rounds; round r expects sender (me-r)%n.

        ``n_elems`` is the expected stream length — an int when every
        sender's stream is the same size, or a callable ``sender -> int``
        for weighted shards (stage 2 receives each owner's own-size slice).
        """
        me, n = self.rank, self.n
        # hoisted tracer gate: one module-global read per exchange, then a
        # local ``is not None`` test per round (DESIGN §12)
        tr = obs_trace.get_tracer()
        report = PeerReport(sender_last_t=np.full(n, np.nan))
        report.sender_last_t[me] = 0.0
        streams: dict[int, Reassembly] = {}
        for r in range(1, n):
            sender = (me - r) % n
            if self.membership is not None \
                    and not self.membership.is_live(sender):
                # a known-dead sender costs nothing: no deadline burned,
                # its mask row stays zero (the compensated mean excludes
                # it) and its sender_last_t stays NaN (unobserved — the
                # straggler detector must not score a corpse)
                report.rounds.append(RoundReport(
                    time=0.0, timed_out=False, frac_received=1.0))
                report.skipped_senders += (sender,)
                continue
            deadline = self.round_deadline()
            ne = n_elems(sender) if callable(n_elems) else n_elems
            rt0 = self.backend.now(me) if tr is not None else 0.0
            reas, last_t, eff = self._recv_stream(kind, step, bucket, r,
                                                  sender, ne, dtype,
                                                  deadline)
            streams[sender] = reas
            # an incomplete round costs the receiver the effective deadline
            # (it kept waiting on the gap until expiry); the *sender* is
            # charged that only when nothing of its stream made it — a peer
            # with a few lost packets must not score as a straggler
            round_t = last_t if reas.complete else eff
            sender_t = last_t if reas.received_packets > 0 else eff
            frac = reas.frac_received()
            if tr is not None:
                tr.complete("round", "wire", ts=rt0, dur=min(round_t, eff),
                            tid=sender,
                            args={"step": step, "bucket": bucket,
                                  "kind": kind, "round": r, "sender": sender,
                                  "receiver": me, "frac_received": frac,
                                  "timed_out": not reas.complete,
                                  "deadline": deadline, "eff_deadline": eff})
                if not reas.complete:
                    tr.event("timeout", "wire", ts=rt0 + eff, tid=sender,
                             args={"step": step, "bucket": bucket,
                                   "round": r, "sender": sender,
                                   "receiver": me, "frac_received": frac})
            report.rounds.append(RoundReport(
                time=min(round_t, eff), timed_out=not reas.complete,
                frac_received=frac))
            report.sender_last_t[sender] = min(sender_t, eff)
            report.stage_time += min(round_t, eff)
        if any(reas.complete for reas in streams.values()):
            # a sender whose stream landed *zero* packets while another
            # sender's completed is a link-fault suspect, not a straggler
            # (a slow peer still lands some packets) and not an outage
            # (something got through): report the directed edge
            report.lost_links = tuple(sorted(
                (sender, me) for sender, reas in streams.items()
                if reas.received_packets == 0))
        return streams, report

    def _assemble(self, streams: dict[int, Reassembly], own: np.ndarray,
                  s: int, dtype, sizes=None) -> tuple[np.ndarray, np.ndarray]:
        """(n, s) received matrix + arrival mask in sender order.

        ``sizes[sender]`` (optional) is the valid prefix of each row under
        weighted shards; the zero tail is marked *arrived* (mask 1.0) — it
        is planned padding, not loss, and the compensated mean averages the
        zeros exactly like the engine's weighted rows do."""
        n, me = self.n, self.rank
        received = np.zeros((n, s), dtype)
        mask = np.zeros((n, s), np.float32)
        received[me] = own
        mask[me] = 1.0
        for sender, reas in streams.items():
            w = s if sizes is None else sizes[sender]
            received[sender, :w] = reas.payload()
            mask[sender, :w] = reas.mask()
            mask[sender, w:] = 1.0
        return received, mask

    # ------------------------------------------------------------- phases
    # One allreduce = four phases with a backend barrier between them (the
    # ring in host_ring.py runs them across peers, threaded or in lockstep)

    def _send_datagram(self, dst: int, dgram: bytes, step: int) -> None:
        """Post one datagram, relay-wrapping it around a dead (me, dst)
        edge through the first live third peer (``tar.relay_via`` — the
        same relay the engine's round schedule takes)."""
        me = self.rank
        if (me, dst) in self.dead_links:
            live = tuple(p for p in range(self.n)
                         if self.membership is None
                         or self.membership.is_live(p))
            m = tar_lib.relay_via(me, dst, live, self.dead_links)
            self.backend.send(me, m, wrap_relay(me, dst, step, dgram))
        else:
            self.backend.send(me, dst, dgram)

    def _send_shards(self, shards: np.ndarray, kind: int, step: int,
                     bucket: int, sizes=None) -> None:
        me, n = self.rank, self.n
        for r in range(1, n):
            dst = (me + r) % n
            if self.membership is not None \
                    and not self.membership.is_live(dst):
                continue                  # no socket to reach a dead rank
            row = shards[dst] if shards.ndim == 2 else shards
            if sizes is not None and shards.ndim == 2:
                row = row[:sizes[dst]]    # weighted: send the valid prefix
            for dgram in packetize(np.ascontiguousarray(row), kind=kind,
                                   sender=me, step=step, bucket=bucket,
                                   round=r, packet_elems=self.packet_elems):
                self._send_datagram(dst, dgram, step)

    def phase1_encode(self, x, draws: Draws, step: int, bucket: int,
                      stale=None) -> None:
        """Encode the bucket ``x`` ``(L,)`` (a tensor or an array) under
        ``draws`` at site ``bucket``; for quantizing codecs, advertise the
        local per-block amax on the control channel.  ``stale`` is the
        previous step's decoded bucket for StaleFill recovery codecs
        (ignored — and unreachable — for quantized codecs: ``wrap_codec``
        rejects them)."""
        tr = obs_trace.get_tracer()
        t0 = self.backend.now(self.rank) if tr is not None else 0.0
        self._store.clear()
        if isinstance(self.codec, HTQuant):
            x1, amax = self._enc_local(x, draws, bucket)
            amax_np = amax.cpu().numpy().astype(np.float32)
            for dgram in packetize(amax_np, kind=KIND_CTRL, sender=self.rank,
                                   step=step, bucket=bucket, round=0,
                                   packet_elems=max(1, amax_np.shape[0])):
                for dst in range(self.n):
                    if dst == self.rank or (self.membership is not None and
                                            not self.membership.is_live(dst)):
                        continue
                    self._send_datagram(dst, dgram, step)
            self._held = {"x1": x1, "amax": amax_np, "draws": draws,
                          "stale_w": None, "length": x.shape[-1]}
        else:
            stale_t = None if stale is None else self._tensor(stale)
            data, stale_w = self._enc(x, draws, bucket, stale_t)
            self._held = {"wire1": data.cpu().numpy(), "lo": None,
                          "step": None, "stale_w": stale_w, "draws": draws,
                          "length": x.shape[-1]}
        if tr is not None:
            tr.complete("encode", "wire", ts=t0,
                        dur=self.backend.now(self.rank) - t0, tid=self.rank,
                        args={"step": step, "bucket": bucket})

    def phase2_send_stage1(self, step: int, bucket: int) -> None:
        """Finish the encode (grid max-share for quantizing codecs) and put
        every stage-1 shard on the wire."""
        tr = obs_trace.get_tracer()
        t0 = self.backend.now(self.rank) if tr is not None else 0.0
        h = self._held
        if isinstance(self.codec, HTQuant):
            shared = h["amax"].copy()
            nblk = shared.shape[0]
            deadline = self.round_deadline()
            for p in range(self.n):
                if p == self.rank or (self.membership is not None and
                                      not self.membership.is_live(p)):
                    continue
                reas, _, _ = self._recv_stream(KIND_CTRL, step, bucket, 0, p,
                                               nblk, np.float32, deadline,
                                               packet_elems=max(1, nblk))
                if reas.complete:     # a lost grid degrades, never blocks
                    shared = np.maximum(shared, reas.payload())
            data, lo, stp = self._enc_finish(
                h["x1"], self._tensor(shared), h["draws"], bucket)
            h["wire1"], h["lo"], h["step"] = data.cpu().numpy(), lo, stp
            del h["x1"], h["amax"]
        wire1 = h["wire1"]
        if self.shard_weights is not None:
            # weighted shard geometry: rank p owns the contiguous slice
            # [offsets[p], offsets[p]+sizes[p]) — rows are zero-padded to
            # the static s_max exactly like ``tar.weighted_rows``
            plan = tar_lib.shard_plan(wire1.shape[0], self.shard_weights,
                                      self.codec.block(self.cfg))
            if plan.padded != wire1.shape[0]:
                raise ValueError(
                    f"encoded bucket of {wire1.shape[0]} elements is not "
                    f"padded for weights {self.shard_weights} "
                    f"(need a multiple of {plan.padded})")
            shards = np.zeros((self.n, plan.s_max), wire1.dtype)
            for p in range(self.n):
                shards[p, :plan.sizes[p]] = \
                    wire1[plan.offsets[p]:plan.offsets[p] + plan.sizes[p]]
            h["plan"], h["shards"] = plan, shards
            self._send_shards(shards, KIND_DATA1, step, bucket,
                              sizes=plan.sizes)
        else:
            s = wire1.shape[0] // self.n
            h["plan"] = None
            h["shards"] = wire1.reshape(self.n, s)
            self._send_shards(h["shards"], KIND_DATA1, step, bucket)
        if tr is not None:
            tr.complete("send_stage1", "wire", ts=t0,
                        dur=self.backend.now(self.rank) - t0, tid=self.rank,
                        args={"step": step, "bucket": bucket})

    def phase3_reduce_send_stage2(self, step: int, bucket: int) -> PeerReport:
        """Receive stage 1 under the per-round deadlines, run the codec's
        compensated reduce, and broadcast the re-encoded shard."""
        tr = obs_trace.get_tracer()
        t0 = self.backend.now(self.rank) if tr is not None else 0.0
        h = self._held
        plan = h["plan"]
        s = h["shards"].shape[1]
        # under weighted shards every sender posts me *my* slice — a stream
        # of sizes[me] elements — into a row zero-padded to the static s_max
        valid = s if plan is None else plan.sizes[self.rank]
        streams, report = self._recv_rounds(KIND_DATA1, step, bucket, valid,
                                            h["wire1"].dtype)
        sizes1 = None if plan is None else (valid,) * self.n
        received, mask = self._assemble(streams, h["shards"][self.rank], s,
                                        h["wire1"].dtype, sizes=sizes1)
        # skipped (known-dead) senders' all-zero rows are planned
        # degradation, not packet loss: exclude them from both counters so
        # loss_frac keeps driving the Hadamard/incast controllers correctly
        # (weighted: count only the valid prefixes — padding cannot drop)
        skipped = len(report.skipped_senders)
        report.dropped = float(np.sum(1.0 - mask[:, :valid])) \
            - skipped * valid
        report.total = float(self.n * valid) - skipped * valid
        wire2 = self._red(received, mask, h["lo"], h["step"], h["stale_w"],
                          h["draws"], bucket).cpu().numpy()
        h["wire2"], h["mask1"] = wire2, mask
        self.last_mask1 = mask            # observed arrival mask, kept for
        # EF accounting; weighted broadcasts only the owned valid prefix
        out2 = wire2 if plan is None else wire2[:valid]
        self._send_shards(out2, KIND_DATA2, step, bucket)
        if tr is not None:
            tr.complete("exchange", "wire", ts=t0,
                        dur=self.backend.now(self.rank) - t0, tid=self.rank,
                        args={"step": step, "bucket": bucket,
                              "dropped": report.dropped,
                              "total": report.total})
        return report

    def phase4_decode(self, step: int, bucket: int
                      ) -> tuple[torch.Tensor, PeerReport]:
        """Receive the stage-2 broadcast, reassemble the flat bucket, and
        decode to ``(L,)`` on the peer's device.  A missing stage-2 span
        stays zero — a real gap the codec decodes through (drops are
        modeled on stage 1; see DESIGN §2) — and is charged to
        ``stage2_dropped``."""
        tr = obs_trace.get_tracer()
        t0 = self.backend.now(self.rank) if tr is not None else 0.0
        h = self._held
        plan = h["plan"]
        s2 = h["wire2"].shape[0]
        if plan is None:
            streams, report = self._recv_rounds(KIND_DATA2, step, bucket, s2,
                                                h["wire2"].dtype)
            gathered, mask2 = self._assemble(streams, h["wire2"], s2,
                                             h["wire2"].dtype)
            skipped = len(report.skipped_senders)
            report.stage2_dropped = float(np.sum(1.0 - mask2)) - skipped * s2
            report.stage2_total = float(mask2.size) - skipped * s2
            flat = gathered.reshape(-1)
        else:
            # each owner q broadcast its own-size slice: per-sender stream
            # lengths, per-row valid prefixes, and a weighted_flat-style
            # concatenation of the prefixes back into the flat bucket
            sizes = plan.sizes
            streams, report = self._recv_rounds(
                KIND_DATA2, step, bucket, lambda q: sizes[q],
                h["wire2"].dtype)
            gathered, mask2 = self._assemble(streams, h["wire2"], s2,
                                             h["wire2"].dtype, sizes=sizes)
            skip_elems = float(sum(sizes[p] for p in report.skipped_senders))
            drop2 = float(sum(np.sum(1.0 - mask2[p, :sizes[p]])
                              for p in range(self.n)))
            report.stage2_dropped = drop2 - skip_elems
            report.stage2_total = float(sum(sizes)) - skip_elems
            flat = np.concatenate([gathered[p, :sizes[p]]
                                   for p in range(self.n)])
        self.last_mask2 = mask2
        out = self._dec(flat, h["lo"], h["step"], h["draws"], bucket)
        out = out[:h["length"]]
        self._held = {}
        if tr is not None:
            tr.complete("decode", "wire", ts=t0,
                        dur=self.backend.now(self.rank) - t0, tid=self.rank,
                        args={"step": step, "bucket": bucket,
                              "stage2_dropped": report.stage2_dropped,
                              "stage2_total": report.stage2_total})
        return out, report

    # ------------------------------------------------------- bridge mode
    def bridge_receive(self, shards: np.ndarray, step: int, bucket: int
                       ) -> tuple[np.ndarray, PeerReport]:
        """One receiver's half of a bridge exchange whose sends are already
        posted (the HostRing completer drives every peer's sends first,
        then each receive, in one thread — no cross-thread rendezvous
        anywhere): receive stage 1 under the adaptive deadlines and return
        the observed (n, s) arrival mask (the sync engine's all_to_all moves
        the authoritative bytes)."""
        n, me = self.n, self.rank
        if shards.shape[0] != n:
            raise ValueError(f"bridge expects (n={n}, s) shards, "
                             f"got {shards.shape}")
        s = shards.shape[1]
        streams, report = self._recv_rounds(KIND_DATA1, step, bucket, s,
                                            shards.dtype)
        _, mask = self._assemble(streams, shards[me], s, shards.dtype)
        skipped = len(report.skipped_senders)
        report.dropped = float(np.sum(1.0 - mask)) - skipped * s
        report.total = float(mask.size) - skipped * s
        return mask, report

    def bridge_send(self, shards: np.ndarray, step: int, bucket: int) -> None:
        """Post this peer's stage-1 sends for a bridge exchange."""
        self._store.clear()
        self._send_shards(shards, KIND_DATA1, step, bucket)
