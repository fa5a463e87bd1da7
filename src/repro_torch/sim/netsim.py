"""Cloud-network simulator: tail-calibrated gradient-aggregation timing.

The port's copy of ``src/repro/sim/netsim.py`` (numpy only): the same
draws from the same seeds give the same results, bitwise.

Models the paper's evaluation environments (§5.1):

* Base per-transfer latency is lognormal, calibrated so P99/P50 matches the
  target environment (local cluster 1.5 / 3.0, CloudLab ~1.45; Fig 3/10),
  plus a bandwidth serialization term.
* **TCP stalls** — the mechanism §3.2 identifies: with probability
  ``stall_prob`` a flow loses its tail packets and blocks for an RTO before
  retransmitting. Reliable transports (Gloo/NCCL/TAR+TCP) eat the stall;
  UBT *drops* those bytes instead and progresses (bounded by the adaptive
  timeout). This single loss process therefore produces both the baselines'
  tail inflation and OptiReduce's (small) gradient-drop rate — matching the
  paper's Table 1 shape (drops 0.05–0.18% while TTA stays flat).

Round structures per collective:
  ring      2(N-1) synchronized rounds, chunk B/N, round = max over pairs
  bcube     2*log_b(N) stages; each node sends (b-1) chunks serialized on
            its link per stage
  tree      2*log2(N) rounds, halving/doubling chunk sizes
  ps        gather with N-fold incast serialization at the server + bcast
  tar_tcp   2*ceil((N-1)/I) rounds, chunk B/N, reliable
  optireduce  TAR rounds bounded by UBT: t_B = P95 of profiled stage times,
            early timeout at (all-senders' last-percentile time) + x%*t_C,
            x adapted by the §3.2.1 rule; late tails are dropped; dynamic
            incast adapts I.

``library_factor`` models the Gloo-vs-NCCL implementation gap (the paper
benchmarks both; NCCL's GPU-direct transport is faster at equal topology).
All draws are deterministic in the seed.

The OptiReduce paths consume the runtime :class:`ControlPlane` (DESIGN §5)
— the same controller bundle the trainer uses — instead of private copies
of the §3.2 state machines: the simulator produces :class:`StepTelemetry`
(per-peer transfer times, per-round stage times/timeouts, loss fraction)
and obeys the returned :class:`SyncPolicy` (incast, timeout x%, and the
degraded-participation active-peer set).  ``NetworkModel.peer_factors``
adds the persistent-straggler latency model: a per-peer multiplier on
every transfer that peer sends, so ``bench_timeout``/``bench_tta`` can
price ejection against wait-for-all.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.ubt import TimelyRateControl
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import ControlPlane, StepTelemetry


@dataclasses.dataclass
class NetworkModel:
    median_ms: float = 0.35          # per-transfer base latency median
    p99_over_p50: float = 1.5        # tail-to-median calibration (Fig 10)
    bandwidth_GBps: float = 3.0      # per-link (25 Gbps, §5.1a)
    stall_prob: float = 0.01         # per-flow TCP tail-loss/RTO episodes
    rto_ms: float = 40.0             # datacenter min-RTO-ish stall length
    drop_frac_per_stall: float = 0.01  # UBT: bytes lost when a flow stalls
    seed: int = 0
    # persistent-straggler model: multiplier on every transfer peer p sends
    # (None = homogeneous). Mutable mid-run (a peer degrading / healing).
    peer_factors: tuple[float, ...] | None = None
    # Gilbert–Elliott burst-loss parameters fitted from wire-observed mask
    # run-lengths (from_drop_trace(masks=...)): p = P(Good->Bad) and
    # r = P(Bad->Good) per packet. None = the i.i.d.-round process above is
    # the whole loss model (seed behavior).
    burst_p: float | None = None
    burst_r: float | None = None

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        # lognormal: P99/P50 = exp(2.3263 * sigma)
        self.sigma = math.log(max(self.p99_over_p50, 1.0 + 1e-9)) / 2.3263
        self.mu = math.log(self.median_ms)

    def _per_peer(self, n: int):
        """Per-peer latency multipliers when the draw is one-per-peer."""
        if self.peer_factors is not None and len(self.peer_factors) == n:
            return np.asarray(self.peer_factors, dtype=np.float64)
        return 1.0

    @classmethod
    def from_drop_trace(cls, trace, *, masks=None, seed: int = 0,
                        **kw) -> "NetworkModel":
        """Calibrate the UBT loss process from a *wire-observed* per-round
        loss-fraction trace (``1 - round_frac_received`` from the host
        transport's :class:`~repro_torch.runtime.StepTelemetry`).

        The simulator's loss process is two-parameter — a round is lossy
        with ``stall_prob`` and a lossy flow sheds ``drop_frac_per_stall``
        of its bytes in expectation (``ubt_ms`` draws uniform(0.2, 1.8) ×
        that) — so the moment match is direct: ``stall_prob`` = the
        fraction of observed rounds with any loss, ``drop_frac_per_stall``
        = the mean loss among those rounds.  The calibration test in
        tests/test_sim.py pins that a model built this way predicts the
        observed ``loss_frac``.

        ``masks`` (optional): packet-granular 0/1 arrival masks as observed
        on the wire (rows = per-sender packet streams; any iterable of 1-D
        or 2-D arrays). When given, the *burstiness* of the loss is fitted
        too: zero-run lengths across the streams give the Gilbert–Elliott
        ``burst_r`` (1 / mean burst length) and, with the stationary loss
        rate, ``burst_p`` — the exact parameterization
        ``core.drops.gilbert_elliott_params`` uses to synthesize burst
        masks, so wire-fitted and synthetic burst processes agree.
        """
        t = np.asarray(list(trace), dtype=np.float64)
        if t.size == 0:
            raise ValueError("empty drop trace")
        if not np.all((t >= 0) & (t <= 1)):    # NaN fails both comparisons
            raise ValueError("trace entries must be loss fractions in [0,1]")
        lossy = t > 0.0
        stall_prob = float(np.mean(lossy))
        per_stall = float(np.mean(t[lossy])) if lossy.any() else 0.0
        ge = {}
        if masks is not None:
            p, r = fit_gilbert_elliott(masks)
            if p is not None:
                ge = {"burst_p": p, "burst_r": r}
        return cls(stall_prob=stall_prob, drop_frac_per_stall=per_stall,
                   seed=seed, **ge, **kw)

    def burst_loss_seq(self, n_pkts: int) -> np.ndarray:
        """Synthesize a 0/1 packet-loss sequence (1 = lost) from the fitted
        Gilbert–Elliott parameters — the cross-validation generator: its
        run-length statistics must match the wire masks the fit consumed.
        Draws from the model's own rng (deterministic in ``seed``)."""
        if self.burst_p is None or self.burst_r is None:
            raise ValueError("no fitted burst parameters; calibrate with "
                             "from_drop_trace(masks=...)")
        p, r = self.burst_p, self.burst_r
        stationary = p / max(p + r, 1e-12)
        u = self.rng.random(n_pkts + 1)
        lost = np.zeros(n_pkts, dtype=np.float64)
        bad = u[0] < stationary
        for k in range(n_pkts):
            bad = (u[k + 1] >= r) if bad else (u[k + 1] < p)
            lost[k] = 1.0 if bad else 0.0
        return lost

    @classmethod
    def environment(cls, name: str, seed: int = 0) -> "NetworkModel":
        """The paper's three environments (§5.1/§5.2). The tail-to-median
        calibration applies to the whole transfer (the paper's background
        workloads congest links, so for MB-sized gradient chunks the tail
        is bandwidth variability, not just latency)."""
        if name == "local_1.5":
            return cls(p99_over_p50=1.5, stall_prob=0.004, seed=seed)
        if name == "local_3.0":
            return cls(p99_over_p50=3.0, stall_prob=0.010, seed=seed)
        if name == "cloudlab":
            return cls(p99_over_p50=1.45, stall_prob=0.006,
                       bandwidth_GBps=1.2, seed=seed)  # 10 Gbps
        raise ValueError(name)

    def base_ms(self, nbytes: float, n: int = 1) -> np.ndarray:
        lat = self.rng.lognormal(self.mu, self.sigma, size=n)
        # congestion: effective bandwidth shares the same tail distribution
        bw_factor = self.rng.lognormal(0.0, self.sigma, size=n)
        t = lat + nbytes / (self.bandwidth_GBps * 1e9) * 1e3 * bw_factor
        return t * self._per_peer(n)

    def tcp_ms(self, nbytes: float, n: int = 1,
               factor: float = 1.0) -> np.ndarray:
        """Reliable-transport transfer times (stalls add an RTO)."""
        t = self.base_ms(nbytes, n)
        stalls = self.rng.random(n) < self.stall_prob
        return (t + stalls * self.rto_ms) * factor

    def ubt_ms(self, nbytes: float, n: int = 1,
               factor: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
        """Best-effort transfer: (completion time of delivered bytes,
        fraction lost). A stalled flow delivers (1 - drop_frac) on time."""
        t = self.base_ms(nbytes, n) * factor
        stalls = self.rng.random(n) < self.stall_prob
        lost = np.where(stalls,
                        self.rng.uniform(0.2, 1.8, n)
                        * self.drop_frac_per_stall, 0.0)
        return t, np.clip(lost, 0.0, 0.2)

    def ubt_ms_vec(self, nbytes: np.ndarray,
                   factor: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`ubt_ms` with *per-flow* byte counts — the weighted-shard
        schedule puts a different payload on each sender's link (a reduced-
        weight peer ships a smaller slice; a relayed dead-link flow ships
        its bytes twice).  Index i of ``nbytes`` is peer i's flow."""
        nb = np.asarray(nbytes, dtype=np.float64)
        n = nb.size
        lat = self.rng.lognormal(self.mu, self.sigma, size=n)
        bw_factor = self.rng.lognormal(0.0, self.sigma, size=n)
        t = lat + nb / (self.bandwidth_GBps * 1e9) * 1e3 * bw_factor
        t = t * self._per_peer(n) * factor
        stalls = self.rng.random(n) < self.stall_prob
        lost = np.where(stalls,
                        self.rng.uniform(0.2, 1.8, n)
                        * self.drop_frac_per_stall, 0.0)
        return t, np.clip(lost, 0.0, 0.2)


def fit_gilbert_elliott(masks) -> tuple[float | None, float | None]:
    """Fit Gilbert–Elliott (p, r) from packet-granular 0/1 arrival masks.

    ``masks``: iterable of arrays, each a per-stream arrival mask (1 =
    arrived); 2-D arrays are treated as one stream per row. Zero runs are
    measured *within* streams (a burst never spans two senders' streams).
    The estimators are the run-length moment matches: ``r`` = 1 / mean
    zero-run length (each bad run ends with one Bad->Good transition), and
    ``p`` from the stationary loss rate pi = p/(p+r). Returns (None, None)
    when no stream contains a loss (nothing to fit).
    """
    run_lengths: list[int] = []
    lost_total = 0
    pkt_total = 0
    for m in masks:
        arr = np.asarray(m, dtype=np.float64)
        rows = arr.reshape(1, -1) if arr.ndim == 1 else arr.reshape(
            arr.shape[0], -1)
        for row in rows:
            lost = row <= 0.0
            pkt_total += lost.size
            lost_total += int(np.sum(lost))
            # run-length encode the loss indicator
            padded = np.concatenate([[0], lost.astype(np.int8), [0]])
            edges = np.flatnonzero(np.diff(padded))
            starts, ends = edges[::2], edges[1::2]
            run_lengths.extend((ends - starts).tolist())
    if not run_lengths or pkt_total == 0:
        return None, None
    mean_burst = float(np.mean(run_lengths))
    rate = lost_total / pkt_total
    r = 1.0 / max(mean_burst, 1.0)
    p = min(1.0, r * rate / max(1.0 - rate, 1e-6))
    return p, r


@dataclasses.dataclass
class GAResult:
    time_ms: float
    drop_frac: float = 0.0
    rounds: int = 0
    # fraction of each peer's gradient data that made it into the aggregate
    # (index = peer id; weighted/rebalance path only, None elsewhere) — a
    # rebalanced straggler must show a NONZERO entry here, unlike ejection
    peer_contrib: tuple[float, ...] | None = None


class GASimulator:
    """Per-step gradient-aggregation time for each collective topology.

    ``pace=True`` puts the §3.2.3 Timely rate controller into the UBT flow
    path: each round's flows are paced at the controller's rate against a
    shared bottleneck of ``capacity_GBps`` (default the link rate), the
    resulting queueing delay feeds the controller's RTT signal, and the
    delay rides on the round's transfer times — sustained congestion drives
    the rate to the bottleneck's fair share instead of collapsing the tail.
    """

    def __init__(self, net: NetworkModel, n_nodes: int,
                 library_factor: float = 1.0, *, pace: bool = False,
                 capacity_GBps: float | None = None):
        self.net = net
        self.n = n_nodes
        self.f = library_factor
        self.pace = pace
        self.capacity_GBps = capacity_GBps
        self.pacer = TimelyRateControl(rate=net.bandwidth_GBps * 8e9,
                                       max_rate=net.bandwidth_GBps * 8e9)
        self.base_rtt_s = 20e-6          # propagation floor (below T_low)
        self._queue_s = 0.0              # bottleneck backlog (seconds)
        # virtual-clock cursor for trace export: advances by each simulated
        # round's duration (ms), so a whole simulated run lays out on one
        # continuous cat="sim" timeline with the same span schema as the
        # wire peers (DESIGN §12) — diffable against a wire trace in one
        # Perfetto window
        self._trace_t = 0.0

    def _trace_round(self, tr, dur_ms: float, *, rnd: int, timed_out: bool,
                     frac: float, deadline: float, stage: str) -> None:
        """One simulated round as a ``"round"`` span on the virtual clock
        (same name/args as the wire peers' spans)."""
        tr.complete("round", "sim", ts=self._trace_t, dur=dur_ms,
                    args={"round": rnd, "timed_out": timed_out,
                          "frac_received": frac, "deadline": deadline,
                          "stage": stage})
        if timed_out:
            tr.event("timeout", "sim", ts=self._trace_t + dur_ms,
                     args={"round": rnd, "frac_received": frac})
        self._trace_t += dur_ms

    def paced_round_delay_s(self, nbytes_flow: float, flows: int) -> float:
        """One Timely-paced round: update the bottleneck queue from the
        offered load (``flows`` concurrent senders at the pacer's rate vs
        the shared capacity), feed the controller the observed RTT, and
        return the queueing delay this round's transfers see (seconds)."""
        cap = (self.capacity_GBps or self.net.bandwidth_GBps) * 8e9
        rate = self.pacer.rate
        # this flow's serialization at its paced rate (the round duration)
        dur = nbytes_flow * 8.0 / max(min(rate, cap), 1.0)
        # backlog grows when the aggregate offered load exceeds capacity,
        # drains at the spare capacity otherwise
        self._queue_s = max(0.0,
                            self._queue_s + (flows * rate - cap) / cap * dur)
        delay = self._queue_s
        self.pacer.update(self.base_rtt_s + delay)
        return delay

    # ------------------------------------------------------------ baselines
    def ring(self, nbytes: float) -> GAResult:
        n = self.n
        chunk = nbytes / n
        rounds = 2 * (n - 1)
        t = sum(float(np.max(self.net.tcp_ms(chunk, n, self.f)))
                for _ in range(rounds))
        return GAResult(t, 0.0, rounds)

    def tree(self, nbytes: float) -> GAResult:
        n = self.n
        k = int(math.log2(n))
        t = 0.0
        for stage in range(k):
            t += float(np.max(self.net.tcp_ms(nbytes / 2 ** (stage + 1), n,
                                              self.f)))
        for stage in reversed(range(k)):
            t += float(np.max(self.net.tcp_ms(nbytes / 2 ** (stage + 1), n,
                                              self.f)))
        return GAResult(t, 0.0, 2 * k)

    def bcube(self, nbytes: float, base: int = 2) -> GAResult:
        """Gloo BCube: 2*log_b(N) stages exchanging B/b per stage (total
        wire bytes ~ 2B*log_b(N)/b > ring's 2B — why the paper finds it
        the slowest baseline)."""
        n = self.n
        k = max(1, round(math.log(n, base)))
        t = 0.0
        for _ in range(2 * k):
            t += float(np.max(self.net.tcp_ms(
                (nbytes / base) * (base - 1), n, self.f)))
        return GAResult(t, 0.0, 2 * k)

    def ps(self, nbytes: float) -> GAResult:
        n = self.n
        # all workers push B; the server link serializes N*B (incast)
        serialization = (n * nbytes) / (self.net.bandwidth_GBps * 1e9) * 1e3
        t = float(np.max(self.net.tcp_ms(nbytes, n, self.f))) + serialization
        t += float(np.max(self.net.tcp_ms(nbytes, n, self.f))) + serialization
        return GAResult(t, 0.0, 2)

    def tar_tcp(self, nbytes: float, incast: int = 1) -> GAResult:
        n = self.n
        chunk = nbytes / n
        i = max(incast, 1)
        rounds = 2 * math.ceil((n - 1) / i)
        t = 0.0
        for _ in range(rounds):
            t += float(np.max(self.net.tcp_ms(chunk * i, n, self.f)))
        return GAResult(t, 0.0, rounds)

    # ----------------------------------------------------------- optireduce
    def warmup(self, nbytes: float, *, iters: int = 20,
               control: ControlPlane | None = None,
               detect_stragglers: bool = True, **kw) -> ControlPlane:
        """§3.2.1 profiling: TAR+TCP stage times feed t_B = their P95.

        Returns the job's :class:`ControlPlane` (built here unless passed
        in) — the single owner of the timeout/incast/detector state the
        subsequent :meth:`optireduce` steps consume and update.
        """
        if control is None:
            control = ControlPlane.create(
                n_nodes=self.n, detect_stragglers=detect_stragglers,
                timeout={"warmup_iters": iters}, **kw)
        chunk = nbytes / self.n
        for _ in range(iters):
            control.state.timeout.observe_warmup(
                float(np.max(self.net.tcp_ms(chunk, self.n, self.f))))
        return control

    def optireduce_2d(self, nbytes: float, control: ControlPlane,
                      groups: int) -> GAResult:
        """Hierarchical 2D TAR (paper §3.1.2 / App. A): groups of N/G nodes.
        Rounds: (N/G - 1) intra-group exchange + (G - 1) inter-group
        same-rank aggregation + (N/G - 1) intra-group broadcast =
        2(N/G - 1) + (G - 1), vs flat TAR's 2(N - 1)."""
        timeout = control.state.timeout
        n = self.n
        nl = max(1, n // max(groups, 1))
        total_t, lost_bytes, total_bytes = 0.0, 0.0, 0.0
        stage_times, to_flags, frac_recv = [], [], []
        tr = obs_trace.get_tracer()

        def rounds(count, chunk, fanin):
            nonlocal total_t, lost_bytes, total_bytes
            for _ in range(count):
                times, lost = self.net.ubt_ms(chunk, fanin, self.f)
                t99 = float(np.max(times)) * 0.99
                deadline = min(timeout.round_deadline(False),
                               t99 + timeout.x * (timeout.t_c or t99))
                if control.state.budget is not None:
                    # accept-or-extend (DESIGN §8): stretch while the loss
                    # EMA overruns the phase-tightening budget — beyond t_B
                    # if that is what the data needs (max_stretch bounds
                    # the round at max_stretch x the t_B-capped deadline,
                    # matching the wire peers' uncapped stretch)
                    deadline = control.state.budget.stretch(deadline)
                arrived = np.where(times <= deadline, 1.0 - lost,
                                   np.minimum(1.0 - lost, deadline / times))
                total_t += float(min(np.max(times), deadline))
                lost_bytes += float(np.sum(1 - arrived)) * chunk
                total_bytes += fanin * chunk
                stage_times.append(float(min(np.max(times), deadline)))
                to_flags.append(bool(np.any(times > deadline)))
                frac_recv.append(float(np.mean(arrived)))
                if tr is not None:
                    self._trace_round(tr, stage_times[-1],
                                      rnd=len(stage_times) - 1,
                                      timed_out=to_flags[-1],
                                      frac=frac_recv[-1],
                                      deadline=float(deadline), stage="2d")

        rounds(nl - 1, nbytes / nl, nl)              # intra-group exchange
        rounds(max(groups - 1, 0), nbytes / n, groups)  # inter-group
        rounds(nl - 1, nbytes / nl, nl)              # intra-group broadcast
        drop_frac = lost_bytes / max(total_bytes, 1.0)
        control.observe(StepTelemetry(
            step=control.steps, loss_frac=drop_frac,
            timed_out=any(to_flags), round_times=tuple(stage_times),
            round_timed_out=tuple(to_flags),
            round_frac_received=tuple(frac_recv)))
        return GAResult(total_t, drop_frac, len(stage_times))

    def _optireduce_weighted(self, nbytes: float, control: ControlPlane, *,
                             fixed_incast: int | None = None) -> GAResult:
        """Weighted / link-rewired UBT aggregation (DESIGN §10).

        The round schedule is the same 2*ceil((A-1)/I) groups, but each
        flow's bytes follow the policy's shard weights: in a stage-1 round,
        position k sends its contribution to the *receiver's* shard
        (``sizes[(k+r) % A]`` bytes); in stage 2 it broadcasts its own
        (``sizes[k]``).  A flow crossing a dead directed edge rides the
        two-hop relay, so its bytes double.  The deadline is keyed on the
        FULL-WEIGHT cohort's last-percentile marker plus a small fixed
        slack — NOT on x%*t_C: a reduced-weight straggler exceeding the
        deadline is *scheduled shedding*, and charging it to the §3.2.1
        rule would double x until the timeout collapses the incast.  For
        the same reason the telemetry (loss fraction, timeout flags,
        received fractions) is keyed on the full-weight cohort only, while
        the returned ``drop_frac``/``peer_contrib`` account every byte.
        """
        n = self.n
        policy = control.policy()
        timeout = control.state.timeout
        active = list(policy.active_peers) if policy.active_peers is not None \
            else list(range(n))
        a = len(active)
        w = list(policy.shard_weights) if policy.shard_weights is not None \
            else [1] * a
        dead = set(policy.dead_links)
        i = max(fixed_incast if fixed_incast is not None else policy.incast, 1)
        unit = nbytes / max(sum(w), 1)
        sizes = [wk * unit for wk in w]
        w_max = max(w)
        full = [k for k in range(a) if w[k] == w_max]
        half_rounds = math.ceil(max(a - 1, 1) / i)
        x_reb = 0.05            # fixed slack over the full cohort's marker
        total_t = 0.0
        lost_bytes = total_bytes = 0.0          # every scheduled byte
        full_lost = full_total = 0.0            # full-weight cohort only
        contrib = np.array(sizes, dtype=np.float64)   # own shard: always in
        peer_times = np.zeros(n)
        stage_times, to_flags, frac_recv = [], [], []
        tr = obs_trace.get_tracer()
        for stage in range(2):
            for g in range(half_rounds):
                group = range(g * i + 1, min((g + 1) * i, a - 1) + 1)
                wire = np.zeros(a)      # bytes on each position's link
                data = np.zeros(a)      # gradient bytes each position ships
                for r in group:
                    for k in range(a):
                        dst = (k + r) % a
                        b = sizes[dst] if stage == 0 else sizes[k]
                        data[k] += b
                        wire[k] += 2.0 * b if (active[k], active[dst]) in dead \
                            else b
                nb = np.zeros(n)
                nb[active] = wire
                times, lost = self.net.ubt_ms_vec(nb, self.f)
                if self.pace:
                    times = times + self.paced_round_delay_s(
                        float(np.mean(wire)), a) * 1e3
                peer_times += times
                act_times = times[active]
                act_lost = lost[active]
                t99_full = float(np.max(act_times[full])) * 0.99
                deadline = min(timeout.round_deadline(last_pctile_seen=False),
                               t99_full * (1.0 + x_reb))
                if control.state.budget is not None:
                    deadline = control.state.budget.stretch(deadline)
                arrived = np.where(
                    act_times <= deadline, 1.0 - act_lost,
                    np.minimum(1.0 - act_lost,
                               deadline / np.maximum(act_times, 1e-9)))
                total_t += float(min(np.max(act_times[full]), deadline))
                lost_bytes += float(np.sum((1.0 - arrived) * data))
                total_bytes += float(np.sum(data))
                full_lost += float(np.sum((1.0 - arrived[full])
                                          * data[full]))
                full_total += float(np.sum(data[full]))
                if stage == 0:
                    contrib += arrived * data
                stage_times.append(float(min(np.max(act_times[full]),
                                             deadline)))
                to_flags.append(bool(np.any(act_times[full] > deadline)))
                frac_recv.append(float(np.mean(arrived[full])))
                if tr is not None:
                    self._trace_round(tr, stage_times[-1],
                                      rnd=len(stage_times) - 1,
                                      timed_out=to_flags[-1],
                                      frac=frac_recv[-1],
                                      deadline=float(deadline),
                                      stage="weighted")
        by_peer = np.zeros(n)
        by_peer[active] = contrib / max(nbytes, 1e-12)
        control.observe(StepTelemetry(
            step=control.steps,
            loss_frac=full_lost / max(full_total, 1e-12),
            timed_out=any(to_flags), peer_stage_times=tuple(peer_times),
            round_times=tuple(stage_times), round_timed_out=tuple(to_flags),
            round_frac_received=tuple(frac_recv)))
        return GAResult(total_t, lost_bytes / max(total_bytes, 1e-12),
                        len(stage_times),
                        peer_contrib=tuple(float(c) for c in by_peer))

    def optireduce(self, nbytes: float, control: ControlPlane, *,
                   fixed_incast: int | None = None) -> GAResult:
        """One UBT gradient aggregation under the control plane's policy:
        the round schedule runs over the policy's *active-peer set* (an
        ejected straggler is neither sent to nor waited on — its share of
        the gradient is excluded, not late), the deadline rule uses the
        policy's x%, and the step's telemetry (per-peer times for the
        detector, per-round stage times for the timeout) feeds back in.
        A policy carrying shard weights or dead links routes to the
        weighted schedule (:meth:`_optireduce_weighted`); the uniform path
        below is byte-for-byte the seed behavior."""
        n = self.n
        policy = control.policy()
        if policy.shard_weights is not None or policy.dead_links:
            return self._optireduce_weighted(nbytes, control,
                                             fixed_incast=fixed_incast)
        timeout = control.state.timeout
        active = list(policy.active_peers) if policy.active_peers is not None \
            else list(range(n))
        a = len(active)
        i = fixed_incast if fixed_incast is not None else policy.incast
        chunk = nbytes / max(a, 1)
        rounds = 2 * math.ceil(max(a - 1, 1) / max(i, 1))
        total_t = 0.0
        lost_bytes = 0.0
        peer_times = np.zeros(n)
        stage_times, to_flags, frac_recv = [], [], []
        tr = obs_trace.get_tracer()
        for _ in range(rounds):
            times, lost = self.net.ubt_ms(chunk * max(i, 1), n, self.f)
            if self.pace:
                times = times + self.paced_round_delay_s(
                    chunk * max(i, 1), a) * 1e3
            # every peer's (hypothetical) completion is still observed —
            # the detector needs the straggler's pace to keep scoring it
            peer_times += times
            act_times = times[active]
            act_lost = lost[active]
            # early timeout (Fig 8): once every sender's last-percentile
            # markers are in (~99% of each stream delivered), wait x%*t_C
            # and expire — shaving stall-recovery waits, not live streams;
            # the hard bound t_B caps pathological rounds. Drops stay at
            # the 0.01-0.1% the controller targets.
            t99_all = float(np.max(act_times)) * 0.99
            deadline = min(timeout.round_deadline(last_pctile_seen=False),
                           t99_all + timeout.x * (timeout.t_c or t99_all))
            if control.state.budget is not None:
                # accept-or-extend (DESIGN §8): while the observed loss EMA
                # overruns the tightening budget, wait longer for late
                # packets instead of charging them as drops — beyond t_B if
                # that is what the data needs (max_stretch bounds the round
                # at max_stretch x the t_B-capped deadline, matching the
                # wire peers' uncapped stretch)
                deadline = control.state.budget.stretch(deadline)
            arrived_frac = np.where(act_times <= deadline, 1.0 - act_lost,
                                    np.minimum(1.0 - act_lost,
                                               deadline / act_times))
            t_round = float(min(np.max(act_times), deadline))
            total_t += t_round
            lost_bytes += float(np.sum(1.0 - arrived_frac)) * chunk
            stage_times.append(t_round)
            to_flags.append(bool(np.any(act_times > deadline)))
            frac_recv.append(float(np.mean(arrived_frac)))
            if tr is not None:
                self._trace_round(tr, t_round, rnd=len(stage_times) - 1,
                                  timed_out=to_flags[-1], frac=frac_recv[-1],
                                  deadline=float(deadline), stage="uniform")
        drop_frac = lost_bytes / (rounds * a * chunk)
        control.observe(StepTelemetry(
            step=control.steps, loss_frac=drop_frac, timed_out=any(to_flags),
            peer_stage_times=tuple(peer_times),
            round_times=tuple(stage_times), round_timed_out=tuple(to_flags),
            round_frac_received=tuple(frac_recv)))
        return GAResult(total_t, drop_frac, rounds)

    def step(self, strategy: str, nbytes: float, **kw) -> GAResult:
        fn = {"gloo_ring": self.ring, "ring": self.ring,
              "nccl_tree": self.tree, "tree": self.tree,
              "nccl_ring": self.ring,
              "bcube": self.bcube, "ps": self.ps,
              "tar_tcp": self.tar_tcp}[strategy]
        return fn(nbytes, **kw)


# Names this module times natively (the paper's comparison set).
_NATIVE_TIMING = ("optireduce", "tar_tcp", "gloo_ring", "ring", "nccl_ring",
                  "nccl_tree", "tree", "bcube", "ps")


# The family the reference's registry gives a strategy the port registers
# only in a later slice: optireduce_2d is TAR x Lossy over a second (pod)
# axis, ROADMAP A15.
_PENDING_FAMILY = {"optireduce_2d": "optireduce"}


def timing_family(strategy: str) -> str:
    """Map a strategy name to this simulator's timing family.

    Names outside the native table are resolved through the collective-
    pipeline spec registry and classified by their (topology, transport)
    composition — a ``register_strategy``'d one-liner simulates without
    editing this module: ring-kind topologies time as their baseline, a
    lossy transport over TAR times as UBT/OptiReduce, a reliable one as
    TAR+TCP.  (Codecs shift wire *bytes*, not the round structure; callers
    scale ``nbytes`` for that.)
    """
    if strategy in _NATIVE_TIMING:
        return strategy
    try:                                 # lazy: keeps numpy-only imports fast
        from repro_torch.core import pipeline as pl
        spec = pl.resolve_spec(pl.OptiReduceConfig(strategy=strategy))
    except NotImplementedError:          # a name of pipeline._NOT_PORTED
        return _PENDING_FAMILY.get(strategy, strategy)
    except Exception:
        return strategy                  # unknown: let the caller's table err
    topo = spec.topology
    if isinstance(topo, pl.RingTopology):
        return {"ring": "gloo_ring", "tree": "nccl_tree",
                "bcube": "bcube"}[topo.kind]
    if isinstance(topo, pl.PsumTopology):
        return "nccl_ring"               # XLA-native ~ NCCL ring transport
    return "optireduce" if isinstance(spec.transport, pl.Lossy) else "tar_tcp"


# Library speed factors: Gloo's kernel TCP stack = 1.0; NCCL's GPU-direct
# transport ~0.62 (calibrated from Table 1: (118-60)/(154-60));
# OptiReduce's UBT is a DPDK kernel-bypass userspace transport with NIC
# flow steering (§4) — same efficiency class as NCCL's bypass path.
LIBRARY_FACTOR = {
    "gloo_ring": 1.0, "bcube": 1.0, "tar_tcp": 1.0, "ps": 1.0,
    "nccl_ring": 0.62, "nccl_tree": 0.62,
    "optireduce": 0.62,
}


def simulate_job(strategy: str, *, n_nodes: int, bucket_bytes: float,
                 n_steps: int, env: NetworkModel,
                 compute_ms: float = 50.0, overlap: float = 0.5,
                 incast_dynamic: bool = False, incast: int = 1,
                 eject_stragglers: bool = False, rebalance: bool = False,
                 pace: bool = False,
                 control: ControlPlane | None = None) -> dict:
    """Wall-clock of a training job: per step, compute plus the exposed
    (non-overlapped) fraction of GA time (Fig 1 communication hiding).

    ``eject_stragglers`` arms the control plane's straggler detector (the
    degraded-participation loop); ``rebalance`` arms straggler-proportional
    shard weights instead (a slow peer keeps a smaller slice — combine
    with ``eject_stragglers=False`` to never eject); ``pace`` puts the
    Timely controller into the UBT flow path.  Pass ``control`` to
    share/inspect the controller state (e.g. the detector's ejection
    history) after the run.
    """
    strategy = timing_family(strategy)
    sim = GASimulator(env, n_nodes, LIBRARY_FACTOR.get(strategy, 1.0),
                      pace=pace)
    if strategy == "optireduce":
        control = sim.warmup(bucket_bytes, control=control,
                             detect_stragglers=eject_stragglers,
                             rebalance=rebalance,
                             incast={"i_init": incast})
    total = 0.0
    drops, ga_times = [], []
    contribs = []
    for _ in range(n_steps):
        if strategy == "optireduce":
            r = sim.optireduce(bucket_bytes, control,
                               fixed_incast=None if incast_dynamic
                               else incast)
        elif strategy == "tar_tcp":
            r = sim.step(strategy, bucket_bytes, incast=incast)
        else:
            r = sim.step(strategy, bucket_bytes)
        total += compute_ms + max(0.0, r.time_ms * (1 - overlap))
        drops.append(r.drop_frac)
        ga_times.append(r.time_ms)
        if r.peer_contrib is not None:
            contribs.append(r.peer_contrib)
    out = {"total_ms": total, "mean_ga_ms": float(np.mean(ga_times)),
           "p50_ga_ms": float(np.percentile(ga_times, 50)),
           "p99_ga_ms": float(np.percentile(ga_times, 99)),
           "mean_drop": float(np.mean(drops)), "drops": drops}
    if strategy == "optireduce" and control is not None:
        active = control.policy().active_peers
        out["active_peers"] = list(active if active is not None
                                   else range(n_nodes))
        out["ejected_peers"] = list(control.detector.ejected_peers())
        if rebalance:
            out["shard_weights"] = list(control.detector.weights())
        if contribs:
            out["mean_contrib"] = [float(c) for c in
                                   np.mean(np.asarray(contribs), axis=0)]
    return out
