"""The port's §3.2 controllers and control plane (``repro_torch/core/ubt.py``,
``repro_torch/runtime/``) against the JAX package's, on the same seeded
sequences of ``StepTelemetry``.

Both sides are plain Python and numpy, so every comparison is bitwise:
after each step the ``SyncPolicy`` field by field (``timeout_x`` and
``generation`` included, which policy equality leaves out), its
``compile_key``, whether ``observe`` said the policy moved, and the state
of every controller (``AdaptiveTimeout``, ``DynamicIncast``,
``TimelyRateControl``, ``LossBudget``, the straggler detector and the link
tracker).
"""
import dataclasses

import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.core import ubt as jubt  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import ubt  # noqa: E402

N = 8


def _loss_band(rng, steps):
    """Loss below, inside and above the codec's [0.01, 0.02) band, and
    round detail once the timeout is profiled (20 warm-up steps)."""
    out = []
    for k in range(steps):
        t = dict(loss_frac=float(rng.choice(
            [0.0, 0.00005, 0.0005, 0.005, 0.01, 0.012, 0.019, 0.02, 0.025,
             0.05])),
                 step_time=float(rng.lognormal(0.0, 0.3)))
        if k >= 20:
            r = 2 * (N - 1)
            t.update(round_times=tuple(float(x) for x in
                                       rng.lognormal(-2.0, 0.4, r)),
                     round_frac_received=tuple(
                         float(x) for x in np.where(rng.random(r) < 0.8,
                                                    1.0, rng.random(r))))
        out.append(t)
    return out


def _timeouts(rng, steps):
    out = []
    for k in range(steps):
        r = 2 * (N - 1)
        to = tuple(bool(x) for x in rng.random(r) < 0.15)
        out.append(dict(loss_frac=float(rng.choice([0.0, 0.002, 0.03])),
                        timed_out=any(to), step_time=float(rng.random()),
                        round_times=tuple(float(x) for x in rng.random(r)),
                        round_timed_out=to if k % 3 else None,
                        round_frac_received=tuple(
                            float(x) for x in rng.uniform(0.5, 1.0, r))))
    return out


def _straggler(rng, steps):
    """Peer 5 slow for 12 steps, then healed: ejection, probation, readmit
    (and a second peer unobserved on some steps)."""
    out = []
    for k in range(steps):
        times = [float(x) for x in rng.lognormal(0.0, 0.05, N)]
        if k < 12:
            times[5] *= 6.0
        if k % 7 == 3:
            times[2] = float("nan")
        out.append(dict(loss_frac=0.0, peer_stage_times=tuple(times)))
    return out


def _rebalance(rng, steps):
    out = []
    for k in range(steps):
        times = [float(x) for x in rng.lognormal(0.0, 0.05, N)]
        times[1] *= 1.6 if k < 25 else 1.0
        times[6] *= 2.2
        out.append(dict(loss_frac=float(rng.choice([0.0, 0.003])),
                        peer_stage_times=tuple(times)))
    return out


def _dead_links(rng, steps):
    out = []
    for k in range(steps):
        ev = [(1, 2)] if k < 6 else []
        if k in (2, 3, 9):
            ev.append((4, 0))
        out.append(dict(loss_frac=float(rng.choice([0.0, 0.01])),
                        dead_link_events=tuple(ev)))
    return out


CASES = {
    "loss_band": (_loss_band, 40, {}),
    "timeouts": (_timeouts, 30, {"timeout": {"warmup_iters": 5}}),
    "straggler": (_straggler, 40,
                  {"detector_kw": dict(alpha=0.5, patience=2, cooldown=3,
                                       probation=2)}),
    "rebalance": (_rebalance, 40,
                  {"rebalance": True, "detect_stragglers": False}),
    "dead_links": (_dead_links, 24, {"link_patience": 2, "link_recover": 5}),
    "budget": (_loss_band, 30, {"budget": {"plateau_patience": 4}}),
}


def _state(cp):
    """Every controller's state, as plain values."""
    st = cp.state
    at, inc, rate = st.timeout, st.incast, st.rate
    out = {"timeout": (at.t_b, at.t_c, at.x, tuple(at._warmup)),
           "incast": inc.value, "rate": rate.rate,
           "hadamard": cp.use_hadamard, "steps": cp.steps,
           "peers": tuple(dataclasses.astuple(p) for p in cp.detector.peers),
           "units": tuple(cp.detector._weight_units),
           "links": (dict(cp._link_strikes), dict(cp._link_quiet),
                     cp.dead_links())}
    if st.budget is not None:
        b = st.budget
        out["budget"] = (b.phase, b.loss_ema, b._best_loss, b._stalls,
                         b.budget(), b.deadline_factor())
    return out


def _policy(p):
    return {**{f.name: getattr(p, f.name)
               for f in dataclasses.fields(p)},
            "compile_key": p.compile_key}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_plane_matches_reference(case):
    make, steps, kw = CASES[case]
    seq = make(np.random.default_rng(sorted(CASES).index(case)), steps)
    ref = jrt.ControlPlane.create(n_nodes=N, **kw)
    port = rt.ControlPlane.create(n_nodes=N, **kw)
    assert _state(port) == _state(ref)
    moved = 0
    for k, fields in enumerate(seq):
        if "budget" in kw:
            for cp in (ref, port):
                cp.state.budget.update_phase(progress=k / steps,
                                             train_loss=5.0 - 0.01 * k)
        a = ref.observe(jrt.StepTelemetry(step=k, **fields))
        b = port.observe(rt.StepTelemetry(step=k, **fields))
        assert a == b, k
        moved += a
        assert _policy(port.policy()) == _policy(ref.policy()), k
        assert _state(port) == _state(ref), k
    assert moved > 0             # every case moves the policy at least once


def test_eject_readmit_cycle_hits_the_policy_cache():
    """An eject -> probation -> readmit cycle returns to a cached policy:
    hits and misses as the reference counts them."""
    make, steps, kw = CASES["straggler"]
    seq = make(np.random.default_rng(7), steps)
    sides = [(jrt, jrt.ControlPlane.create(n_nodes=N, **kw),
              jrt.PolicyStepCache(maxsize=2)),
             (rt, rt.ControlPlane.create(n_nodes=N, **kw),
              rt.PolicyStepCache(maxsize=2))]
    for k, fields in enumerate(seq):
        for mod, cp, cache in sides:
            cp.observe(mod.StepTelemetry(step=k, **fields))
            if cache.get(cp.policy()) is None:
                cache.put(cp.policy(), k)
    (_, cp_r, ref), (_, cp_p, port) = sides
    assert (port.hits, port.misses, len(port)) == \
        (ref.hits, ref.misses, len(ref))
    assert port.misses >= 2 and port.hits >= 1
    assert cp_p.detector.peers[5].ejections == \
        cp_r.detector.peers[5].ejections >= 1
    assert cp_p.policy().active_peers is None      # readmitted


def test_controllers_alone_match_reference():
    """``AdaptiveTimeout``, ``DynamicIncast``, ``TimelyRateControl`` and
    ``LossBudget`` stepped directly, outside a control plane."""
    rng = np.random.default_rng(3)
    pairs = [(jubt.AdaptiveTimeout(warmup_iters=6),
              ubt.AdaptiveTimeout(warmup_iters=6)),
             (jubt.DynamicIncast(n_nodes=N, i_init=3),
              ubt.DynamicIncast(n_nodes=N, i_init=3)),
             (jubt.TimelyRateControl(), ubt.TimelyRateControl()),
             (jubt.LossBudget(), ubt.LossBudget())]
    for k in range(30):
        loss = float(rng.choice([0.0, 0.0005, 0.002, 0.03]))
        rtt = float(rng.choice([1e-5, 1e-4, 5e-4, 2e-3]))
        (jat, pat), (jinc, pinc), (jrc, prc), (jlb, plb) = pairs
        if not jat.ready:
            t = float(rng.lognormal())
            jat.observe_warmup(t)
            pat.observe_warmup(t)
        else:
            r = 4
            kw = dict(stage_times=list(rng.random(r)),
                      timed_out=list(rng.random(r) < 0.2),
                      frac_received=list(rng.uniform(0.3, 1.0, r)),
                      loss_frac=loss)
            jat.update(**kw)
            pat.update(**kw)
            assert jat.round_deadline(k % 2 == 0) == \
                pat.round_deadline(k % 2 == 0)
        assert (pat.t_b, pat.t_c, pat.x) == (jat.t_b, jat.t_c, jat.x)
        assert pat.hadamard_active(loss) == jat.hadamard_active(loss)
        assert pinc.update(loss_frac=loss, timed_out=k % 5 == 0) == \
            jinc.update(loss_frac=loss, timed_out=k % 5 == 0)
        assert prc.update(rtt) == jrc.update(rtt)
        jlb.observe(loss)
        plb.observe(loss)
        assert plb.update_phase(progress=k / 40) == \
            jlb.update_phase(progress=k / 40)
        assert (plb.budget(), plb.loss_ema, plb.deadline_factor(),
                plb.stretch(2.0, hard=3.0)) == \
            (jlb.budget(), jlb.loss_ema, jlb.deadline_factor(),
             jlb.stretch(2.0, hard=3.0))


def test_adaptive_transport_matches_reference():
    """The transport adapter over the control plane: the same incast and
    codec recommendations, and the same config after ``apply``."""
    ref = jpl.AdaptiveTransport.create(n_nodes=N)
    port = pl.AdaptiveTransport.create(n_nodes=N)
    assert isinstance(port, pl.Lossy)
    for loss in (0.0, 0.0, 0.0, 0.0, 0.05, 0.05, 0.015, 0.005, 0.0):
        assert port.observe(loss, stage_time=0.1) == \
            ref.observe(loss, stage_time=0.1)
        assert (port.incast(), port.use_hadamard) == \
            (ref.incast(), ref.use_hadamard)
    cfg = port.apply(pl.OptiReduceConfig(strategy="optireduce_rounds"))
    jcfg = ref.apply(jpl.OptiReduceConfig(strategy="optireduce_rounds"))
    assert (cfg.use_hadamard, cfg.incast, cfg.active_peers) == \
        (jcfg.use_hadamard, jcfg.incast, jcfg.active_peers)
    with pytest.raises(ValueError):
        pl.AdaptiveTransport()
    wrapped = pl.AdaptiveTransport(state=ubt.UbtState.create(n_nodes=4),
                                   use_hadamard=True)
    assert wrapped.use_hadamard and wrapped.state.incast.n_nodes == 4


def test_codec_flip_matters_by_spec_identity_as_in_reference():
    """The launcher's identity test: every factory-registered name answers
    that a codec flip rebuilds the step, as the reference's does."""
    for name in pl.strategy_names():
        answers = []
        for mod in (jpl, pl):
            on = mod.resolve_spec(mod.OptiReduceConfig(strategy=name,
                                                       use_hadamard=True))
            off = mod.resolve_spec(mod.OptiReduceConfig(strategy=name,
                                                        use_hadamard=False))
            answers.append(on is not off)
        assert answers[0] == answers[1], name
