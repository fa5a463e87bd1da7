"""The port's network simulator (``repro_torch/sim/netsim.py``) against the
JAX package's ``repro.sim.netsim`` on the same seeds.

Both sides draw from numpy's ``default_rng`` and run the same controllers,
so every comparison is bitwise: ``simulate_job``'s whole result dict for
every strategy name of the reference's registry and every natively timed
name, in the paper's three environments; the control plane's options
(dynamic incast, straggler ejection under ``peer_factors``, rebalanced
shards, Timely pacing); a model calibrated ``from_drop_trace`` with and
without wire masks; the weighted schedule under a dead link; and
``GASimulator.optireduce_2d``. ``timing_family`` must give the reference's
answer on every name, ``optireduce_2d`` included (the port registers it
only with the pod axis, ROADMAP A15).
"""
import jax.experimental.pallas.tpu as pltpu
if not hasattr(pltpu, "TPUCompilerParams"):      # renamed in newer jax
    pltpu.TPUCompilerParams = pltpu.CompilerParams

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.core.pipeline import strategy_names as ref_names  # noqa: E402
from repro.sim import netsim as jsim  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.sim import netsim  # noqa: E402

ENVS = ("local_1.5", "local_3.0", "cloudlab")
NAMES = tuple(dict.fromkeys(ref_names() + jsim._NATIVE_TIMING))
KW = dict(n_nodes=8, bucket_bytes=25 * 2 ** 20, n_steps=4)


def _both(strategy, env, seed, *, peer_factors=None, **kw):
    out = []
    for mod in (jsim, netsim):
        model = mod.NetworkModel.environment(env, seed=seed)
        model.peer_factors = peer_factors
        out.append(mod.simulate_job(strategy, env=model, **{**KW, **kw}))
    return out


def test_every_name_is_timed():
    assert set(ref_names()) <= set(NAMES) and "ps" in NAMES
    assert sim.simulate_job is netsim.simulate_job
    assert sim.timing_family is netsim.timing_family


@pytest.mark.parametrize("name", NAMES)
def test_timing_family_matches_reference(name):
    assert netsim.timing_family(name) == jsim.timing_family(name)


@pytest.mark.parametrize("env", ENVS)
def test_simulate_job_matches_reference(env):
    for k, name in enumerate(NAMES):
        want, got = _both(name, env, seed=k)
        assert got == want, name
        assert np.isfinite(got["total_ms"])


@pytest.mark.parametrize("option", ["incast_dynamic", "eject", "rebalance",
                                    "pace", "incast_3"])
def test_control_options_match_reference(option):
    slow = (1.0,) * 7 + (5.0,)
    kw = {"incast_dynamic": dict(incast_dynamic=True),
          "eject": dict(eject_stragglers=True, peer_factors=slow,
                        n_steps=24),
          "rebalance": dict(rebalance=True, peer_factors=(1.0,) * 7 + (1.8,),
                            n_steps=12),
          "pace": dict(pace=True),
          "incast_3": dict(incast=3)}[option]
    for name in ("tar_tcp", "optireduce"):
        want, got = _both(name, "local_3.0", seed=5, **kw)
        assert got == want, name
    if option == "eject":
        assert got["ejected_peers"] == [7]
    if option == "rebalance":
        assert got["shard_weights"][7] < got["shard_weights"][0]


def test_calibration_from_drop_trace_matches_reference():
    rng = np.random.default_rng(2)
    trace = np.where(rng.random(200) < 0.1, rng.uniform(0.0, 0.05, 200), 0.0)
    masks = [(rng.random((4, 256)) > 0.03).astype(np.float32)
             for _ in range(3)]
    for kw in ({}, {"masks": masks}):
        want = jsim.NetworkModel.from_drop_trace(trace, seed=3, **kw)
        got = netsim.NetworkModel.from_drop_trace(trace, seed=3, **kw)
        for field in ("stall_prob", "drop_frac_per_stall", "burst_p",
                      "burst_r", "sigma", "mu"):
            assert getattr(got, field) == getattr(want, field), field
        if "masks" in kw:
            assert got.burst_p is not None
            np.testing.assert_array_equal(got.burst_loss_seq(4096),
                                          want.burst_loss_seq(4096))
        r = [mod.simulate_job("optireduce", env=m, **KW)
             for mod, m in ((jsim, want), (netsim, got))]
        assert r[1] == r[0]
    assert netsim.fit_gilbert_elliott(masks) == \
        jsim.fit_gilbert_elliott(masks)
    assert netsim.fit_gilbert_elliott([np.ones(64)]) == (None, None)
    with pytest.raises(ValueError):
        netsim.NetworkModel.from_drop_trace([0.5, 1.5])


def _rows(results):
    return [dataclasses.astuple(r) for r in results]


def _sims(env="local_3.0", seed=9):
    return [(mod, ctl, mod.GASimulator(
        mod.NetworkModel.environment(env, seed=seed), 8,
        mod.LIBRARY_FACTOR["optireduce"]))
        for mod, ctl in ((jsim, jrt), (netsim, rt))]


def test_weighted_schedule_with_a_dead_link_matches_reference():
    results = []
    for mod, ctl, gs in _sims():
        control = gs.warmup(25 * 2 ** 20, rebalance=True)
        for step in range(2):        # two fully lossy sightings kill it
            control.observe(ctl.StepTelemetry(
                step=step, dead_link_events=((2, 5),)))
        assert control.policy().dead_links == ((2, 5),)
        results.append(_rows(gs.optireduce(25 * 2 ** 20, control)
                             for _ in range(4)))
    assert results[1] == results[0]
    assert results[1][0][3] is not None       # peer_contrib


@pytest.mark.parametrize("groups", [2, 4])
def test_optireduce_2d_matches_reference(groups):
    results = []
    for mod, ctl, gs in _sims(env="cloudlab", seed=groups):
        control = gs.warmup(25 * 2 ** 20)
        results.append(_rows(gs.optireduce_2d(25 * 2 ** 20, control, groups)
                             for _ in range(4)))
    assert results[1] == results[0]
    assert results[1][0][2] == 2 * (8 // groups - 1) + groups - 1


def test_baselines_step_by_step_match_reference():
    results = []
    for mod, _, gs in _sims(env="local_1.5", seed=4):
        results.append(_rows(
            [gs.step(s, 1e7) for s in
             ("gloo_ring", "nccl_tree", "bcube", "ps", "tar_tcp")]
            + [gs.bcube(1e7, base=4), gs.tar_tcp(1e7, incast=3)]))
    assert results[1] == results[0]
