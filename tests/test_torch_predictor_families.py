"""The port's ewma, holt_winters, hierarchy and seasonal_naive families
and the periodic helpers against the JAX package's.

Five 512-step traces (three bursty ones from ``generate_trace``, a uniform
one and a clipped normal one) and the fifteen scenario traces ride as the
cells of one ``[K]`` port state; each is run through the JAX package's
compiled ``evaluate_trace`` on its own.  Predicted and observed bins and
both miss counters must be equal at every step.  The float32 state may
differ by a few ulps: inside its compiled scan XLA contracts each
``x + c·y`` of these updates into one fused multiply-add, where torch
rounds the product and the sum apart (ROADMAP C); the states are held
within 1e-6.  ``detect_period``, both ``config_for_trace`` and the
registry must agree exactly.  A constructed periodic trace whose dips lie
below one bin drives seasonal_naive's exact-phase forecast to −1: the
shared shell clips it to bin 0 in both packages, and the fleet loops
reach no table with a negative index.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core import predictors as jpred
from repro.core import scenarios as jscn
from repro.core import workload as jwl
from repro.core.accelerators import ACCELERATORS as JACC
from repro.core.predictors import hierarchy as jhier
from repro.core.predictors import seasonal as jseas
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import predictors as tpred
from repro_torch.core import scenarios as tscn
from repro_torch.core.accelerators import ACCELERATORS as TACC
from repro_torch.core.predictors import hierarchy as thier
from repro_torch.core.predictors import seasonal as tseas

N_STEPS = 512
STATE_ATOL = 1e-6
CPU = torch.device("cpu")

CONFIGS = {
    "ewma": dict(kind="ewma"),
    "ewma_fast": dict(kind="ewma", ewma_alpha=0.8),
    "holt_winters": dict(kind="holt_winters"),
    "holt_winters_season24": dict(kind="holt_winters", season=24),
    "holt_winters_season288": dict(kind="holt_winters", season=288),
    "hierarchy": dict(kind="hierarchy"),
    "hierarchy_h055_five_scales": dict(kind="hierarchy", hurst=0.55,
                                       hier_scales=(1, 3, 9, 27, 81)),
    "seasonal_naive": dict(kind="seasonal_naive"),
    "seasonal_naive_season24": dict(kind="seasonal_naive", season=24),
    "seasonal_naive_season288": dict(kind="seasonal_naive", season=288),
}
FAMILIES = ("ewma", "holt_winters", "hierarchy", "seasonal_naive")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_traces() -> np.ndarray:
    rng = np.random.default_rng(5)
    bursty = [jwl.generate_trace(jwl.WorkloadConfig(n_steps=N_STEPS, seed=s))
              for s in (0, 1, 2)]
    return np.stack(bursty + [rng.uniform(0.0, 1.0, N_STEPS),
                              np.clip(rng.normal(0.5, 0.2, N_STEPS), 0.0, 1.0)]
                    ).astype(np.float32)


def _scenario_traces() -> np.ndarray:
    return np.stack([jscn.get_scenario(n).trace(N_STEPS, seed=0)
                     for n in sorted(jscn.SCENARIOS)]).astype(np.float32)


TRACES = {"random": _random_traces(), "scenarios": _scenario_traces()}


def _run_port(cfg, traces):
    w = torch.from_numpy(traces)
    state = tpred.init_state(cfg, w.shape[0], CPU)
    preds, acts = [], []
    for t in range(w.shape[1]):
        p = tpred.predict(cfg, state)
        preds.append(p)
        acts.append(tpred.workload_to_bin(w[:, t], cfg.n_bins))
        state = tpred.observe(cfg, state, w[:, t], p)
    return torch.stack(preds, 1).numpy(), torch.stack(acts, 1).numpy(), state


def _configs(name):
    kw = dict(n_bins=25, warmup_steps=32, margin_bins=1, **CONFIGS[name])
    return jpred.PredictorConfig(**kw), tpred.PredictorConfig(**kw)


@pytest.mark.parametrize("traces", sorted(TRACES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_matches_jax(name, traces):
    jcfg, tcfg = _configs(name)
    w = TRACES[traces]
    preds, acts, state = _run_port(tcfg, w)
    for k in range(w.shape[0]):
        ref = jpred.evaluate_trace(jcfg, w[k])
        np.testing.assert_array_equal(preds[k], np.asarray(ref.predicted))
        np.testing.assert_array_equal(acts[k], np.asarray(ref.actual))
        assert int(state.mispredictions[k]) == int(ref.final_state.mispredictions)
        assert int(state.margin_misses[k]) == int(ref.final_state.margin_misses)
        for field, want in zip(ref.final_state.inner._fields, ref.final_state.inner):
            got = getattr(state.inner, field)[k].numpy()
            want = np.asarray(want)
            assert got.shape == want.shape, field
            if want.dtype.kind in "iu":
                np.testing.assert_array_equal(got, want, err_msg=field)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=STATE_ATOL,
                                           err_msg=field)
    # the comparison is only as strong as the misses the traces produce
    assert int(state.mispredictions.sum()) > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_evaluate_trace_matches_jax(name):
    jcfg, tcfg = _configs(name)
    trace = TRACES["random"][0]
    ref = jpred.evaluate_trace(jcfg, trace)
    got = tpred.evaluate_trace(tcfg, trace, device="cpu")
    np.testing.assert_array_equal(got.predicted.numpy(), np.asarray(ref.predicted))
    np.testing.assert_array_equal(got.actual.numpy(), np.asarray(ref.actual))
    for field in ("exact_accuracy", "margin_accuracy"):
        x = getattr(got, field)
        assert x.dtype == torch.float32 and x.shape == ()
        assert float(x) == float(getattr(ref, field)), field
    assert int(got.final_state.steps[0]) == N_STEPS


def test_evaluate_trace_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.evaluate_trace(tpred.PredictorConfig(kind="ewma"), TRACES["random"][0])


def test_registry_matches_the_reference():
    assert tpred.available() == jpred.available()
    assert len(tpred.available()) == 6
    assert set(tpred.__all__) == set(jpred.__all__) - {"state_spec"}


def test_periods_and_fitted_configs_match_on_every_scenario():
    """At the 2048 steps of the predictor sweep: ``detect_period`` and both
    families' ``config_for_trace`` agree exactly on all 15 scenarios."""
    base_j = jpred.PredictorConfig(kind="seasonal_naive", n_bins=25)
    base_t = tpred.PredictorConfig(kind="seasonal_naive", n_bins=25)
    periods = {}
    for name in sorted(jscn.SCENARIOS):
        w = jscn.get_scenario(name).trace(2048, seed=0)
        np.testing.assert_array_equal(w, tscn.get_scenario(name).trace(2048, seed=0))
        periods[name] = tseas.detect_period(w)
        assert periods[name] == jseas.detect_period(w), name
        assert tseas.config_for_trace(base_t, w).season == \
            jseas.config_for_trace(base_j, w).season
        assert thier.config_for_trace(base_t, w).hurst == \
            jhier.config_for_trace(base_j, w).hurst, name
    assert sorted(set(periods.values())) == [0, 288, 576]
    # a short trace keeps the configured Hurst exponent (NaN estimate)
    assert thier.config_for_trace(base_t, np.full(64, 0.5)).hurst == base_t.hurst
    assert tseas.detect_period(np.arange(40.0)) == jseas.detect_period(np.arange(40.0)) == 0


def _dip_trace(n: int) -> np.ndarray:
    """A 16-step tile whose phases 3 and 11 lie below 1/M (M = 25)."""
    tile = np.linspace(0.2, 0.9, 16).astype(np.float32)
    tile[[3, 11]] = [0.01, 0.03]
    return np.tile(tile, -(-n // 16))[:n]


def test_seasonal_negative_forecast_is_clipped_to_bin_zero():
    cfg = tpred.PredictorConfig(kind="seasonal_naive", n_bins=25, warmup_steps=4,
                                margin_bins=1, season=16)
    jcfg = jpred.PredictorConfig(**dataclasses.asdict(cfg))
    trace = _dip_trace(64)
    state = tpred.init_state(cfg, 1, CPU)
    raw_min = 0
    for t in range(64):
        raw = tpred.get(cfg.kind).predict_inner(cfg, state.inner)
        raw_min = min(raw_min, int(raw[0]))
        p = tpred.predict(cfg, state)
        assert 0 <= int(p[0]) < cfg.n_bins
        state = tpred.observe(cfg, state, torch.from_numpy(trace[t:t + 1]), p)
    assert raw_min == -1
    ref = jpred.evaluate_trace(jcfg, trace)
    got = tpred.evaluate_trace(cfg, trace, device="cpu")
    np.testing.assert_array_equal(got.predicted.numpy(), np.asarray(ref.predicted))
    assert (got.predicted.numpy()[16:][trace[16:] < 1 / 25] == 0).all()


@pytest.mark.parametrize("technique", ["proposed", "hybrid", "headroom"])
def test_seasonal_dips_through_the_fleet_loops_match_jax(technique):
    """The dip trace through ``simulate_fleet`` and ``simulate_fleet_stream``
    of both packages: bins, power and violations per step equal within the
    loops' own tolerance, nothing raises."""
    pkw = dict(kind="seasonal_naive", n_bins=25, warmup_steps=4, margin_bins=1,
               season=16)
    trace = _dip_trace(96)
    jcfg = jctl.ControllerConfig(technique=technique, predictor=jpred.PredictorConfig(**pkw))
    tcfg = tctl.ControllerConfig(technique=technique, predictor=tpred.PredictorConfig(**pkw))
    jtab = jctl.fleet_bin_tables(jctl.char.stack_platform_params(
        [jctl.fpga_platform(JACC["tabla"]).params]), jcfg, (technique,))
    ttab = tctl.fleet_bin_tables(tchar.stack_platform_params(
        [tctl.fpga_platform(TACC["tabla"]).params]), tcfg, (technique,), device="cpu")
    want = jctl.simulate_fleet(jtab, trace, jcfg)
    got = tctl.simulate_fleet(ttab, trace, tcfg, device="cpu")
    np.testing.assert_array_equal(got.predicted_bin.numpy(), np.asarray(want.predicted_bin))
    assert (got.predicted_bin.numpy()[0, 0, 20:][trace[20:] < 1 / 25] == 0).all()
    np.testing.assert_array_equal(got.violations.numpy(), np.asarray(want.violations))
    np.testing.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=1e-6)
    emit = ("predicted_bin", "power")
    jstream = jctl.simulate_fleet_stream(jtab, trace, jcfg, chunk_size=40, emit=emit)
    tstream = tctl.simulate_fleet_stream(ttab, trace, tcfg, chunk_size=40, emit=emit,
                                         device="cpu")
    np.testing.assert_array_equal(tstream.emitted["predicted_bin"],
                                  np.asarray(jstream.emitted["predicted_bin"]))
    np.testing.assert_allclose(tstream.mean_power_w, np.asarray(jstream.mean_power_w),
                               rtol=1e-6)


def test_periodic_helpers_match_jax():
    from repro.core.predictors import periodic as jper
    period = 7
    w = TRACES["random"][:3]
    state = tpred.init_periodic(period, w.shape[0], CPU)
    jstates = [jper.init_periodic(period) for _ in range(w.shape[0])]
    assert tpred.periodic_predict(state, period).tolist() == [1.0, 1.0, 1.0]
    for t in range(40):
        got = tpred.periodic_predict(state, period).numpy()
        want = np.array([float(jper.periodic_predict(s, period)) for s in jstates],
                        np.float32)
        np.testing.assert_array_equal(got, want)
        state = tpred.periodic_observe(state, torch.from_numpy(w[:, t]), period)
        jstates = [jper.periodic_observe(s, w[k, t], period) for k, s in enumerate(jstates)]
    for k, s in enumerate(jstates):
        np.testing.assert_array_equal(state.phase_sum[k].numpy(), np.asarray(s.phase_sum))
        np.testing.assert_array_equal(state.phase_count[k].numpy(), np.asarray(s.phase_count))
        assert int(state.step[k]) == int(s.step) == 40


def test_transition_matrix_matches_jax():
    kw = dict(kind="markov", n_bins=8, warmup_steps=4, margin_bins=1)
    trace = TRACES["random"][0][:64]
    ref = jpred.evaluate_trace(jpred.PredictorConfig(**kw), trace)
    got = tpred.evaluate_trace(tpred.PredictorConfig(**kw), trace, device="cpu")
    np.testing.assert_allclose(tpred.transition_matrix(got.final_state)[0].numpy(),
                               np.asarray(jpred.transition_matrix(ref.final_state)),
                               rtol=1e-6)
