"""The port's predictors, batched over ``[K]`` cells, against the JAX ones.

Three 512-step traces ride as three cells of one port state; each is run
through the JAX package's ``evaluate_trace`` on its own.  Predicted bins,
actual bins and both miss counters must agree exactly: Markov's argmax
ties (the ``0.01 + eye`` prior makes them common) must keep the first
index in both frameworks.  The ``expected`` policy takes the ceiling of
a 25-term float32 sum, which the two frameworks add in different orders:
there the bins may differ by one, and only where that sum lies within
1e-5 of an integer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import predictors as jpred
from repro.core import workload as jwl
from repro_torch.core import predictors as tpred

N_STEPS = 512
SEEDS = (0, 1, 2)

CONFIGS = {
    "markov": dict(kind="markov"),
    "markov_quantile": dict(kind="markov", policy="quantile", quantile=0.8),
    "markov_threshold_decay": dict(kind="markov", update_mode="threshold",
                                   mispred_threshold=3, count_decay=0.97),
    "persistence": dict(kind="persistence"),
}


def _traces() -> np.ndarray:
    return np.stack([jwl.generate_trace(jwl.WorkloadConfig(n_steps=N_STEPS, seed=s))
                     for s in SEEDS]).astype(np.float32)


def _run_port(cfg: tpred.PredictorConfig, traces: np.ndarray):
    w = torch.from_numpy(traces)
    state = tpred.init_state(cfg, w.shape[0], torch.device("cpu"))
    preds, acts, expected = [], [], []
    for t in range(w.shape[1]):
        p = tpred.predict(cfg, state)
        preds.append(p)
        if cfg.kind == "markov":
            row = state.inner.counts[torch.arange(w.shape[0]), state.inner.current_bin]
            expected.append((row / row.sum(-1, keepdim=True)
                             * torch.arange(cfg.n_bins)).sum(-1))
        acts.append(tpred.workload_to_bin(w[:, t], cfg.n_bins))
        state = tpred.observe(cfg, state, w[:, t], p)
    expected = torch.stack(expected, 1).numpy() if expected else None
    return (torch.stack(preds, 1).numpy(), torch.stack(acts, 1).numpy(), state,
            expected)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predictor_matches_jax_exactly(name):
    kw = dict(n_bins=25, warmup_steps=32, margin_bins=1, **CONFIGS[name])
    jcfg, tcfg = jpred.PredictorConfig(**kw), tpred.PredictorConfig(**kw)
    traces = _traces()
    preds, acts, state, _ = _run_port(tcfg, traces)
    for k in range(len(SEEDS)):
        ref = jpred.evaluate_trace(jcfg, traces[k])
        np.testing.assert_array_equal(preds[k], np.asarray(ref.predicted))
        np.testing.assert_array_equal(acts[k], np.asarray(ref.actual))
        assert int(state.steps[k]) == int(ref.final_state.steps) == N_STEPS
        assert int(state.mispredictions[k]) == int(ref.final_state.mispredictions)
        assert int(state.margin_misses[k]) == int(ref.final_state.margin_misses)
        if tcfg.kind == "markov":
            np.testing.assert_allclose(state.inner.counts[k].numpy(),
                                       np.asarray(ref.final_state.inner.counts),
                                       rtol=1e-6)
    # the test is only as strong as its misses: the traces must produce some
    assert int(state.mispredictions.sum()) > 0


def test_expected_policy_differs_only_at_integer_sums():
    """``ceil`` of the expected bin: a one-bin flip is allowed only where
    the float32 sum lies within 1e-5 of an integer (summation order)."""
    kw = dict(n_bins=25, warmup_steps=32, margin_bins=1, policy="expected")
    jcfg, tcfg = jpred.PredictorConfig(**kw), tpred.PredictorConfig(**kw)
    traces = _traces()
    preds, acts, _, expected = _run_port(tcfg, traces)
    for k in range(len(SEEDS)):
        ref = jpred.evaluate_trace(jcfg, traces[k])
        np.testing.assert_array_equal(acts[k], np.asarray(ref.actual))
        ref_pred = np.asarray(ref.predicted)
        off = preds[k] != ref_pred
        assert (np.abs(preds[k] - ref_pred)[off] == 1).all()
        e = expected[k][off]
        np.testing.assert_allclose(e, np.round(e), rtol=0, atol=1e-5)


def test_forecast_fraction_and_bins_match():
    rng = np.random.default_rng(0)
    w = rng.uniform(-0.1, 1.1, 257).astype(np.float32)
    w[:5] = [0.0, 1.0, 0.04, 0.96, 0.5]
    for m in (8, 25):
        np.testing.assert_array_equal(
            tpred.workload_to_bin(torch.from_numpy(w), m).numpy(),
            np.asarray(jpred.workload_to_bin(w, m)))
        b = np.arange(m)
        np.testing.assert_array_equal(
            tpred.bin_upper_edge(torch.from_numpy(b), m).numpy(),
            np.asarray(jpred.bin_upper_edge(b, m)))
    # availability plane: a cold persistence forecaster assumes a healthy fleet
    cfg = tpred.PredictorConfig(kind="persistence", n_bins=8, margin_bins=0)
    state = tpred.init_state(cfg, 3, torch.device("cpu"))
    assert tpred.forecast_fraction(cfg, state).tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("bad", [
    dict(kind="nope"), dict(policy="mode"), dict(update_mode="never"),
    dict(quantile=0.0), dict(count_decay=1.5), dict(warmup_steps=-1),
    dict(ewma_alpha=0.0), dict(hier_scales=(4, 1)), dict(hurst=0.3),
])
def test_config_validation_matches(bad):
    with pytest.raises(ValueError):
        jpred.PredictorConfig(**bad)
    with pytest.raises(ValueError):
        tpred.PredictorConfig(**bad)


def test_config_fields_match_reference():
    j_fields = {f.name: f.default for f in dataclasses.fields(jpred.PredictorConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(tpred.PredictorConfig)}
    assert j_fields == t_fields
    assert set(tpred.available()) <= set(jpred.available())
