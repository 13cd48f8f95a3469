"""The port's closed-loop serving co-simulation against the JAX package's.

``ContinuousBatcher`` is pure Python in both packages: the same submits
and throughputs must give the same steps.  ``run_request_load`` is
compared for every workload signal, closed and open loop, under a node
schedule and with three tenants: request counts, token counts, drain
steps and latencies equal; the per-τ occupancy, signal, availability,
frequency and throughput arrays equal; power and the summary's watts
within 1e-6 relative.  The watts differ by an ulp on the geared
techniques: the JAX simulator prices with its single-platform table
build, which rounds the hybrid gears' node power apart from the fleet
table build the port's one-platform path is (ROADMAP C).  Then the six
``hybrid/*`` rows of ``BENCH_fleet.json`` as ``benchmarks/run.py``
builds them.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core import predictors as jpred
from repro.core import scheduler as jsched
from repro.serving import autoscale as jauto
from repro.serving import batching as jbatch
from repro_torch.core import controller as tctl
from repro_torch.core import predictors as tpred
from repro_torch.core import scheduler as tsched
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC
from repro_torch.serving import autoscale as tauto
from repro_torch.serving import batching as tbatch

TERMS = (0.002, 0.012, 0.001)
POWER_RTOL = 1e-6
GAIN_ATOL = 0.006
BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_fleet.json")
EQUAL_ARRAYS = ("occupancy_tau", "workload_tau", "arrival_fraction_tau", "avail_tau",
                "f_rel_tau", "throughput_tau", "tau_weights")
EQUAL_SCALARS = ("latency_p50", "latency_p99", "completed", "submitted",
                 "offered_tokens", "served_tokens", "drain_steps", "workload_signal")
WATTS = ("mean_power_w", "nominal_power_w", "power_gain", "nominal_power_configured_w",
         "power_gain_vs_configured")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sims(technique, steps_per_tau=16, **pred):
    pkw = dict(warmup_steps=4, **pred)
    jcfg = jctl.ControllerConfig(technique=technique, n_nodes=8,
                                 predictor=jpred.PredictorConfig(**pkw))
    tcfg = tctl.ControllerConfig(technique=technique, n_nodes=8,
                                 predictor=tpred.PredictorConfig(**pkw))
    return (jauto.DvfsServingSimulator(terms=jauto.RooflineTerms(*TERMS),
                                       steps_per_tau=steps_per_tau, controller_cfg=jcfg),
            tauto.DvfsServingSimulator(terms=tauto.RooflineTerms(*TERMS),
                                       steps_per_tau=steps_per_tau, controller_cfg=tcfg,
                                       device="cpu"))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in EQUAL_ARRAYS:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in EQUAL_SCALARS:
        assert got[key] == want[key] or (math.isnan(got[key]) and math.isnan(want[key])), key
    np.testing.assert_allclose(got["power_tau"], want["power_tau"], rtol=POWER_RTOL)
    for key in ("tenant_latency_p50", "tenant_latency_p99", "tenant_submitted",
                "tenant_completed"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    s, r = got["summary"], want["summary"]
    for f in dataclasses.fields(r):
        x, y = getattr(s, f.name), getattr(r, f.name)
        if f.name in WATTS:
            assert x == pytest.approx(y, rel=POWER_RTOL), f.name
        elif isinstance(y, float) and math.isnan(y):
            assert math.isnan(x), f.name
        else:
            assert x == y, f.name


def _tenants(pkg):
    mod = jsched if pkg == "jax" else tsched
    return mod.make_tenants([2.0, 1.0, 0.0], [0.0, 4.0, 16.0], [0.5, 0.3, 0.2])


LAM = np.concatenate([np.full(256, 0.6), np.full(256, 2.4), np.full(200, 1.0)])
RUNS = {
    "occupancy_closed": ("proposed", dict()),
    "demand_closed": ("hybrid", dict(workload_signal="demand")),
    "arrival_closed": ("proposed", dict(workload_signal="arrival", seed=3)),
    "occupancy_open": ("power_gating", dict(closed_loop=False)),
    "demand_open": ("proposed", dict(workload_signal="demand", closed_loop=False)),
    "node_schedule": ("hybrid", dict(node_schedule=np.array([8, 8, 6, 3, 3, 5, 8, 2]))),
    "node_schedule_open": ("proposed", dict(node_schedule=np.array([8, 4, 4, 7]),
                                            closed_loop=False, workload_signal="demand")),
    "tenants": ("hybrid", dict(tenants="three", workload_signal="demand")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_request_load_matches_jax(name):
    technique, kw = RUNS[name]
    jsim, tsim = _sims(technique)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("tenants") == "three":
        jkw["tenants"], tkw["tenants"] = _tenants("jax"), _tenants("torch")
    want = jsim.run_request_load(LAM, batch_size=24, mean_new_tokens=10, **jkw)
    got = tsim.run_request_load(LAM, batch_size=24, mean_new_tokens=10, **tkw)
    _assert_same(got, want)
    assert got["completed"] == got["submitted"] > 0
    if name == "tenants":
        assert len(got["tenant_latency_p50"]) == 3 and sum(got["tenant_completed"]) == \
            got["completed"]


def test_other_predictor_families_in_the_loop_match_jax():
    for kind in ("ewma", "seasonal_naive"):
        jsim, tsim = _sims("proposed", steps_per_tau=8, kind=kind)
        lam = np.tile(np.concatenate([np.full(64, 0.4), np.full(64, 2.0)]), 3)
        _assert_same(tsim.run_request_load(lam, batch_size=16, mean_new_tokens=6),
                     jsim.run_request_load(lam, batch_size=16, mean_new_tokens=6))


@pytest.mark.parametrize("bad, message", [
    (dict(workload_signal="tokens"), "unknown workload_signal"),
    (dict(node_schedule=np.array([8, 0, 8])), "must be >= 1"),
    (dict(node_schedule=np.array([])), "must be non-empty"),
])
def test_errors_match_jax(bad, message):
    jsim, tsim = _sims("proposed")
    for sim in (jsim, tsim):
        with pytest.raises(ValueError, match=message):
            sim.run_request_load(np.full(16, 1.0), batch_size=4, **bad)
    spec = tsched.make_tenants([1.0, 0.0], [0.0, 0.0], [1.0, 0.0])
    spec = spec._replace(active=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="at least one active"):
        tsim.run_request_load(np.full(16, 1.0), batch_size=4, tenants=spec)


def test_batcher_steps_match_the_reference():
    rng = np.random.default_rng(7)
    jb = jbatch.ContinuousBatcher(batch_size=5, tenant_priority={0: 1.0, 1: 3.0})
    tb = tbatch.ContinuousBatcher(batch_size=5, tenant_priority={0: 1.0, 1: 3.0})
    for step in range(200):
        for _ in range(rng.poisson(1.2)):
            n_tok, ten = int(rng.integers(1, 12)), int(rng.integers(0, 2))
            jb.submit(jbatch.Request(rid=step, prompt_len=4, max_new_tokens=n_tok, tenant=ten))
            tb.submit(tbatch.Request(rid=step, prompt_len=4, max_new_tokens=n_tok, tenant=ten))
        thr = float(rng.choice([0.25, 0.5, 1.0]))
        assert tb.step(throughput=thr) == jb.step(throughput=thr)
        assert tb.queued_by_tenant() == jb.queued_by_tenant()
    assert [dataclasses.astuple(r) for r in tb.finished] == \
        [dataclasses.astuple(r) for r in jb.finished]
    assert tb.drained() == jb.drained()


def test_workload_trace_source_matches_jax():
    jsim, tsim = _sims("proposed")
    lam = np.concatenate([np.full(96, 0.5), np.full(96, 4.0)])
    kw = dict(batch_size=16, mean_new_tokens=8, workload_signal="demand")
    jsrc = jsim.workload_trace_source(jsim.run_request_load(lam, **kw), name="srv")
    tsrc = tsim.workload_trace_source(tsim.run_request_load(lam, **kw), name="srv")
    np.testing.assert_array_equal(tsrc.utilization, jsrc.utilization)
    assert (tsrc.name, tsrc.interval_s, tsrc.provenance, tsrc.normalize) == \
        (jsrc.name, jsrc.interval_s, jsrc.provenance, jsrc.normalize)


def test_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = tauto.DvfsServingSimulator(terms=tauto.RooflineTerms(*TERMS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.run_request_load(np.full(8, 1.0), batch_size=4)


def _bench(prefix):
    with open(BENCH) as fh:
        return {k: v["derived"] for k, v in json.load(fh)["benches"].items()
                if k.startswith(prefix)}


def test_hybrid_rows_match_bench():
    """``hybrid/<accelerator>``: the three gains within 0.006, mean powered
    nodes within 0.006 (two printed decimals)."""
    rows = {k: v for k, v in _bench("hybrid/").items() if k != "hybrid/closed_loop_serving"}
    assert len(rows) == 5
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=1024, seed=0))
    platforms = [tctl.fpga_platform(TACC[k.split("/")[1]]) for k in sorted(rows)]
    fleet = tctl.compare_all_batched(platforms, trace, ("proposed", "power_gating", "hybrid"),
                                     device="cpu")
    for key, plat in zip(sorted(rows), platforms):
        res = fleet[plat.name]
        sim = tctl.simulate(plat, tctl.ControllerConfig(technique="hybrid"), trace,
                            device="cpu")
        got = {"hybrid": res["hybrid"].power_gain, "prop": res["proposed"].power_gain,
               "pg": res["power_gating"].power_gain,
               "mean_nodes": float(sim.n_active.mean())}
        want = {k: float(v.rstrip("x")) for k, v in
                (item.split("=") for item in rows[key].split(";"))}
        assert list(got) == list(want)
        for k in want:
            assert abs(got[k] - want[k]) <= GAIN_ATOL, (key, k, got[k], want[k])


def test_closed_loop_serving_row_matches_bench():
    """``hybrid/closed_loop_serving``: λ = 1 for 4096 steps, τ of 16 steps,
    batch 32, mean 8 new tokens, hybrid on 8 nodes, warmup 4: completed,
    p50 and p99 equal, gain and mean occupancy within 0.006."""
    want = dict(item.split("=") for item in
                _bench("hybrid/closed_loop_serving")["hybrid/closed_loop_serving"].split(";"))
    _, sim = _sims("hybrid")
    out = sim.run_request_load(np.full(4096, 1.0), batch_size=32, mean_new_tokens=8)
    s = out["summary"]
    assert out["completed"] == int(want["completed"])
    assert f"{s.latency_p50:.0f}" == want["p50"] and f"{s.latency_p99:.0f}" == want["p99"]
    assert abs(s.power_gain - float(want["gain"].rstrip("x"))) <= GAIN_ATOL
    assert abs(out["occupancy_tau"].mean() - float(want["occ"])) <= GAIN_ATOL


def test_serve_dvfs_example_runs_on_the_cpu(capsys):
    """``examples/serve_dvfs_torch.py --device cpu``: the reduced model's
    tokens, the technique table, three closed-loop runs and the mixture
    campaign (which registers two scenarios, removed again here)."""
    import importlib.util
    from repro_torch.core import scenarios as tscn
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "serve_dvfs_torch.py")
    spec = importlib.util.spec_from_file_location("serve_dvfs_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = dict(tscn.SCENARIOS)
    try:
        assert mod.main(["--device", "cpu"]) == 0
    finally:
        tscn.SCENARIOS.clear()
        tscn.SCENARIOS.update(saved)
    out = capsys.readouterr().out
    assert "[engine] generated 16 tokens x 4 seqs" in out
    assert sum(line.startswith("[closed-loop/") for line in out.splitlines()) == 3
    assert "[mixture] serving_mix" in out
