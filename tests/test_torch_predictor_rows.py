"""Every ``predictor/*`` row of ``BENCH_fleet.json`` through the port, on
the CPU.

``benchmarks/run.py``'s predictor sweep runs every registered family over
the whole scenario library (tabla, ``proposed``, 2048 steps in 512-step
chunks, 25 bins, warmup 32, margin one bin): one campaign per family,
``seasonal_naive`` one per detected tiling period; each family's
``trace`` row is ``evaluate_trace`` on the seed-0 2048-step bursty trace.
Each row is rebuilt the same way: gains within 0.006 (the file prints two
decimals), QoS rates within 2/S, accuracies within 6e-4 (three decimals).
"""

import dataclasses
import json
import os

import pytest
import torch

from repro_torch.core import controller as tctl
from repro_torch.core import predictors as tpred
from repro_torch.core import scenarios as tscn
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC
from repro_torch.core.predictors import seasonal as tseas

N_STEPS, CHUNK = 2048, 512
GAIN_ATOL = 0.006
RATIO_ATOL = 6e-4
RATE_ATOL = 2.0 / N_STEPS
BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_fleet.json")


def _bench_rows():
    with open(BENCH) as fh:
        benches = json.load(fh)["benches"]
    return {k: v["derived"] for k, v in sorted(benches.items())
            if k.startswith("predictor/")}


ROWS = _bench_rows()


@pytest.fixture(scope="module")
def port_rows():
    """The 96 rows as the port computes them, at full precision."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as every new port test file pins (ROADMAP C)
    try:
        return _port_rows()
    finally:
        torch.set_num_threads(threads)


def _port_rows():
    plat = tctl.fpga_platform(TACC["tabla"])
    names = tuple(sorted(tscn.SCENARIOS))
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=N_STEPS, seed=0))
    rows = {}

    def campaign_rows(kind, group, predictor):
        out = tscn.run_campaign([plat], scenario_names=tuple(group),
                                techniques=("proposed",), n_steps=N_STEPS,
                                chunk_size=CHUNK, predictor=predictor, device="cpu")
        for scen in out["scenarios"]:
            cell = out["table"][plat.name]["proposed"][scen]
            rows[f"predictor/{kind}/{scen}"] = (
                f"exact={1.0 - cell['misprediction_rate']}"
                f";margin={1.0 - cell['margin_misprediction_rate']}"
                f";gain={cell['power_gain']}x;qos={cell['qos_violation_rate']}")

    for kind in tpred.available():
        cfg = tpred.PredictorConfig(kind=kind, n_bins=25, warmup_steps=32, margin_bins=1)
        ev = tpred.evaluate_trace(cfg, trace, device="cpu")
        rows[f"predictor/{kind}/trace"] = (f"exact={float(ev.exact_accuracy)}"
                                           f";margin={float(ev.margin_accuracy)}")
        if kind == "seasonal_naive":
            by_season = {}
            for scen in names:
                fitted = tseas.config_for_trace(
                    cfg, tscn.get_scenario(scen).trace(N_STEPS, seed=0))
                by_season.setdefault(fitted.season, []).append(scen)
            for season, group in sorted(by_season.items()):
                campaign_rows(kind, group, dataclasses.replace(cfg, season=season))
        else:
            campaign_rows(kind, names, cfg)
    return rows


def _values(derived: str) -> dict:
    return {k: float(v.rstrip("x")) for k, v in
            (item.split("=", 1) for item in derived.split(";"))}


def test_every_predictor_row_is_covered(port_rows):
    assert len(ROWS) == 96
    assert sorted(port_rows) == sorted(ROWS)


@pytest.mark.parametrize("key", sorted(ROWS))
def test_predictor_row_matches_bench(key, port_rows):
    want, got = _values(ROWS[key]), _values(port_rows[key])
    assert list(got) == list(want), (key, port_rows[key], ROWS[key])
    for name, value in want.items():
        tol = {"gain": GAIN_ATOL, "qos": RATE_ATOL}.get(name, RATIO_ATOL)
        assert abs(got[name] - value) <= tol, (key, name, port_rows[key], ROWS[key])
