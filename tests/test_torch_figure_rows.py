"""Every ``fig4/5/6/10/12`` row of ``BENCH_fleet.json`` through the port,
on the CPU.

§III Fig. 4–6 sweep the analytic (α, β) platform at a constant load;
§V Fig. 10/12 run the Table I accelerators over 1024 steps of the bursty
trace.  Each row is rebuilt as ``benchmarks/run.py`` builds it, through
``run_technique`` / ``simulate``: gains within 0.006 (the file prints two
decimals), fig10's voltage ranges and rates and fig12's lowest BRAM
voltage equal at the printed decimals.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.core import controller as tctl
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC

GAIN_ATOL = 0.006
BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_fleet.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench_rows():
    with open(BENCH) as fh:
        benches = json.load(fh)["benches"]
    return {k: v["derived"] for k, v in sorted(benches.items())
            if k.split("/")[0] in ("fig4", "fig5", "fig6", "fig10", "fig12")}


ROWS = _bench_rows()
TRACE_1024 = twl.generate_trace(twl.WorkloadConfig(n_steps=1024, seed=0))


def _gain(derived: str) -> float:
    return float(re.search(r"gain=([0-9.]+)x", derived).group(1))


def _figure_row(key: str):
    """The port's run behind one BENCH row, as ``benchmarks/run.py``
    builds it: ``(Summary, TraceResult or None)``."""
    fig, *rest = key.split("/")
    if fig == "fig4":
        load, tech = float(rest[0][len("load"):]), rest[1]
        plat = tctl.analytic_platform(alpha=0.2, beta=0.4)
        return tctl.run_technique(plat, np.full(256, load), tech, n_nodes=64,
                                  device="cpu"), None
    if fig in ("fig5", "fig6"):
        value, tech = float(rest[0][len("alpha" if fig == "fig5" else "beta"):]), rest[1]
        plat = (tctl.analytic_platform(alpha=value, beta=0.4) if fig == "fig5"
                else tctl.analytic_platform(alpha=0.2, beta=value))
        return tctl.run_technique(plat, np.full(256, 0.5), tech, device="cpu"), None
    plat = tctl.fpga_platform(TACC[rest[0]])
    cfg = tctl.ControllerConfig(technique="proposed")
    res = tctl.simulate(plat, cfg, TRACE_1024, device="cpu")
    return tctl.summarize(plat, cfg, TRACE_1024, res), res


def test_every_figure_row_is_covered():
    counts = {}
    for key in ROWS:
        counts[key.split("/")[0]] = counts.get(key.split("/")[0], 0) + 1
    assert counts == {"fig4": 20, "fig5": 15, "fig6": 15, "fig10": 1, "fig12": 5}


@pytest.mark.parametrize("key", sorted(ROWS))
def test_figure_row_matches_bench(key):
    derived = ROWS[key]
    s, res = _figure_row(key)
    assert abs(s.power_gain - _gain(derived)) <= GAIN_ATOL, (key, s.power_gain, derived)
    if key.startswith("fig10/"):
        vc, vb = res.v_core.numpy(), res.v_bram.numpy()
        got = (f"vcore=[{vc.min():.2f},{vc.max():.2f}];vbram=[{vb.min():.2f},{vb.max():.2f}]"
               f";mispred={s.misprediction_rate:.3f};qos_viol={s.qos_violation_rate:.3f}")
        assert derived.split(";", 1)[1] == got
    elif key.startswith("fig12/"):
        assert derived.split(";", 1)[1] == f"min_vbram={res.v_bram.numpy().min():.2f}"
