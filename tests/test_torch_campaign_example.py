"""``examples/scenario_campaign_torch.py``, the twin of
``examples/scenario_campaign.py``, on the CPU.

Its campaign table (the mean gain of each technique over the five
accelerators and the proposed technique's QoS violations, a row per
scenario) at 256 steps against ``repro.core.scenarios.run_campaign`` at
the same count: within 1e-5 relative (1e-5 absolute for rates).  Both
run the 15 built-in scenarios by name, which must be the first 15 of
both registries in one order: other test files register derived
scenarios (``with_failure_model``, ``register_replay``) in the same
process, and those must not change what is compared.  Its
``main --device cpu`` at small ``--steps`` / ``--stream-steps`` prints
the JAX example's lines, the kernel-library line in place of the
retrace counts.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core import scenarios as jscn
from repro.core.accelerators import ACCELERATORS as JACC

EXAMPLE = pathlib.Path(__file__).resolve().parent.parent / "examples" / "scenario_campaign_torch.py"
STEPS = 256
N_BUILT_IN = 15


def _example():
    spec = importlib.util.spec_from_file_location("scenario_campaign_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_table_matches_jax_campaign():
    mod = _example()
    names = tuple(mod.scn.SCENARIOS)[:N_BUILT_IN]
    assert names == tuple(jscn.SCENARIOS)[:N_BUILT_IN]
    platforms = [mod.ctl.fpga_platform(a) for a in mod.ACCELERATORS.values()]
    out = mod.scn.run_campaign(platforms, scenario_names=names, techniques=mod.TECHNIQUES,
                               n_steps=STEPS, chunk_size=1024, device=torch.device("cpu"))
    rows = mod.campaign_rows(out, platforms)
    jplats = [jctl.fpga_platform(a) for a in JACC.values()]
    jout = jscn.run_campaign(jplats, scenario_names=names, techniques=mod.TECHNIQUES,
                             n_steps=STEPS, chunk_size=1024)
    want = mod.campaign_rows(jout, jplats)
    assert list(rows) == list(want) == list(names) and len(rows) == 15
    for scen, (gains, qos) in want.items():
        for t, g in gains.items():
            assert rows[scen][0][t] == pytest.approx(g, rel=1e-5), (scen, t)
        assert rows[scen][1] == pytest.approx(qos, rel=1e-5, abs=1e-5), scen
    cell = out["table"][platforms[0].name]["proposed"]["node_failure"]
    jcell = jout["table"][jplats[0].name]["proposed"]["node_failure"]
    for k in ("mean_avail_nodes", "power_gain", "power_gain_vs_configured"):
        assert cell[k] == pytest.approx(jcell[k], rel=1e-5), k


def test_twin_prints_the_example_lines(capsys):
    assert _example().main(["--device", "cpu", "--steps", "64", "--stream-steps", "3000"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["scenario", "proposed", "power_gating", "hybrid", "qos(prop)"]
    assert lines[1] == "-" * 80
    rows = lines[2:17]
    assert all(re.fullmatch(r"\S+\s+(\d+\.\d\dx\s+){3}\d\.\d{3}", r) for r in rows), rows
    text = "\n".join(lines)
    assert re.search(r"node_failure on fpga:\w+ \(proposed\): mean usable nodes \d\.\d\d/8, "
                     r"gain \d+\.\d\dx vs available fleet", text)
    assert "streamed 3,000 steps × 2 cells" in text
    assert re.search(r"  proposed  gain=\d+\.\d\dx served=\d\.\d{4} qos_viol=\d\.\d{3}", text)
    assert "kernel libraries loaded by this process: []" in text
    assert re.search(r"replayed azure_vm_cpu \(\d+ samples @ \d+s → 3,000 steps @ 60s\): "
                     r"gain=\d+\.\d\dx .*\(kernel libraries loaded since: \[\]\)", text)
    assert np.isfinite([float(x) for x in re.findall(r"gain=(\d+\.\d+)x", text)]).all()
