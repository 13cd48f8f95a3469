"""The port's composition CLI against ``scripts/compose.py``, and the
cold-path flags of both port CLIs.

``python -m repro_torch.launch.compose ... --device cpu`` must print the
reference's table (every line but the ``#`` headers, which name the
device and the kernel builds instead of JAX's trace counters) and write
the same ``--json`` within 1e-5; ``--fail-on-retrace`` exits 1 exactly
when the second half did kernel work.  ``launch.campaign --predictor``
takes every registered family.  ``--cache-dir`` moves the kernel build
directory and ``--warm`` runs the fleet path once up front, on the CPU
too.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import aot
from repro_torch.core import composition as tcomp
from repro_torch.kernels import _build
from repro_torch.launch import campaign as tcampaign
from repro_torch.launch import compose as tcompose

REPO = os.path.join(os.path.dirname(__file__), "..")
RTOL = 1e-5


def _load_script(name):
    """``scripts/<name>.py`` by path; compose imports its sibling
    ``campaign`` as a top-level module."""
    scripts = os.path.join(REPO, "scripts")
    sys.path.insert(0, scripts)
    try:
        spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                      os.path.join(scripts, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(scripts)


JCOMPOSE = _load_script("compose")
JCAMPAIGN = _load_script("campaign")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_build_dir():
    """``--cache-dir`` moves the kernel build directory; put it back."""
    saved = _build.BUILD_DIR
    yield
    _build.set_build_dir(saved)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _table(out):
    return [line for line in out.splitlines() if not line.startswith("#")]


SEARCHES = {
    "defaults_short": ["--candidates", "24", "--steps", "128", "--chunk", "64"],
    "three_platforms_budget": ["--platforms", "tabla,stripes,tpu", "--scenarios",
                               "burse,node_failure", "--max-nodes", "3", "--candidates",
                               "11", "--steps", "96", "--budget-cost", "6",
                               "--technique", "freq_only", "--pareto-top", "3"],
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_same_table_and_json(name, capsys, tmp_path):
    argv = SEARCHES[name]
    want = _run(JCOMPOSE.main, argv + ["--json", str(tmp_path / "j.json")], capsys)
    got = _run(tcompose.main, argv + ["--device", "cpu", "--json", str(tmp_path / "t.json")],
               capsys)
    assert _table(got) == _table(want)
    assert any("device=cpu" in line for line in got.splitlines() if line.startswith("#"))
    assert "# kernels built in this process: none" in got.splitlines()
    traces = [line for line in got.splitlines() if line.startswith("# traces=")]
    assert len(traces) == 1 and traces[0].endswith(" — second-half retraces: 0")
    assert "'tables': " in traces[0] and "'stream': " in traces[0]
    with open(tmp_path / "j.json") as fh:
        jout = json.load(fh)
    with open(tmp_path / "t.json") as fh:
        tout = json.load(fh)
    assert sorted(tout) == sorted(jout)
    for key in ("platforms", "scenarios", "candidates", "pareto", "retraces_second_half"):
        assert tout[key] == jout[key], key
    for key in ("cost", "nominal_power_w", "total_power_w", "qos_violation_rate",
                "served_fraction"):
        np.testing.assert_allclose(tout[key], jout[key], rtol=RTOL, err_msg=key)


def test_fail_on_retrace(monkeypatch, capsys):
    argv = ["--candidates", "6", "--steps", "32", "--device", "cpu", "--fail-on-retrace"]
    assert tcompose.main(argv) == 0
    built = iter(range(100))
    monkeypatch.setattr(tcomp.ctl, "fleet_trace_counts",
                        lambda: {"tables": 0, "simulate": 0, "stream": next(built)})
    assert tcompose.main(argv) == 1
    assert "ERROR: the second candidate half" in capsys.readouterr().out


@pytest.mark.parametrize("main", [tcompose.main, tcampaign.main], ids=["compose", "campaign"])
def test_cache_dir_and_warm_on_the_cpu(main, capsys, tmp_path):
    cache = tmp_path / "kernels"
    argv = ["--steps", "32", "--chunk", "16", "--device", "cpu", "--cache-dir", str(cache),
            "--warm"]
    argv += (["--candidates", "6"] if main is tcompose.main
             else ["--platforms", "tabla", "--scenarios", "burse,diurnal", "--tenants", "2"])
    out = _run(main, argv, capsys)
    assert f"# kernel build cache: {cache}" in out
    assert "# warmed fleet path: tables " in out
    assert cache.is_dir() and _build.BUILD_DIR == cache
    assert aot.cache_dir() == str(cache)
    assert _build.library_path("grid_argmin").parent.parent == cache


def test_warm_reports_both_stages_and_runs_on_the_card_unless_asked(monkeypatch):
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core.accelerators import ACCELERATORS
    params = char.stack_platform_params([ctl.fpga_platform(ACCELERATORS["tabla"]).params])
    t = aot.warm_fleet_programs(params, ctl.ControllerConfig(), ("proposed", "hybrid"),
                                fleet_shape=(3, 2, 5), chunk_size=8, n_tenants=3,
                                emit=("power",), device="cpu")
    assert sorted(t) == ["stream_compile_s", "tables_compile_s"]
    assert all(v > 0 for v in t.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aot.warm_fleet_programs(params, ctl.ControllerConfig(), ("proposed",))


@pytest.mark.parametrize("kind", ["ewma", "holt_winters", "hierarchy", "seasonal_naive"])
def test_campaign_takes_every_predictor(kind, capsys, tmp_path):
    argv = ["--steps", "96", "--platforms", "stripes", "--scenarios", "burse,replay_azure_vm_cpu",
            "--predictor", kind]
    want = _run(JCAMPAIGN.main, argv + ["--json", str(tmp_path / "j.json")], capsys)
    got = _run(tcampaign.main, argv + ["--device", "cpu", "--json", str(tmp_path / "t.json")],
               capsys)
    assert _table(got) == _table(want)
    assert f"predictor={kind}" in got
    with open(tmp_path / "j.json") as fh:
        jout = json.load(fh)
    with open(tmp_path / "t.json") as fh:
        tout = json.load(fh)
    for plat, per_tech in jout["table"].items():
        for tech, per_scen in per_tech.items():
            for scen, cell in per_scen.items():
                for k, v in cell.items():
                    np.testing.assert_allclose(tout["table"][plat][tech][scen][k], v,
                                               rtol=RTOL, err_msg=f"{plat}/{tech}/{scen}/{k}")


def test_compose_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompose.main(["--candidates", "4", "--steps", "8"])
