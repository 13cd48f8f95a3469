"""The port's campaign CLI against the JAX package's ``scripts/campaign.py``.

``python -m repro_torch.launch.campaign ... --device cpu`` must print the
same table (every line but the ``#`` timing header, which names the
device instead of JAX's trace counters), write the same ``--json`` cells
within 1e-5, and list the same scenarios and schedulers; an unknown
``--predictor`` or other bad flag fails as a command-line error.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from repro.core import scenarios as jscn
from repro_torch.core import scenarios as tscn
from repro_torch.launch import campaign as tcampaign

REPO = os.path.join(os.path.dirname(__file__), "..")
RTOL = 1e-5


def _reference_cli():
    spec = importlib.util.spec_from_file_location(
        "reference_campaign", os.path.join(REPO, "scripts", "campaign.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCAMPAIGN = _reference_cli()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_registries():
    """``--trace`` and ``--failure-model`` register scenarios in both
    libraries; put both back as they were."""
    saved = dict(jscn.SCENARIOS), dict(tscn.SCENARIOS)
    yield
    for lib, old in zip((jscn.SCENARIOS, tscn.SCENARIOS), saved):
        lib.clear()
        lib.update(old)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _table(out):
    return [line for line in out.splitlines() if not line.startswith("#")]


SWEEPS = {
    "aggregate": ["--steps", "128", "--platforms", "tabla"],
    "tenants": ["--steps", "128", "--platforms", "stripes", "--tenants", "3",
                "--scheduler", "priority", "--scenarios", "multi_tenant,flash_crowd,burse"],
    "failure_model": ["--steps", "96", "--platforms", "dnnweaver", "--failure-model",
                      "cascade", "--scenarios", "burse,diurnal",
                      "--techniques", "proposed,hybrid,headroom", "--headroom-frac", "0.25"],
    "trace": ["--steps", "128", "--platforms", "tabla", "--scenarios", "burse",
              "--trace", os.path.join(REPO, "data", "traces", "azure_vm_cpu.csv"),
              "--trace-tau", "60", "--chunk", "50"],
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_same_table_and_json(name, capsys, tmp_path):
    argv = SWEEPS[name]
    want = _run(JCAMPAIGN.main, argv + ["--json", str(tmp_path / "j.json")], capsys)
    got = _run(tcampaign.main, argv + ["--device", "cpu", "--json", str(tmp_path / "t.json")],
               capsys)
    assert _table(got) == _table(want)
    header = [line for line in got.splitlines() if line.startswith("# ") and "cells" in line]
    assert len(header) == 1 and "device=cpu" in header[0]
    assert "traces={'tables': " in header[0]
    with open(tmp_path / "j.json") as fh:
        jout = json.load(fh)
    with open(tmp_path / "t.json") as fh:
        tout = json.load(fh)
    assert sorted(tout) == sorted(jout)
    for key in ("scenarios", "techniques", "n_steps", "scheduler", "tenants", "pareto"):
        assert tout[key] == jout[key], key
    for plat, per_tech in jout["table"].items():
        for tech, per_scen in per_tech.items():
            for scen, cell in per_scen.items():
                for k, v in cell.items():
                    np.testing.assert_allclose(tout["table"][plat][tech][scen][k], v,
                                               rtol=RTOL, err_msg=f"{plat}/{tech}/{scen}/{k}")


@pytest.mark.parametrize("flag", ["--list-scenarios", "--list-schedulers"])
def test_same_listings(flag, capsys):
    assert _run(tcampaign.main, [flag], capsys) == _run(JCAMPAIGN.main, [flag], capsys)


@pytest.mark.parametrize("argv, message", [
    (["--predictor", "arima"], "unknown --predictor 'arima'; choose from ['ewma', "
                               "'hierarchy', 'holt_winters', 'markov', 'persistence', "
                               "'seasonal_naive']"),
    (["--scheduler", "priority"], "--scheduler needs a tenant-resolved"),
    (["--scheduler", "lottery"], "unknown --scheduler 'lottery'"),
    (["--failure-model", "meteor"], "unknown --failure-model 'meteor'"),
    (["--headroom-frac", "1.0"], "--headroom-frac must be in [0, 1)"),
    (["--tenants", "-1"], "--tenants must be >= 0"),
    (["--trace", "missing.csv"], "--trace file not found"),
    (["--platforms", "gpu"], "unknown platform 'gpu'"),
])
def test_command_line_errors(argv, message):
    with pytest.raises(SystemExit, match=re.escape(message)):
        tcampaign.main(argv + ["--device", "cpu", "--steps", "8"])


@pytest.mark.parametrize("flag", ["--cache-dir", "--warm"])
def test_compile_cache_flags_are_not_ported(flag, capsys, tmp_path):
    """The JAX package's XLA compile cache has no port: its two flags name
    the port's kernel-build cache and warm-up (``core.aot``) instead, and
    the campaign's table is the same with them."""
    from repro_torch.kernels import _build
    argv = ["--steps", "48", "--platforms", "tabla", "--scenarios", "burse", "--device", "cpu"]
    plain = _table(_run(tcampaign.main, argv, capsys))
    saved = _build.BUILD_DIR
    try:
        extra = [flag, str(tmp_path / "kc")] if flag == "--cache-dir" else [flag]
        out = _run(tcampaign.main, argv + extra, capsys)
    finally:
        _build.set_build_dir(saved)
    assert _table(out) == plain
    assert ("# kernel build cache: " if flag == "--cache-dir"
            else "# warmed fleet path: ") in out


def test_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcampaign.main(["--steps", "8", "--platforms", "tabla", "--scenarios", "burse"])
