"""Package rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither jax nor the JAX
  package ``repro`` (the machine with the card has no jax);
* the entry points run on the CUDA card unless the caller passes
  ``device="cpu"``, and raise on a machine without a card instead of
  falling back to the CPU;
* the kernel build is keyed by its sources and needs no card to plan.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import workload as twl
from repro_torch.configs import get_config
from repro_torch.core.accelerators import ACCELERATORS
from repro_torch.kernels import _build
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving import autoscale as tauto
from repro_torch.serving.engine import ServeEngine

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_package_covers_the_slice():
    names = {str(p.relative_to(REPO / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    for want in ("core/characterization.py", "core/accelerators.py", "core/pll.py",
                 "core/workload.py", "core/voltage.py", "core/predictors/base.py",
                 "core/predictors/markov.py", "core/scheduler.py",
                 "core/controller.py", "kernels/_build.py",
                 "kernels/grid_argmin/ops.py", "kernels/grid_argmin/ref.py",
                 "convert.py", "configs/base.py", "configs/llama3_2_1b.py",
                 "configs/__init__.py", "models/common.py", "models/ffn.py",
                 "models/attention.py", "models/transformer.py",
                 "kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py",
                 "serving/engine.py", "serving/autoscale.py", "launch/serve.py",
                 "configs/falcon_mamba_7b.py", "models/ssm.py",
                 "kernels/ssm_scan/ops.py", "kernels/ssm_scan/ref.py",
                 "core/traces.py", "core/scenarios.py", "runtime/fault.py",
                 "runtime/elastic.py", "launch/campaign.py",
                 "core/predictors/ewma.py", "core/predictors/holt_winters.py",
                 "core/predictors/hierarchy.py", "core/predictors/seasonal.py",
                 "core/predictors/periodic.py", "core/composition.py", "core/aot.py",
                 "launch/compose.py", "serving/batching.py",
                 "configs/gemma2_2b.py", "configs/gemma3_27b.py", "serving/kvcache.py",
                 "configs/zamba2_2_7b.py", "configs/internvl2_1b.py", "configs/hubert_xlarge.py",
                 "configs/llama3_405b.py", "kernels/flash_attention/backward.py",
                 "optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
                 "optim/compress.py", "train/__init__.py", "train/step.py",
                 "data/__init__.py", "data/pipeline.py", "runtime/checkpoint.py",
                 "runtime/straggler.py", "launch/train.py", "kernels/ssm_scan/backward.py",
                 "analysis/__init__.py", "analysis/roofline.py"):
        assert want in names, want
    for name, src in _build.SOURCES.items():
        assert (_build.KERNELS_DIR / src).exists(), name
    assert set(_build.SOURCES) == {"grid_argmin", "flash_attention", "flash_attention_wgmma",
                                   "flash_attention_bwd", "flash_attention_bwd_wgmma",
                                   "flash_attention_wide", "flash_attention_wide_bwd",
                                   "ssm_scan", "ssm_scan_bwd"}


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_rule(monkeypatch):
    _no_cuda(monkeypatch)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.resolve_device(dev)
    with pytest.raises(ValueError, match="unsupported"):
        repro_torch.resolve_device("meta")


def test_entry_points_raise_without_a_card(monkeypatch):
    _no_cuda(monkeypatch)
    platforms = [tctl.fpga_platform(ACCELERATORS["tabla"])]
    params = tchar.stack_platform_params([p.params for p in platforms])
    cfg = tctl.ControllerConfig()
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=64, seed=0))
    tables = tctl.fleet_bin_tables(params, cfg, ("proposed",), device="cpu")
    calls = {
        "compare_all_batched": lambda: tctl.compare_all_batched(platforms, trace),
        "fleet_bin_tables": lambda: tctl.fleet_bin_tables(params, cfg),
        "simulate_fleet": lambda: tctl.simulate_fleet(tables, trace, cfg),
        "platform_params_from_numpy": lambda: convert.platform_params_from_numpy(
            {f: x.numpy() for f, x in zip(params._fields, params)}, device=None),
    }
    cfg_llama = get_config("llama3.2-1b", reduced=True)
    llama = tcommon.init_params(torch.Generator().manual_seed(0),
                                ttf.model_layout(cfg_llama))
    sim = tauto.DvfsServingSimulator(terms=tauto.RooflineTerms(0.002, 0.012, 0.001))
    calls.update({
        "ServeEngine": lambda: ServeEngine(cfg=cfg_llama, params=llama, capacity=16,
                                           batch_size=1),
        "DvfsServingSimulator.run_trace": lambda: sim.run_trace(trace),
        "compare_techniques": lambda: tauto.compare_techniques(sim.terms, trace),
        "serve.main": lambda: tserve.main([]),
        "model_params_from_numpy": lambda: convert.model_params_from_numpy(
            {p: x.numpy() for p, x in tcommon.tree_leaves(llama)}, cfg_llama, None),
    })
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for explicitly, the CPU runs the plain path
    res = tctl.simulate_fleet(tables, trace, cfg, device="cpu")
    assert res.power.device.type == "cpu" and res.power.shape == (1, 1, 64)
    assert np.isfinite(res.power.numpy()).all()


CAMPAIGN_MODULES = ("repro_torch.core.traces", "repro_torch.core.scenarios",
                    "repro_torch.runtime.fault", "repro_torch.runtime.elastic",
                    "repro_torch.launch.campaign", "repro_torch.core.controller",
                    "repro_torch.core.predictors", "repro_torch.core.composition",
                    "repro_torch.core.aot", "repro_torch.launch.compose",
                    "repro_torch.serving.autoscale")


@pytest.mark.parametrize("module", CAMPAIGN_MODULES)
def test_campaign_modules_import_with_jax_blocked(module):
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports each module of the campaign slice (and registers the
    scenario library, bundled replays included)."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"import {module}\n"
            "from repro_torch.core import scenarios\n"
            "assert len(scenarios.SCENARIOS) == 15, sorted(scenarios.SCENARIOS)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr


def test_campaign_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core import scenarios as tscn
    from repro_torch.launch import campaign as tcampaign

    _no_cuda(monkeypatch)
    platforms = [tctl.fpga_platform(ACCELERATORS["tabla"])]
    cfg = tctl.ControllerConfig()
    params = tchar.stack_platform_params([p.params for p in platforms])
    tables = tctl.fleet_bin_tables(params, cfg, ("proposed",), device="cpu")
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=32, seed=0))
    calls = {
        "simulate_fleet_stream": lambda: tctl.simulate_fleet_stream(tables, trace, cfg),
        "run_technique": lambda: tctl.run_technique(platforms[0], trace, "proposed"),
        "compare_all": lambda: tctl.compare_all(tctl.analytic_platform(), trace),
        "run_campaign": lambda: tscn.run_campaign(platforms, ("burse",), n_steps=32),
        "campaign.main": lambda: tcampaign.main(["--steps", "32", "--platforms", "tabla"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = tctl.simulate_fleet_stream(tables, trace, cfg, device="cpu")
    assert out.mean_power_w.shape == (1, 1) and np.isfinite(out.mean_power_w).all()


TRAINING_MODULES = ("repro_torch.optim", "repro_torch.train", "repro_torch.data",
                    "repro_torch.runtime.checkpoint", "repro_torch.runtime.straggler",
                    "repro_torch.runtime.fault", "repro_torch.launch.train",
                    "repro_torch.kernels.flash_attention.backward", "repro_torch.convert")


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_import_with_jax_blocked(module):
    """A fresh interpreter in which ``import jax`` and ``import repro``
    fail imports each module of the training slice."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"import {module}\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.launch import train as ttrain

    _no_cuda(monkeypatch)
    cfg = get_config("llama3.2-1b", reduced=True)
    layout = ttf.model_layout(cfg)
    zeros = {p: np.zeros(d.shape, np.float32) for p, d in tcommon.tree_leaves(layout)}

    class State:
        step, m, v = np.int32(0), zeros, zeros

    calls = {
        "train.main": lambda: ttrain.main(["--steps", "1"]),
        "opt_state_from_numpy": lambda: convert.opt_state_from_numpy(State, cfg, None),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    state = convert.opt_state_from_numpy(State, cfg, "cpu")
    assert state.step.dtype == torch.int32 and state.m["embed"].device.type == "cpu"


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_kernel_build_is_keyed_by_source(name):
    path = _build.library_path(name)
    assert path.parent.parent == _build.BUILD_DIR
    assert path.parent.name.startswith(f"{name}-") and path.name == f"lib{name}.so"
    assert path == _build.library_path(name)  # stable for one source
    others = {_build.library_path(n).parent for n in _build.SOURCES if n != name}
    assert path.parent not in others
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    ignored = (REPO / ".gitignore").read_text().split()
    assert os.path.relpath(_build.BUILD_DIR, REPO) + "/" in ignored
