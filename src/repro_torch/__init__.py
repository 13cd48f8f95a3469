"""PyTorch / CUDA port of the multi-FPGA DVFS system (``src/repro``).

Mirrors the JAX package's layout and imports neither jax nor ``repro``:

  core.characterization — delay/power term library, ``PlatformParams``
  core.accelerators     — the paper's Table I designs and Table II targets
  core.pll              — PLL stall model (Eqs. 4-5)
  core.workload         — BURSE-like trace synthesis (numpy, bit-identical)
  core.voltage          — voltage grids, technique masks, grid argmin
  core.predictors       — the six workload forecasters over ``[K]`` cells
                          (markov, persistence, ewma, holt_winters,
                          hierarchy, seasonal_naive) and ``evaluate_trace``
  core.scheduler        — tenant plane and per-step scheduling math
  core.controller       — fleet tables, the §V step loop, the streaming
                          fleet engine, Table II and figure summaries
  core.traces           — recorded utilization traces: load, resample, mix
  core.scenarios        — the named scenario library and ``run_campaign``
  core.composition      — fleet-composition search (which platforms, how
                          many nodes) with per-scenario Pareto sets
  core.aot              — the kernel-build cache and the fleet-path warmer
  runtime.fault         — correlated fleet-failure models (numpy)
  runtime.elastic       — the usable mesh of a fleet that lost nodes, and
                          a state re-sharded onto it
  parallel.sharding     — the logical-axis rules, FSDP gathers and the
                          fleet axis split over local devices
  launch.mesh           — the ("data", "model") DeviceMesh of the ranks
  kernels.grid_argmin   — the table sweep: a CUDA kernel plus its plain
                          PyTorch version
  convert               — JAX-side ``PlatformParams`` leaves → tensors
  serving               — the generation engine, the continuous batcher
                          and the closed-loop DVFS serving simulator
  launch.serve, launch.campaign, launch.compose, launch.train — the
                          command-line entry points

Entry points take an explicit ``device``.  Left unset it means the CUDA
card, and a machine without one raises instead of falling back to the CPU;
``device="cpu"`` runs the plain PyTorch path (what the tests use).
"""

from repro_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
