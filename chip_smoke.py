#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the root of a checkout.  Phases, each raising on failure:

1. device — the card's name and power limit; TF32 off for matmul and cuDNN;
2. build — compile the port's CUDA kernels from this checkout's sources;
3. kernels — each kernel against its plain PyTorch version on the card, on
   the Table II sweep (both grid shapes), a roofline (max-delay) platform and
   an infeasible row; times the kernel, its plain version and its bound;
4. main path — ``compare_all_batched`` on ``cuda`` for Table II (five
   accelerators × six techniques, 8 nodes, 25 bins) at 2048 and 1024 steps:
   the kernel launch count of each run, the per-accelerator gains, the
   1024-step gains against ``BENCH_fleet.json``, the same calls on the CPU,
   the warm wall time with the step loop's share of it, and the device's
   busy time per step of the loop (``torch.profiler``).

It ends with a ``{"kernels": [...]}`` line, the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line.  Without a
CUDA device, or outside a checkout of this repository, it exits non-zero
and prints no result.  It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The H100 SXM's published peaks: HBM3 bandwidth and non-tensor-core fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
POWER_RTOL = 1e-5
NEAR_TIE_RTOL = 1e-6
SUMMARY_RTOL = 1e-5
GAIN_ATOL = 0.006   # BENCH_fleet.json prints gains to two decimals
SUMMARY_FIELDS = ("mean_power_w", "nominal_power_w", "power_gain",
                  "qos_violation_rate", "served_fraction", "mean_backlog",
                  "nominal_power_configured_w", "power_gain_vs_configured")
MISS_FIELDS = ("misprediction_rate", "margin_misprediction_rate")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_time_ms(fn, n: int) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, warm.

    Each call sits between two CUDA events, and all of them are queued
    behind a GPU spin long enough to cover their enqueue, so the events
    time the device's work and its launch gaps, not the host's Python.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(n)]
    torch.cuda._sleep(int(2e9 * (3 * host_s + 0.01)))  # ≥ 3× the enqueue time
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {name} x{torch.cuda.device_count()}")
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi, name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {sorted(libs)} built in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _sweep_cases(dev):
    """Kernel-vs-plain inputs: ``name → (params, masks, levels, grids)``."""
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import voltage as volt
    from repro_torch.core.accelerators import ACCELERATORS

    cfg = ctl.ControllerConfig()
    fpga = char.stack_platform_params(
        [ctl.fpga_platform(a).params for a in ACCELERATORS.values()])
    tpu = char.stack_platform_params(
        [char.tpu_platform_params(0.002, 0.012, 0.001, "max")])
    gears, f_node, _ = ctl._hybrid_gears(cfg)
    levels = volt.bin_frequency_levels(cfg.n_bins, cfg.margin, cfg.f_floor)

    def all_rows(grids):
        masks = [volt.technique_grid_mask(t, grids) for t in ctl.TECHNIQUES]
        masks += [volt.technique_grid_mask("hybrid", grids)] * len(gears)
        rows = [levels] * len(ctl.TECHNIQUES) + list(f_node)
        return torch.stack(masks), torch.stack(rows)

    default = volt.VoltageGrids.default()
    grids, _, masks, rows = ctl._sweep_rows(cfg, ctl.DEFAULT_TECHNIQUES)
    no_nominal = torch.ones(1, *masks.shape[1:], dtype=torch.bool)
    no_nominal[0, -1, -1] = False
    cases = {
        "table2": (fpga, masks, rows, grids),
        "all_rows_default": (fpga, *all_rows(default), default),
        "all_rows_core_only": (fpga, *all_rows(volt.VoltageGrids.core_only()),
                               volt.VoltageGrids.core_only()),
        "tpu_max_delay": (tpu, *all_rows(default), default),
        "infeasible": (fpga, no_nominal, torch.ones(1, cfg.n_bins), default),
    }
    return {k: (p.to(dev), m.to(dev), lv.to(dev), g.to(dev))
            for k, (p, m, lv, g) in cases.items()}


def _bound(params, masks, levels, grids, out) -> tuple[float, str]:
    """Least time for the sweep on an H100: bytes over HBM bandwidth vs
    fp32 operations over the non-tensor-core peak, for this data."""
    inputs = list(params) + [masks, levels, grids.core, grids.bram]
    outputs = [out.v_core, out.v_bram, out.power, out.feasible]
    n_bytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    n_p, n_m = params.watts_scale.shape[0], levels.shape[-1]
    g = grids.core.numel() * grids.bram.numel()
    # ~10 operations per delay term (sub, max, pow, div, sub, pow, div, div,
    # mul, add) and per power term (div, mul, mul, sub, mul, exp, mul, 2 adds,
    # select); per level and grid point one timing compare, and for the points
    # a row's mask admits a multiply, an add and a min.
    live_d = (params.dl_weight != 0).sum().item()
    live_t = ((params.pw_dyn != 0) | (params.pw_stat != 0)).sum().item()
    ops = (g * 10 * (live_d + live_t)
           + n_p * n_m * (masks.shape[0] * g + 3 * masks.sum().item()))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev) -> dict:
    from repro_torch.core import characterization as char
    from repro_torch.kernels.grid_argmin import grid_argmin, grid_argmin_ref

    max_err, near_ties, record = 0.0, 0, {}
    for name, (params, masks, levels, grids) in _sweep_cases(dev).items():
        out = grid_argmin(params, masks, levels, grids.core, grids.bram)
        ref = grid_argmin_ref(params, masks, levels, grids.core, grids.bram)
        torch.cuda.synchronize()
        check(torch.equal(out.feasible, ref.feasible), f"{name}: feasible differs")
        check(torch.allclose(out.power, ref.power, rtol=POWER_RTOL, atol=POWER_RTOL),
              f"{name}: power differs beyond {POWER_RTOL}")
        err = (out.power - ref.power).abs().max().item()
        rel = ((out.power - ref.power).abs() / ref.power.abs()).max().item()
        # A voltage mismatch is allowed only at a near-tie: the plain
        # version's own objective at the kernel's point is within 1e-6 of
        # its best.
        differs = (out.v_core != ref.v_core) | (out.v_bram != ref.v_bram)
        per_cell = char.PlatformParams(*[x.reshape(x.shape[:1] + (1, 1) + x.shape[1:])
                                         for x in params])
        p_at_kernel = char.params_power(per_cell, out.v_core, out.v_bram, ref.f_rel)
        tie = (p_at_kernel - ref.power).abs() <= NEAR_TIE_RTOL * ref.power.abs()
        check(not bool((differs & ~tie).any()),
              f"{name}: {(differs & ~tie).sum().item()} voltage picks differ off a tie")
        ties = int(differs.sum().item())
        near_ties += ties
        max_err = max(max_err, err)
        if name == "infeasible":
            check(not bool(ref.feasible.any()), "infeasible row found a feasible point")
        print(f"[kernels] grid_argmin {name}: shape {tuple(out.power.shape)} "
              f"max|Δpower| {err:.3g} (rel {rel:.3g}) near-tie flips {ties}")
        if name == "table2":
            record = dict(params=params, masks=masks, levels=levels, grids=grids,
                          out=out)
    print(f"[kernels] grid_argmin near-tie flips in all cases: {near_ties}")

    p, m, lv, g = (record[k] for k in ("params", "masks", "levels", "grids"))
    launches_before = grid_argmin.launches
    ms = device_time_ms(lambda: grid_argmin(p, m, lv, g.core, g.bram), 200)
    plain_ms = device_time_ms(lambda: grid_argmin_ref(p, m, lv, g.core, g.bram), 20)
    one = torch.zeros(1, device=dev)
    floor_ms = device_time_ms(lambda: one.add_(1.0), 200)
    bound_ms, bound_by = _bound(p, m, lv, g, record["out"])
    print(f"[kernels] grid_argmin at Table II shape {tuple(record['out'].power.shape)}, "
          f"medians: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.4f} us ({bound_by}), launch floor (one-element add_) "
          f"{floor_ms * 1e3:.2f} us; {grid_argmin.launches - launches_before} timing launches")
    return {"name": "grid_argmin", "route": "cuda",
            "source": "src/repro_torch/kernels/grid_argmin/csrc/grid_argmin.cu",
            "replaces": "src/repro/kernels/grid_argmin/kernel.py:40",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _bench_gains() -> dict:
    """``table2/*`` gains recorded in BENCH_fleet.json (1024 steps, seed 0)."""
    with open(os.path.join(ROOT, "BENCH_fleet.json")) as fh:
        benches = json.load(fh)["benches"]
    out = {}
    for key, row in benches.items():
        if key.startswith("table2/"):
            out[key] = float(re.search(r"gain=([0-9.]+)x", row["derived"]).group(1))
    return out


def _table2_gains(res, platforms, techniques) -> dict:
    gains = {}
    for plat in platforms:
        acc = plat.name.split(":", 1)[1]
        for tech in techniques:
            gains[f"table2/{acc}/{tech}"] = res[plat.name][tech].power_gain
    for tech in ("proposed", "core_only", "bram_only"):
        gains[f"table2/average/{tech}"] = float(np.mean(
            [res[p.name][tech].power_gain for p in platforms]))
    return gains


def _compare_summaries(a, b, label: str) -> float:
    worst = 0.0
    for plat, per_tech in a.items():
        for tech, s in per_tech.items():
            t = b[plat][tech]
            for f in MISS_FIELDS:
                check(getattr(s, f) == getattr(t, f),
                      f"{label} {plat}/{tech}: {f} {getattr(s, f)} != {getattr(t, f)}")
            for f in SUMMARY_FIELDS:
                x, y = getattr(s, f), getattr(t, f)
                rel = abs(x - y) / max(abs(x), 1e-12)
                worst = max(worst, rel)
                check(rel <= SUMMARY_RTOL or abs(x - y) <= 1e-12,
                      f"{label} {plat}/{tech}: {f} cuda {x} vs cpu {y}")
    return worst


def phase_main_path(dev) -> int:
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import workload as wl
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.kernels.grid_argmin import grid_argmin

    platforms = [ctl.fpga_platform(acc) for acc in ACCELERATORS.values()]
    techniques = ctl.DEFAULT_TECHNIQUES
    traces = {n: wl.generate_trace(wl.WorkloadConfig(
        n_steps=n, mean_load=0.40, lam=1000.0, hurst=0.76, idc=500.0, seed=0))
        for n in (2048, 1024)}
    launches = {}
    results = {}
    for n, trace in traces.items():
        grid_argmin.launches = 0
        t0 = time.perf_counter()
        results[n] = ctl.compare_all_batched(platforms, trace, techniques, device=dev)
        cold_s = time.perf_counter() - t0
        launches[n] = grid_argmin.launches
        check(launches[n] > 0, f"{n} steps: the main path launched no grid_argmin")
        print(f"[main] compare_all_batched cuda, {len(platforms)} accelerators x "
              f"{len(techniques)} techniques x {n} steps: first call {cold_s:.3f} s, "
              f"grid_argmin launches {launches[n]}")
        gains = _table2_gains(results[n], platforms, techniques)
        for plat in platforms:
            acc = plat.name.split(":", 1)[1]
            print(f"[main]   {acc:10s} " + " ".join(
                f"{t}={gains[f'table2/{acc}/{t}']:.3f}x" for t in techniques))
        print("[main]   average    " + " ".join(
            f"{t}={gains[f'table2/average/{t}']:.3f}x"
            for t in ("proposed", "core_only", "bram_only")))

        t0 = time.perf_counter()
        cpu = ctl.compare_all_batched(platforms, trace, techniques, device="cpu")
        cpu_s = time.perf_counter() - t0
        worst = _compare_summaries(results[n], cpu, f"{n} steps")
        print(f"[main]   cuda vs cpu: every Summary field within {SUMMARY_RTOL} "
              f"(worst rel {worst:.3g}), miss rates equal; cpu call {cpu_s:.3f} s")

    bench = _bench_gains()
    got = _table2_gains(results[1024], platforms, techniques)
    check(set(bench) == set(got), f"table2 rows differ: {sorted(set(bench) ^ set(got))}")
    worst = max(abs(got[k] - bench[k]) for k in bench)
    bad = {k: (got[k], bench[k]) for k in bench if abs(got[k] - bench[k]) > GAIN_ATOL}
    check(not bad, f"table2 gains off BENCH_fleet.json by > {GAIN_ATOL}: {bad}")
    print(f"[main] 1024 steps: all {len(bench)} table2 gains within {GAIN_ATOL} of "
          f"BENCH_fleet.json (worst |Δ| {worst:.4f})")

    # Warm wall time of the 2048-step call, and its stages timed in a run
    # of the same code: tables, the step loop, the host-side summaries.
    cfg = ctl.ControllerConfig()
    trace = traces[2048]
    walls, stages = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.compare_all_batched(platforms, trace, techniques, device=dev)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        params = char.stack_platform_params([p.params for p in platforms]).to(dev)
        tables = ctl.fleet_bin_tables(params, cfg, techniques, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = ctl.simulate_fleet(tables, trace, cfg, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ctl.summarize_fleet(platforms, techniques, trace, params, cfg, res)
        t3 = time.perf_counter()
        stages.append((t1 - t0, t2 - t1, t3 - t2))
    wall = float(np.median(walls))
    tab, loop, summ = (float(np.median(x)) for x in zip(*stages))
    print(f"[main] warm compare_all_batched cuda 2048 steps: {wall:.4f} s (median of "
          f"{len(walls)}: {', '.join(f'{w:.4f}' for w in walls)})")
    print(f"[main] stages (medians of {len(stages)} staged runs): tables {tab * 1e3:.2f} ms, "
          f"step loop {loop:.4f} s, summaries {summ * 1e3:.2f} ms; step loop "
          f"{loop / (tab + loop + summ):.1%} of the staged call, {loop / 2048 * 1e6:.1f} us "
          f"per step")
    phase_profile(ctl, tables, trace[:64], cfg, dev, loop / 2048)
    return launches[2048]


def phase_profile(ctl, tables, trace, cfg, dev, step_s: float) -> None:
    """Device busy time of a short window of the step loop (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    ctl.simulate_fleet(tables, trace, cfg, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctl.simulate_fleet(tables, trace, cfg, device=dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    n = len(trace)
    if not kernels:
        print("[profile] the profiler saw no device work: device busy share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / n
    print(f"[profile] step loop, {n} steps: {len(kernels) / n:.1f} device kernels per "
          f"step, {busy_us:.1f} us device busy per step = {busy_us / (step_s * 1e6):.1%} "
          f"of the unprofiled {step_s * 1e6:.1f} us step")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi, name = phase_device()
    phase_build()
    kernel = phase_kernels(dev)
    kernel["launches"] = phase_main_path(dev)
    print("kernels: grid_argmin")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
