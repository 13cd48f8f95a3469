"""Scenario-campaign runner: platforms × techniques × scenarios, streamed.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.campaign                # on the card
  PYTHONPATH=src python -m repro_torch.launch.campaign --device cpu   # plain path
  PYTHONPATH=src python -m repro_torch.launch.campaign --steps 100000 --chunk 8192 \\
      --scenarios burse,flash_crowd,node_failure --json campaign.json
  PYTHONPATH=src python -m repro_torch.launch.campaign --tenants 3 \\
      --scheduler priority --scenarios multi_tenant,flash_crowd --platforms tabla
  PYTHONPATH=src python -m repro_torch.launch.campaign --list-scenarios

One table build (one ``grid_argmin`` launch on the card) for every
(platform × technique), then every (platform × technique × scenario) cell
through the streaming fleet path in ``[K, C]`` chunks, so any trace length
runs in memory independent of it.  The flags, the table printed and the
``--json`` output are those of the JAX package's ``scripts/campaign.py``,
plus ``--device``.  ``--predictor`` takes every registered family.
``--cache-dir`` keeps the built kernel libraries in a directory that later
processes reuse, and ``--warm`` builds them and builds the fleet programs
of the campaign's shape first (``core.aot``), so the campaign itself
builds none.  The header's ``traces=`` is
``controller.fleet_trace_counts()``: the fleet programs built in this
process (on the card captured CUDA graphs), as the JAX script counts its
traces.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from repro_torch.core import aot
from repro_torch.core import characterization as char
from repro_torch.core import controller as ctl
from repro_torch.core import predictors as preds
from repro_torch.core import scenarios as scn
from repro_torch.core import scheduler as sched_mod
from repro_torch.core import traces
from repro_torch.core.accelerators import ACCELERATORS


def build_platforms(spec: str):
    """'tabla,stripes,tpu' → PlatformSpecs (FPGA accelerators + TPU)."""
    plats = []
    for name in [s for s in spec.split(",") if s]:
        if name == "all":
            plats.extend(ctl.fpga_platform(a) for a in ACCELERATORS.values())
        elif name == "tpu":
            plats.append(ctl.tpu_platform(t_compute=0.002, t_memory=0.012,
                                          t_collective=0.001))
        elif name in ACCELERATORS:
            plats.append(ctl.fpga_platform(ACCELERATORS[name]))
        else:
            raise SystemExit(f"unknown platform {name!r}; choose from "
                             f"{sorted(ACCELERATORS)} + ['tpu', 'all']")
    return plats


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4096,
                    help="trace length per scenario (any size — streamed)")
    ap.add_argument("--chunk", type=int, default=1024,
                    help="streaming chunk size (steps per device chunk)")
    ap.add_argument("--scenarios", type=str, default="",
                    help=f"comma list from {sorted(scn.SCENARIOS)} "
                    "(default: all)")
    ap.add_argument("--techniques", type=str,
                    default="proposed,power_gating,hybrid")
    ap.add_argument("--failure-model", type=str, default="none",
                    help="overlay a correlated failure model onto every "
                    "swept scenario: one of "
                    f"{['none'] + sorted(scn.FAILURE_MODELS)}; each "
                    "scenario <s> is swept as <s>+<model> (workload "
                    "unchanged, node schedule from the model)")
    ap.add_argument("--headroom-frac", type=float, default=0.5,
                    help="failure depth the 'headroom' technique "
                    "provisions spare capacity for: the availability-"
                    "forecast bump plans delivery for up to "
                    "ceil(frac*n_nodes) lost nodes")
    ap.add_argument("--platforms", type=str, default="all",
                    help="comma list of accelerator names, 'tpu', or 'all'")
    ap.add_argument("--n-nodes", type=int, default=8)
    ap.add_argument("--predictor", type=str, default="markov",
                    help="workload forecaster for every cell: one of the "
                    f"registered kinds {list(preds.available())}")
    ap.add_argument("--tenants", type=int, default=0,
                    help="resolve each scenario into this many tenant "
                    "classes and report per-tenant QoS (0 = aggregate "
                    "single-tenant path; scenarios with fewer classes pad "
                    "with inert tenants)")
    ap.add_argument("--scheduler", type=str, default="none",
                    help="per-tenant placement/admission policy: one of "
                    "the registered schedulers (see --list-schedulers); "
                    "'none' reproduces the aggregate allocator")
    ap.add_argument("--list-schedulers", action="store_true",
                    help="print the registered scheduler policies and exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dir", type=str, default="",
                    help="directory of the built kernel libraries "
                    "(core.aot): repeat campaigns load them instead of "
                    "building them")
    ap.add_argument("--warm", action="store_true",
                    help="build the fleet path's kernels and run it once "
                    "at this campaign's shapes before running")
    ap.add_argument("--json", type=str, default="",
                    help="write the campaign table to this path")
    ap.add_argument("--trace", type=str, default="",
                    help="CSV/NPZ utilization trace to replay as an extra "
                    "scenario (registered as replay_<stem>)")
    ap.add_argument("--trace-interval", type=float, default=None,
                    help="sampling interval of --trace in seconds "
                    "(default: inferred from the file)")
    ap.add_argument("--trace-tau", type=float, default=None,
                    help="resample the --trace replay to this many seconds "
                    "per control step (default: one sample per step)")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print the registered scenario library and exit")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card, or an error without "
                         "one) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    # Validate up front: one-line errors instead of deep tracebacks.
    if args.trace and not os.path.exists(args.trace):
        raise SystemExit(f"error: --trace file not found: {args.trace}")
    if args.trace_interval is not None and args.trace_interval <= 0:
        raise SystemExit("error: --trace-interval must be positive "
                         f"(got {args.trace_interval:g})")
    if args.trace_tau is not None and args.trace_tau <= 0:
        raise SystemExit("error: --trace-tau must be positive "
                         f"(got {args.trace_tau:g})")
    if args.predictor not in preds.available():
        raise SystemExit(f"error: unknown --predictor {args.predictor!r}; "
                         f"choose from {list(preds.available())}")
    if args.scheduler not in sched_mod.available():
        raise SystemExit(f"error: unknown --scheduler {args.scheduler!r}; "
                         f"choose from {list(sched_mod.available())}")
    if args.tenants < 0:
        raise SystemExit(f"error: --tenants must be >= 0 "
                         f"(got {args.tenants})")
    if args.scheduler != "none" and args.tenants == 0:
        raise SystemExit("error: --scheduler needs a tenant-resolved "
                         "workload plane; pass --tenants N (N >= 1)")
    if args.failure_model != "none" \
            and args.failure_model not in scn.FAILURE_MODELS:
        raise SystemExit(f"error: unknown --failure-model "
                         f"{args.failure_model!r}; choose from "
                         f"{['none'] + sorted(scn.FAILURE_MODELS)}")
    if not 0.0 <= args.headroom_frac < 1.0:
        raise SystemExit("error: --headroom-frac must be in [0, 1) "
                         f"(got {args.headroom_frac:g})")

    if args.list_schedulers:
        for name in sched_mod.available():
            cfg = sched_mod.get(name)
            state = "enabled" if cfg.enabled else "pass-through"
            print(f"{name:16s} policy={cfg.policy:10s} "
                  f"migration_cost={cfg.migration_cost:g}  ({state})")
        return 0

    # Register --trace before --list-scenarios so the listing shows it.
    registered = None
    if args.trace:
        kwargs = ({"interval_s": args.trace_interval}
                  if args.trace_interval is not None else {})
        registered = scn.register_replay(traces.load(args.trace, **kwargs),
                                         tau_s=args.trace_tau,
                                         overwrite=True)
        print(f"# registered {registered.name}: {registered.description}")

    if args.list_scenarios:
        for name, sc in sorted(scn.SCENARIOS.items()):
            print(f"{name:22s} {sc.description}")
        return 0

    platforms = build_platforms(args.platforms)
    names = tuple(s for s in args.scenarios.split(",") if s) or None
    techniques = tuple(t for t in args.techniques.split(",") if t)
    if registered is not None and names is not None:
        names += (registered.name,)
    if args.failure_model != "none":
        # Every swept scenario keeps its workload and takes its node
        # schedule from the failure model (<scenario>+<model>).
        base = names if names is not None else tuple(sorted(scn.SCENARIOS))
        names = tuple(scn.with_failure_model(s, args.failure_model).name
                      for s in base)

    if args.cache_dir:
        print(f"# kernel build cache: "
              f"{aot.enable_compilation_cache(args.cache_dir)}")
    if args.warm:
        params = char.stack_platform_params([p.params for p in platforms])
        cfg = ctl.ControllerConfig(n_nodes=args.n_nodes,
                                   predictor=args.predictor)
        n_scen = len(names) if names is not None else len(scn.SCENARIOS)
        t = aot.warm_fleet_programs(
            params, cfg, techniques,
            fleet_shape=(len(platforms), len(techniques), n_scen),
            chunk_size=min(args.chunk, args.steps),
            n_tenants=max(1, args.tenants), device=args.device)
        print(f"# warmed fleet path: tables {t['tables_compile_s']:.2f}s"
              f", stream {t['stream_compile_s']:.2f}s")

    t0 = time.perf_counter()
    out = scn.run_campaign(platforms, scenario_names=names,
                           techniques=techniques, n_steps=args.steps,
                           seed=args.seed, chunk_size=args.chunk,
                           n_nodes=args.n_nodes, predictor=args.predictor,
                           tenants=args.tenants or None,
                           scheduler=args.scheduler,
                           headroom_frac=args.headroom_frac,
                           device=args.device)
    dt = time.perf_counter() - t0
    cells = len(platforms) * len(techniques) * len(out["scenarios"])
    tenant_note = (f", tenants={args.tenants}, scheduler={args.scheduler}"
                   if args.tenants else "")
    print(f"# {cells} cells × {args.steps} steps in {dt:.2f}s "
          f"(chunk={args.chunk}, predictor={args.predictor}"
          f"{tenant_note}, device={args.device or 'cuda'}, "
          f"traces={ctl.fleet_trace_counts()})\n")

    for scen in out["scenarios"]:
        print(f"== scenario: {scen} ==")
        avail = out["table"][platforms[0].name][techniques[0]][scen][
            "mean_avail_nodes"]
        if avail < args.n_nodes - 1e-9:
            print(f"   (mean usable nodes {avail:.2f}/{args.n_nodes}; "
                  "power_gain is vs the available fleet — "
                  "power_gain_vs_configured is in the JSON)")
        width = 14 + (6 if args.tenants else 0)
        print(f"{'platform':16s} "
              + " ".join(f"{t:>{width}s}" for t in techniques))
        for plat in platforms:
            row = out["table"][plat.name]
            cells_s = " ".join(
                f"{row[t][scen]['power_gain']:6.2f}x"
                f"/q{row[t][scen]['qos_violation_rate']:.2f}"
                + (f"/w{row[t][scen]['worst_tenant_qos_violation']:.2f}"
                   if args.tenants else "")
                for t in techniques)
            front = ",".join(out["pareto"][plat.name][scen])
            print(f"{plat.name:16s} {cells_s}   pareto[{front}]")
        if args.tenants:
            print("   (w = worst per-tenant QoS-violation rate across "
                  "active tenant classes)")
        print()

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        print(f"# wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
