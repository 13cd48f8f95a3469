"""Fleet-composition search CLI: which platforms, how many nodes?

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.compose                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.compose --device cpu    # plain path
  PYTHONPATH=src python -m repro_torch.launch.compose --platforms tabla,stripes,tpu \\
      --scenarios burse,diurnal --max-nodes 12 --budget-cost 16
  PYTHONPATH=src python -m repro_torch.launch.compose --candidates 200 --steps 8192 \\
      --cache-dir ~/.cache/repro-torch --json compose.json

Sweeps candidate fleet mixes (node-count vectors over a platform catalog)
× scenarios through the streaming fleet path (one table build, one
``grid_argmin`` launch on the card, then the candidate batch in two
halves) and prints each scenario's Pareto set over (mean power, QoS
violation rate, cost).  The flags, the table and the ``--json`` output are
those of the JAX package's ``scripts/compose.py``, plus ``--device``.
``--cache-dir`` keeps the built kernel libraries in a directory that
later processes reuse; ``--warm`` builds them and runs the fleet path
once at the search's shape before the search.  The ``# traces=`` line is
``controller.fleet_trace_counts()`` (the fleet programs built in this
process), and ``--fail-on-retrace`` exits 1 if the second half built any.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from repro_torch.core import aot
from repro_torch.core import characterization as char
from repro_torch.core import composition as comp
from repro_torch.core import controller as ctl
from repro_torch.core import scenarios as scn
from repro_torch.kernels import _build
from repro_torch.launch.campaign import build_platforms


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--candidates", type=int, default=200,
                    help="number of candidate fleet mixes to evaluate")
    ap.add_argument("--max-nodes", type=int, default=8,
                    help="per-platform node-count ceiling")
    ap.add_argument("--platforms", type=str, default="tabla,stripes",
                    help="comma list of accelerator names, 'tpu', or 'all'")
    ap.add_argument("--scenarios", type=str, default="burse,diurnal",
                    help=f"comma list from {sorted(scn.SCENARIOS)}")
    ap.add_argument("--technique", type=str, default="proposed",
                    choices=comp.COMPOSABLE_TECHNIQUES)
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference-nodes", type=float, default=8.0,
                    help="demand scale: w=1.0 means this many reference "
                    "nodes' worth of peak throughput")
    ap.add_argument("--budget-cost", type=float, default=None,
                    help="drop candidates whose build cost exceeds this")
    ap.add_argument("--budget-watts", type=float, default=None,
                    help="drop candidates whose nominal watts exceed this")
    ap.add_argument("--pareto-top", type=int, default=8,
                    help="rows of each Pareto set to print")
    ap.add_argument("--cache-dir", type=str, default="",
                    help="directory of the built kernel libraries "
                    "(core.aot): a later process with the same kernel "
                    "sources loads them instead of building them")
    ap.add_argument("--warm", action="store_true",
                    help="build the fleet path's kernels and run it once "
                    "at the search's shape before the search")
    ap.add_argument("--fail-on-retrace", action="store_true",
                    help="exit 1 if the second candidate half built any "
                    "fleet program (controller.fleet_trace_counts)")
    ap.add_argument("--json", type=str, default="",
                    help="write the full result table to this path")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card, or an error without "
                         "one) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    if args.cache_dir:
        print(f"# kernel build cache: "
              f"{aot.enable_compilation_cache(args.cache_dir)}")

    platforms = build_platforms(args.platforms)
    scenario_names = tuple(s for s in args.scenarios.split(",") if s)
    cand = comp.enumerate_candidates(len(platforms), args.max_nodes,
                                     args.candidates, seed=args.seed)
    budget = comp.CompositionBudget(reference_nodes=args.reference_nodes,
                                    max_cost=args.budget_cost,
                                    max_power_w=args.budget_watts)

    if args.warm:
        params = char.stack_platform_params([p.params for p in platforms])
        n_half = -(-cand.shape[0] // 2)
        t = aot.warm_fleet_programs(
            params, ctl.ControllerConfig(technique=args.technique),
            (args.technique,),
            fleet_shape=(n_half, len(platforms), len(scenario_names)),
            chunk_size=min(args.chunk, args.steps), device=args.device)
        print(f"# warmed fleet path: tables {t['tables_compile_s']:.2f}s"
              f", stream {t['stream_compile_s']:.2f}s")

    t0 = time.perf_counter()
    res = comp.search_fleet_composition(
        platforms, cand, scenario_names, budget,
        technique=args.technique, n_steps=args.steps,
        chunk_size=args.chunk, seed=args.seed, device=args.device)
    dt = time.perf_counter() - t0

    n = res.candidates.shape[0]
    print(f"# {n} candidates ({res.n_rejected} over budget) × "
          f"{len(res.platform_names)} platforms × "
          f"{len(res.scenario_names)} scenarios × {args.steps} steps "
          f"in {dt:.2f}s (device={args.device or 'cuda'})")
    built = _build.built()
    print("# kernels built in this process: "
          + (", ".join(f"{k} {v:.2f}s" for k, v in sorted(built.items()))
             if built else "none"))
    print(f"# traces={ctl.fleet_trace_counts()} — "
          f"second-half retraces: {res.retraces_second_half}\n")

    short = [p.split(":")[-1] for p in res.platform_names]
    for scen in res.scenario_names:
        idx = res.pareto[scen]
        print(f"== scenario: {scen} — Pareto set "
              f"({len(idx)} of {n} candidates) ==")
        print(f"{'mix (' + ','.join(short) + ')':24s} "
              f"{'power_w':>9s} {'qos_viol':>9s} {'served':>7s} "
              f"{'cost':>6s}")
        s = list(res.scenario_names).index(scen)
        for i in idx[:args.pareto_top]:
            mix = "×".join(str(int(x)) for x in res.candidates[i])
            print(f"{mix:24s} {res.total_power_w[i, s]:9.1f} "
                  f"{res.qos_violation_rate[i, s]:9.3f} "
                  f"{res.served_fraction[i, s]:7.3f} {res.cost[i]:6.1f}")
        if len(idx) > args.pareto_top:
            print(f"... {len(idx) - args.pareto_top} more")
        print()

    if args.json:
        out = {
            "platforms": list(res.platform_names),
            "scenarios": list(res.scenario_names),
            "candidates": res.candidates.tolist(),
            "cost": res.cost.tolist(),
            "nominal_power_w": res.nominal_power_w.tolist(),
            "total_power_w": res.total_power_w.tolist(),
            "qos_violation_rate": res.qos_violation_rate.tolist(),
            "served_fraction": res.served_fraction.tolist(),
            "pareto": {k: v.tolist() for k, v in res.pareto.items()},
            "retraces_second_half": res.retraces_second_half,
        }
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        print(f"# wrote {args.json}")

    if args.fail_on_retrace and res.retraces_second_half:
        print(f"ERROR: the second candidate half built "
              f"{res.retraces_second_half} fleet program(s) — the composition "
              "sweep is supposed to reuse the first half's")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
