"""Scenario campaigns on the streaming fleet path, through the PyTorch / CUDA
port.

  PYTHONPATH=src python examples/scenario_campaign_torch.py               # on the CUDA card
  PYTHONPATH=src python examples/scenario_campaign_torch.py --device cpu  # plain PyTorch path

The twin of ``examples/scenario_campaign.py``: the full named-scenario
library over the paper's five accelerators (one table a scenario row, the
mean gain of each technique and the proposed technique's QoS violations),
the ``node_failure`` cell priced against the available fleet, a
100,000-step stream of the ``multi_tenant`` trace, and the bundled
Azure-style day replayed to the same length.  The operating tables come
from the grid-argmin kernel on the card (its plain version on the CPU).

The "compiled chunk programs" and "stream retraces" lines count what the
JAX example's count: the port builds one stream program per key (fleet
shape, chunk, tenant width, config), as JAX compiles one chunk program
per jit key, and ``controller.fleet_trace_counts()`` counts them; on the
card each is a captured CUDA graph of the control step, on the CPU the
same step run eagerly.  The replayed trace has the synthetic one's shape,
so it builds none.  ``--steps`` (campaign steps, default 2048) and
``--stream-steps`` (default 100,000) shrink a run.
"""

import argparse
import time

import numpy as np

from repro_torch.core import characterization as char
from repro_torch.core import controller as ctl
from repro_torch.core import scenarios as scn
from repro_torch.core import traces
from repro_torch.core.accelerators import ACCELERATORS
from repro_torch.device import resolve_device

TECHNIQUES = ("proposed", "power_gating", "hybrid")


def campaign_rows(out, platforms, techniques=TECHNIQUES):
    """scenario → (mean power gain of each technique over the platforms,
    mean QoS violation rate of ``proposed``): the lines of the table."""
    rows = {}
    for scen in out["scenarios"]:
        gains = {t: float(np.mean([out["table"][p.name][t][scen]["power_gain"]
                                   for p in platforms])) for t in techniques}
        qos = float(np.mean([out["table"][p.name]["proposed"][scen]["qos_violation_rate"]
                             for p in platforms]))
        rows[scen] = (gains, qos)
    return rows


def run_table(n_steps: int, device):
    platforms = [ctl.fpga_platform(acc) for acc in ACCELERATORS.values()]
    out = scn.run_campaign(platforms, techniques=TECHNIQUES, n_steps=n_steps,
                           chunk_size=1024, device=device)
    return platforms, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=2048, help="campaign steps")
    ap.add_argument("--stream-steps", type=int, default=100_000,
                    help="steps of the streamed and the replayed trace")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    platforms, out = run_table(args.steps, dev)
    print(f"{'scenario':22s} " + " ".join(f"{t:>14s}" for t in TECHNIQUES)
          + f" {'qos(prop)':>10s}")
    print("-" * 80)
    for scen, (gains, qos) in campaign_rows(out, platforms).items():
        print(f"{scen:22s} " + " ".join(f"{gains[t]:13.2f}x" for t in TECHNIQUES)
              + f" {qos:10.3f}")

    # --- faithful node failures: dead nodes draw 0 W and are unprovisioned,
    # so power_gain is priced against the available fleet
    cell = out["table"][platforms[0].name]["proposed"]["node_failure"]
    print(f"\nnode_failure on {platforms[0].name} (proposed): "
          f"mean usable nodes {cell['mean_avail_nodes']:.2f}/8, "
          f"gain {cell['power_gain']:.2f}x vs available fleet "
          f"({cell['power_gain_vs_configured']:.2f}x vs configured), "
          f"qos_viol {cell['qos_violation_rate']:.3f}")

    # --- streaming a long trace
    n_steps = args.stream_steps
    cfg = ctl.ControllerConfig()
    params = char.stack_platform_params([platforms[0].params])
    tables = ctl.fleet_bin_tables(params, cfg, ("proposed", "hybrid"), device=dev)
    trace = scn.get_scenario("multi_tenant").trace(n_steps, seed=0)
    t0 = time.perf_counter()
    fs = ctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=8192, device=dev)
    dt = time.perf_counter() - t0
    nominal = ctl.fleet_nominal_watts(params, cfg)[0]
    print(f"\nstreamed {n_steps:,} steps × {fs.mean_power_w.size} cells "
          f"in {dt:.2f}s ({dt / n_steps * 1e6:.2f} µs/step)")
    for j, tech in enumerate(("proposed", "hybrid")):
        print(f"  {tech:9s} gain={nominal / fs.mean_power_w[0, j]:.2f}x "
              f"served={fs.served_fraction[0, j]:.4f} "
              f"qos_viol={fs.qos_violation_rate[0, j]:.3f}")
    print(f"  compiled chunk programs (stream traces): "
          f"{ctl.fleet_trace_counts()['stream']}")

    # --- replaying a recorded trace: the bundled Azure-style day resampled
    # to the controller's τ and tiled to the same length
    azure = traces.load_bundled("azure_vm_cpu")
    replayed = azure.replay(n_steps, tau_s=60.0)
    before = ctl.fleet_trace_counts()["stream"]
    fs = ctl.simulate_fleet_stream(tables, replayed, cfg, chunk_size=8192, device=dev)
    print(f"\nreplayed {azure.name} ({azure.n_samples} samples @ "
          f"{azure.interval_s:g}s → {n_steps:,} steps @ 60s): "
          f"gain={nominal / fs.mean_power_w[0, 0]:.2f}x "
          f"qos_viol={fs.qos_violation_rate[0, 0]:.3f} "
          f"(stream retraces: "
          f"{ctl.fleet_trace_counts()['stream'] - before})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
