"""Table II through the PyTorch / CUDA port: the five DNN accelerators on
the multi-FPGA platform under the bursty 40 %-load workload.

  PYTHONPATH=src python examples/multi_fpga_cluster_torch.py               # on the CUDA card
  PYTHONPATH=src python examples/multi_fpga_cluster_torch.py --device cpu  # plain PyTorch path

The same table as ``examples/multi_fpga_cluster.py``, computed by
``repro_torch``: the operating tables come from the grid-argmin CUDA
kernel on the card (its plain PyTorch version on the CPU) and the §V
control loop runs as ``[K]``-batched tensors on the chosen device.
Without a card and without ``--device cpu`` it exits with an error.
"""

import argparse

import numpy as np

from repro_torch.core import controller as ctl
from repro_torch.core import workload as wl
from repro_torch.core.accelerators import ACCELERATORS, PAPER_TABLE_II


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    ap.add_argument("--steps", type=int, default=2048)
    args = ap.parse_args(argv)

    cfg = wl.WorkloadConfig(n_steps=args.steps, mean_load=0.40, lam=1000.0,
                            hurst=0.76, idc=500.0, seed=0)
    trace = wl.generate_trace(cfg)
    print(f"workload: mean={trace.mean():.2f} of peak, Hurst≈0.76, "
          f"{len(trace)} control steps\n")

    header = (f"{'benchmark':11s} {'proposed':>9s} {'core-only':>10s} "
              f"{'bram-only':>10s} {'DFS':>6s} {'PG':>6s} {'hybrid':>8s}")
    print(header)
    print("-" * len(header))
    gains = {t: [] for t in ("proposed", "core_only", "bram_only", "hybrid")}
    platforms = [ctl.fpga_platform(acc) for acc in ACCELERATORS.values()]
    fleet = ctl.compare_all_batched(platforms, trace, device=args.device)
    for name, plat in zip(ACCELERATORS, platforms):
        res = fleet[plat.name]
        for t in gains:
            gains[t].append(res[t].power_gain)
        print(f"{name:11s} {res['proposed'].power_gain:8.2f}x "
              f"{res['core_only'].power_gain:9.2f}x "
              f"{res['bram_only'].power_gain:9.2f}x "
              f"{res['freq_only'].power_gain:5.2f}x "
              f"{res['power_gating'].power_gain:5.2f}x "
              f"{res['hybrid'].power_gain:7.2f}x")
    print("-" * len(header))
    print(f"{'average':11s} "
          f"{np.mean(gains['proposed']):8.2f}x "
          f"{np.mean(gains['core_only']):9.2f}x "
          f"{np.mean(gains['bram_only']):9.2f}x"
          f"   (paper: {PAPER_TABLE_II['proposed']['average']:.2f}x / "
          f"{PAPER_TABLE_II['core_only']['average']:.2f}x / "
          f"{PAPER_TABLE_II['bram_only']['average']:.2f}x)")
    best = max(np.mean(gains["core_only"]), np.mean(gains["bram_only"]))
    print(f"\nproposed vs best single-rail: "
          f"+{(np.mean(gains['proposed'])/best-1)*100:.1f}% "
          f"(paper: +33.6%)")
    print(f"hybrid (node-scaling + DVFS) average: {np.mean(gains['hybrid']):.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
