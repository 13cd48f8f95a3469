"""Serve a model with the paper's DVFS controller in the loop, through the
PyTorch / CUDA port.

  PYTHONPATH=src python examples/serve_dvfs_torch.py               # on the CUDA card
  PYTHONPATH=src python examples/serve_dvfs_torch.py --device cpu  # plain PyTorch path

The twin of ``examples/serve_dvfs.py``: generates real tokens with the
serving engine (full-width llama3.2-1b on the card, the reduced model on
the CPU; weights from a seed), drives the §V controller over a bursty
request trace for the proposed technique and its baselines, closes the
loop through the continuous batcher for three techniques, and sweeps the
measured per-τ demand, blended with a diurnal floor, through a campaign.
Without a card and without ``--device cpu`` it exits with an error.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import controller as ctl
from repro_torch.core import predictors as pred_mod
from repro_torch.core import scenarios as scn
from repro_torch.core import traces
from repro_torch.core import workload as wl
from repro_torch.core.accelerators import ACCELERATORS
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.serving.autoscale import (DvfsServingSimulator, RooflineTerms,
                                           compare_techniques)
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama3.2-1b", reduced=dev.type == "cpu")
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    engine = ServeEngine(cfg=cfg, params=params, capacity=48, batch_size=4,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    toks = engine.generate(prompts, 16)
    print(f"[engine] generated {toks.shape[1]} tokens x {toks.shape[0]} seqs "
          f"(d_model {cfg.d_model}, {cfg.n_layers} layers, {dev.type}); "
          f"sample: {toks[0, :8].tolist()}")

    # decode-shaped roofline terms (memory-bound — the usual serving case)
    terms = RooflineTerms(t_compute=0.002, t_memory=0.012,
                          t_collective=0.001)
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=1024, mean_load=0.4,
                                                seed=7))
    print(f"[load] bursty trace: mean={trace.mean():.2f} "
          f"max={trace.max():.2f} (Hurst 0.76)")
    results = compare_techniques(terms, trace, device=dev)
    print(f"{'technique':14s} {'power_gain':>10s} {'qos_viol':>9s} "
          f"{'served':>7s}")
    for tech, s in results.items():
        print(f"{tech:14s} {s.power_gain:9.2f}x {s.qos_violation_rate:9.3f} "
              f"{s.served_fraction:7.3f}")

    # closed loop: the controller's f_rel throttles the continuous batcher,
    # so occupancy and request latency respond to the DVFS decisions
    lam = np.concatenate([np.full(512, 0.6), np.full(512, 2.2),
                          np.full(512, 1.0)])
    out = sim = None
    for tech in ("proposed", "hybrid", "nominal"):
        ccfg = ctl.ControllerConfig(
            technique=tech, n_nodes=8,
            predictor=pred_mod.PredictorConfig(warmup_steps=4))
        sim = DvfsServingSimulator(terms=terms, steps_per_tau=32,
                                   controller_cfg=ccfg, device=dev)
        out = sim.run_request_load(lam, batch_size=32, mean_new_tokens=12,
                                   workload_signal="demand")
        s = out["summary"]
        print(f"[closed-loop/{tech:8s}] completed={out['completed']}, "
              f"power_gain={s.power_gain:.2f}x, "
              f"qos_violations={s.qos_violation_rate:.3f}, "
              f"occ={out['occupancy_tau'].mean():.2f}, "
              f"latency p50={s.latency_p50:.0f} p99={s.latency_p99:.0f} "
              f"steps")

    # request-driven mixture: the measured per-τ demand becomes a
    # replayable trace source, blended with a diurnal floor and swept
    # through the fleet path
    src = sim.workload_trace_source(out, name="serving_demand")
    div = float(np.abs(out["workload_tau"]
                       - out["arrival_fraction_tau"]).mean())
    print(f"[mixture] measured workload source: {src.n_samples} τ samples, "
          f"mean={src.utilization.mean():.2f} "
          f"(diverges from the synthetic arrival fraction by {div:.2f})")
    scn.register_replay(src, name="replay_serving_demand", overwrite=True)
    mixed = scn.register_scenario(scn.Scenario(
        "serving_mix", "measured serving demand blended with a diurnal "
        "floor", traces.mix([src, "diurnal"], [0.7, 0.3])), overwrite=True)
    plat = ctl.fpga_platform(ACCELERATORS["tabla"])
    table = scn.run_campaign([plat], techniques=("proposed", "hybrid"),
                             scenario_names=("replay_serving_demand",
                                             mixed.name),
                             n_steps=2048, chunk_size=512,
                             device=dev)["table"]
    for scen, cell in table[plat.name]["proposed"].items():
        print(f"[mixture] {scen:22s} gain={cell['power_gain']:.2f}x "
              f"qos_viol={cell['qos_violation_rate']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
