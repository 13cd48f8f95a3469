#!/usr/bin/env python3
"""The multi-device path across the cards of one machine.

  python3 scripts/multi_card.py [--out DIR]            # a machine with N >= 2 cards
  python3 scripts/multi_card.py --cpu --ranks 4        # the same at REDUCED size, gloo
  python3 scripts/multi_card.py --parts fleet          # only the named parts
  python3 scripts/multi_card.py --parts witness        # one card is enough

Four parts, each its own process (the script starts them in turn; the
first three by default):

1. ``one``: on one card (a one-rank NCCL group), ``launch.train``'s
   functions (``make_host_mesh``, ``default_rules``, ``init_state``, the
   step under ``use_rules``) train full-width llama3.2-1b for 8 steps at
   S = 2048: in float32 at B = 4 (the reference), and in bf16 at B = 4
   (phase 18b's step, for its time);
2. ``ranks``: the same under ``torchrun --nproc-per-node N``: float32 at
   B = 4 with ``fsdp`` off and forced on, held against part 1 with phase
   18's float32 tolerances (the first 2 steps' metrics 1e-5 relative, as
   phase 18 holds 2 steps, every step's reported; params after 8 steps
   1e-5·(1 + |x|) at all but 0.1 % of a leaf's elements and 2·lr a step
   everywhere), and
   bf16 at B = 4·N (B = 4 a rank) with ``fsdp`` off and on: ms a step,
   tokens a second, peak memory, collective calls a step;
3. ``fleet``: the default campaign (``launch.campaign``'s arguments at
   2048 steps) split over two cards (with more than two) and over every
   card (``fleet_mesh()``) against the same campaign on one card
   (``shard=False``; ``shard=True`` runs the same): wall times (the second
   of two runs; the first, which builds each device's stream program, is
   reported as ``cold``), every cell
   within 1e-5, miss rates and Pareto fronts equal
   (``chip_smoke._compare_campaigns``);
4. ``witness``: on one card, part 1's float32 run against the same run
   with ``microbatch=4`` (one row a microbatch, so the gradient is a sum of
   4 partial sums, as 4 ranks sum it): every step's worst metric
   difference and the params' after 8 steps, reported and not held.  It
   shows how far a change of the summation order alone moves the run, the
   yardstick for part 2's drift after step 2.

Prints each part's lines and ends with one JSON line of the results
(also ``DIR/multi_card.json`` with ``--out``).  ``--cpu`` runs parts 1
and 2 on the CPU at REDUCED size (S = 64) under gloo and skips part 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

STEPS, LR = 8, 3e-4
ROWS = 4                  # float32 global batch, and the bf16 rows a rank


def _train(dtype: str, fsdp: bool, batch: int, seq: int, cpu: bool, microbatch: int = 0
           ) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.checkpoint import tree_flatten
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=cpu), dtype=dtype, fsdp=fsdp)
    mesh = mesh_mod.make_host_mesh()
    dev = mesh_mod.mesh_device(mesh)
    rules = shd.default_rules(mesh, fsdp=cfg.fsdp)
    n, rank = mesh.size(0), mesh.get_local_rank("data")
    why = (tlaunch.refusal(cfg, dev, rules)
           or tlaunch.split_refusal(cfg, batch, seq, n, microbatch))
    if why:
        raise SystemExit(why)
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=LR, warmup_steps=2,
                                                 total_steps=STEPS), microbatch=microbatch)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with shd.use_rules(rules):
        params, opt = tlaunch.init_state(cfg, rules, dev)
        step_fn = make_train_step(cfg, tcfg)
        pipe = SyntheticPipeline(DataConfig(batch, seq, cfg.vocab_size), cfg, rank=rank,
                                 n_ranks=n)
        batches = [next(pipe) for _ in range(STEPS)]
        pipe.close()
        shd.collective_calls.update(dict.fromkeys(shd.collective_calls, 0))
        times, metrics = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, {k: torch.from_numpy(v).to(dev)
                                                   for k, v in b.items()})
            metrics.append({k: v.item() for k, v in m.items()})
            times.append(time.perf_counter() - t0)
        calls = {k: v // STEPS for k, v in shd.collective_calls.items()}
    whole = None
    if dtype == "float32":             # the params the comparison reads
        named = tlaunch.state_shardings(transformer.model_layout(cfg), rules)[0]
        whole = [sh.gather(x).cpu() for x, sh in zip(tree_flatten(params), tree_flatten(named))]
    out = {"metrics": metrics, "ms": float(np.median(times[1:])) * 1e3,
           "peak": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0,
           "calls": calls, "ranks": n, "batch": batch,
           "params": whole if dist.get_rank() == 0 else None}
    del params, opt
    return out


def part(name: str, path: str, cpu: bool) -> int:
    from repro_torch.launch import mesh as mesh_mod

    seq = 64 if cpu else 2048
    owned = mesh_mod.init_group("cpu" if cpu else None)
    try:
        n = dist.get_world_size()
        runs = {}
        if name == "one":
            runs["float32"] = _train("float32", False, ROWS, seq, cpu)
            runs["bf16"] = _train("bfloat16", False, ROWS, seq, cpu)
        elif name == "witness":
            runs["float32"] = _train("float32", False, ROWS, seq, cpu)
            runs["float32 microbatch"] = _train("float32", False, ROWS, seq, cpu, ROWS)
        else:
            for fsdp in (False, True):
                runs[f"float32 fsdp={fsdp}"] = _train("float32", fsdp, ROWS, seq, cpu)
                runs[f"bf16 fsdp={fsdp}"] = _train("bfloat16", fsdp, ROWS * n, seq, cpu)
        if dist.get_rank() == 0:
            torch.save(runs, path)
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


def fleet(path: str) -> int:
    import chip_smoke
    from repro_torch.core import scenarios as scn
    from repro_torch.launch import campaign as cli
    from repro_torch.parallel import sharding as shd

    mesh = shd.fleet_mesh()
    if mesh is None:
        raise SystemExit("part fleet needs two or more cards")
    cli.main(["--steps", "64", "--platforms", "tabla"])    # builds and loads the kernel first
    out, splits = {}, [("one card", False)]
    if len(mesh.devices) > 2:
        splits.append(("2 cards", shd.fleet_mesh(devices=mesh.devices[:2])))
    splits.append((f"{len(mesh.devices)} cards", mesh))
    for name, shard in splits:
        walls = []
        for _ in range(2):      # the first run builds each device's stream program
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = scn.run_campaign(cli.build_platforms("all"), scenario_names=None,
                                   techniques=("proposed", "power_gating", "hybrid"),
                                   n_steps=chip_smoke.CAMPAIGN_CLI_STEPS, seed=0,
                                   chunk_size=1024, n_nodes=8, predictor="markov",
                                   tenants=None, scheduler="none", headroom_frac=0.5,
                                   shard=shard)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"wall": walls[1], "cold": walls[0], "result": json.loads(json.dumps(res))}
    one = out.pop("one card")
    worst = max(chip_smoke._compare_campaigns(v["result"], one["result"], f"fleet over {k}")
                for k, v in out.items())
    with open(path, "w") as fh:
        json.dump({"one card": one["wall"]} | {k: v["wall"] for k, v in out.items()}
                  | {f"{k} cold": v["cold"] for k, v in (("one card", one), *out.items())}
                  | {"worst_rel": worst, "cards": len(mesh.devices)}, fh)
    return 0


def _hold(got: dict, want: dict, label: str, enforce: bool = True) -> dict:
    """Phase 18's float32 rule: the metrics of the first 2 steps (the
    steps phase 18 holds) within 1e-5 relative, the params after all the
    steps within 1e-5·(1 + |x|) at all but 0.1 % of a leaf's elements and
    2·lr a step everywhere; each step's worst metric difference reported.
    ``enforce=False`` only reports."""
    per_step = []
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        worst = {k: abs(a[k] - v) / max(abs(v), 1e-30) for k, v in b.items()
                 if not (k == "accuracy" and a[k] == v)}
        per_step.append(max(worst.values(), default=0.0))
        if enforce and i < 2 and per_step[-1] > 1e-5:
            raise AssertionError(f"{label}: step {i + 1} metrics {worst}")
    bound, off_total, worst_p = 2 * LR * STEPS, 0, 0.0
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        diff = (a.double() - b.double()).abs()
        off = int((diff > 1e-5 * (1 + b.double().abs())).sum())
        if enforce and (off > max(2, 1e-3 * diff.numel()) or diff.max().item() > bound):
            raise AssertionError(f"{label}: leaf {i}: {off} elements past 1e-5, "
                                 f"max|Δ| {diff.max().item()}")
        off_total, worst_p = off_total + off, max(worst_p, diff.max().item())
    return {"metrics_worst_rel_by_step": per_step, "params_max_abs": worst_p,
            "params_past_1e-5": off_total}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of part 2 (default: every card)")
    ap.add_argument("--parts", default="one,ranks,fleet",
                    help="comma-separated parts to run: one, ranks, fleet, witness")
    ap.add_argument("--part", default="", help=argparse.SUPPRESS)
    ap.add_argument("--path", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.part == "fleet":
        return fleet(args.path)
    if args.part:
        return part(args.part, args.path, args.cpu)
    parts = args.parts.split(",")
    if not set(parts) <= {"one", "ranks", "fleet", "witness"}:
        ap.error(f"unknown part in {args.parts!r}")
    if args.cpu:
        parts = [x for x in parts if x != "fleet"]
    if not args.cpu and parts != ["witness"] and torch.cuda.device_count() < 2:
        print("multi_card: needs two or more cards (or --cpu)", file=sys.stderr)
        return 2
    if "ranks" in parts and "one" not in parts:
        ap.error("part ranks is held against part one")
    n = args.ranks or (4 if args.cpu else torch.cuda.device_count())
    me = os.path.abspath(__file__)
    flag = ["--cpu"] if args.cpu else []
    env = dict(os.environ, OMP_NUM_THREADS="1") if args.cpu else dict(os.environ)
    result = {}
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        result["device"] = sorted(set(smi.strip().splitlines()))
        print(f"[device] {result['device']} x{torch.cuda.device_count()} | torch "
              f"{torch.__version__}", flush=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name in ("one", "ranks", "witness", "fleet"):
            if name not in parts:
                continue
            path = os.path.join(tmp, name)
            cmd = [sys.executable, me, "--part", name, "--path", path] + flag
            if name == "ranks":
                cmd[1:2] = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                            str(n), me]
            subprocess.run(cmd, env=env, check=True)
            if name == "fleet":
                with open(path) as fh:
                    result["fleet"] = json.load(fh)
            else:
                runs[name] = torch.load(path)
        result["seconds"] = time.perf_counter() - t0
    seq = 64 if args.cpu else 2048
    labels = {"one": "1 rank", "ranks": f"{n} ranks", "witness": "1 rank (witness)"}
    for key, group in runs.items():
        for name, run in group.items():
            name = f"{labels[key]} {name}"
            tokens = run["batch"] * seq
            print(f"[train] llama3.2-1b {name}, B={run['batch']} ({run['batch'] // run['ranks']} "
                  f"a rank): {run['ms']:.1f} ms a step, {tokens / run['ms'] * 1e3:.0f} tokens/s, "
                  f"peak {run['peak'] / 2**30:.2f} GiB a rank, collective calls a step "
                  f"{run['calls']}; losses " + " ".join(f"{m['loss']:.6f}" for m in run["metrics"]))
            result[name] = {k: run[k] for k in ("ms", "peak", "calls", "ranks", "batch")}
            result[name]["losses"] = [m["loss"] for m in run["metrics"]]
    if "ranks" in runs:
        for fsdp in (False, True):
            held = _hold(runs["ranks"][f"float32 fsdp={fsdp}"], runs["one"]["float32"],
                         f"{n} ranks float32 fsdp={fsdp}")
            result[f"float32 fsdp={fsdp} vs 1 rank"] = held
            print(f"[train] {n} ranks float32 fsdp={fsdp} against 1 rank: {held} (tols: steps "
                  f"1-2 metrics 1e-5 relative, params 1e-5·(1+|x|) at all but 0.1 %, "
                  f"{2 * LR * STEPS:g} everywhere)")
    if "witness" in runs:
        w = runs["witness"]
        drift = _hold(w["float32 microbatch"], w["float32"], "witness", enforce=False)
        result["float32 microbatch=4 vs plain, 1 rank"] = drift
        print(f"[train] witness: 1 rank float32 microbatch={ROWS} against 1 rank plain "
              f"(the summation order alone): {drift}")
    if "fleet" in result:
        f = result["fleet"]
        walls = ", ".join(f"{k} {v:.2f} s (cold {f[k + ' cold']:.2f} s)" for k, v in f.items()
                          if k.endswith((" card", " cards")))
        print(f"[fleet] the default campaign at 2048 steps, warm: {walls}; every cell within 1e-5 "
              f"(worst rel {f['worst_rel']:.3g}), miss rates and Pareto fronts equal")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "multi_card.json"), "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
