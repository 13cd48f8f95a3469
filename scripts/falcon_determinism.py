#!/usr/bin/env python3
"""Is a bf16 training step bit-stable on one card?

  python3 scripts/falcon_determinism.py [--steps 8] [--archs falcon-mamba-7b,llama3.2-1b]
                                        [--out DIR]

For each arch — ``chip_smoke.py`` phase 18g's falcon-mamba-7b (full width
cut to 8 layers) and phase 18b's full-width llama3.2-1b: float32 masters,
bf16 activations, remat, B = 4, S = 2048, lr 3e-4 with a 2-step warmup,
seed 0, the same ``SyntheticPipeline`` batches — it computes the
gradients of the first batch twice at the initial parameters and names
every leaf whose two gradients differ, then trains ``--steps`` steps twice
and prints both runs' losses and the state leaves that differ.  It does
this in two child processes: one as the phases run (the default
settings), one under ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts, where an op
without a deterministic implementation raises and is named.  Ends with
one JSON line of the results (also written to
``DIR/falcon_determinism.json`` with ``--out``).  Builds the kernels from
this checkout; needs a CUDA device.
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
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

LAYERS = {"falcon-mamba-7b": 8}      # phase 18g's depth cut


def _setup(arch: str, steps: int):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.models import common, transformer
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    if arch in LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LAYERS[arch])
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=3e-4, warmup_steps=2,
                                                 total_steps=steps))
    params = common.init_params(torch.Generator(device="cuda").manual_seed(0),
                                transformer.model_layout(cfg))
    return cfg, tcfg, params, adamw_init(params, cfg.moment_dtype)


def _batches(cfg, n: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    pipe = SyntheticPipeline(DataConfig(global_batch=4, seq_len=2048,
                                        vocab_size=cfg.vocab_size), cfg)
    out = [next(pipe) for _ in range(n)]
    pipe.close()
    return out


def _differ(a: dict, b: dict) -> dict:
    out = {}
    for key, x in a.items():
        y = b[key]
        if not torch.equal(x, y):
            d = (x.double() - y.double()).abs()
            out[key] = {"elements": int((d > 0).sum()), "of": x.numel(),
                        "max_abs": float(d.max())}
    return out


def _host(prefix: str, tree) -> dict:
    from repro_torch.models import common
    return {f"{prefix}/{p}": x.detach().float().cpu() for p, x in common.tree_leaves(tree)}


def one_arch(arch: str, steps: int) -> dict:
    from repro_torch.train import make_grad_fn, make_train_step

    cfg, tcfg, params, opt = _setup(arch, steps)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in _batches(cfg, steps)]
    grad_fn = make_grad_fn(cfg, tcfg)
    grads = []
    for _ in range(2):
        _, _, g = grad_fn(params, batches[0])
        grads.append(_host("grad", g))
        del g
    grad_differ, n_grad = _differ(*grads), len(grads[0])
    del grads
    runs = []
    for _ in range(2):
        cfg, tcfg, params, opt = _setup(arch, steps)
        step_fn, losses, t0 = make_train_step(cfg, tcfg), [], time.perf_counter()
        for batch in batches:
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(metrics["loss"].item())
        runs.append({"losses": losses, "seconds": time.perf_counter() - t0,
                     "state": {**_host("params", params), **_host("m", opt.m),
                               **_host("v", opt.v)}})
        del params, opt
        torch.cuda.empty_cache()
    state_differ = _differ(runs[0]["state"], runs[1]["state"])
    return {"grad_leaves": n_grad,
            "grad_differ": grad_differ, "losses": [r["losses"] for r in runs],
            "seconds": [r["seconds"] for r in runs], "state_leaves": len(runs[0]["state"]),
            "state_differ": state_differ}


def child(archs, steps: int, deterministic: bool, path: str) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.py phase 1 sets
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        torch.use_deterministic_algorithms(True)
    out = {}
    for arch in archs:
        try:
            out[arch] = one_arch(arch, steps)
        except RuntimeError as e:          # an op without a deterministic implementation
            out[arch] = {"error": str(e).splitlines()[0][:500]}
        torch.cuda.empty_cache()
    with open(path, "w") as fh:
        json.dump(out, fh)
    return 0


def _report(mode: str, res: dict) -> None:
    for arch, r in res.items():
        if "error" in r:
            print(f"[{mode}] {arch}: raises: {r['error']}")
            continue
        print(f"[{mode}] {arch}: the first batch's gradients twice: "
              f"{r['grad_leaves'] - len(r['grad_differ'])} of {r['grad_leaves']} leaves "
              f"bit-equal; differ: {sorted(r['grad_differ'])[:12]}")
        for key, d in sorted(r["grad_differ"].items())[:12]:
            print(f"[{mode}]   {key}: {d}")
        print(f"[{mode}] {arch}: run 1 losses {r['losses'][0]} ({r['seconds'][0]:.2f} s)")
        print(f"[{mode}] {arch}: run 2 losses {r['losses'][1]} ({r['seconds'][1]:.2f} s)")
        print(f"[{mode}] {arch}: losses equal {r['losses'][0] == r['losses'][1]}; "
              f"{r['state_leaves'] - len(r['state_differ'])} of {r['state_leaves']} state "
              f"leaves bit-equal")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--archs", default="falcon-mamba-7b,llama3.2-1b")
    ap.add_argument("--out", default="")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--deterministic", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = [a for a in args.archs.split(",") if a]
    if args.child:
        return child(archs, args.steps, args.deterministic, args.child)
    if not torch.cuda.is_available():
        print("falcon_determinism: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    result = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("default", "deterministic"):
            path = os.path.join(tmp, f"{mode}.json")
            env = dict(os.environ)
            cmd = [sys.executable, os.path.abspath(__file__), "--steps", str(args.steps),
                   "--archs", args.archs, "--child", path]
            if mode == "deterministic":
                env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
                cmd.append("--deterministic")
            proc = subprocess.run(cmd, env=env)
            if proc.returncode != 0:
                print(f"falcon_determinism: the {mode} child exited {proc.returncode}",
                      file=sys.stderr)
                return 1
            with open(path) as fh:
                result[mode] = json.load(fh)
            _report(mode, result[mode])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "falcon_determinism.json"), "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({mode: {arch: {"equal": r.get("losses", [0, 1])[0] == r.get("losses", [0, 1])[1],
                                    "grad_leaves_differ": len(r.get("grad_differ", {})),
                                    "error": r.get("error")}
                             for arch, r in result[mode].items()}
                      for mode in ("default", "deterministic")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
