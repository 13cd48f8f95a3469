"""Serving launcher: real generation + the paper's DVFS controller.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced      # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu      # plain path
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --no-reduced

Generates tokens with a real model (``--arch``, one of
``configs.ARCH_NAMES``; ``--reduced``, the default, or the full-width
``--no-reduced``) whose weights come from a seeded generator (the MoE
models at full depth, 235 B and 236 B parameters, do not fit one card:
run them REDUCED), then runs the §V controller over a bursty trace and
reports the power gain vs an uncontrolled fleet and the QoS stats.  An
encoder-only arch (hubert-xlarge) has no decode step and is refused before
any weights are drawn.  The flags are those of ``repro.launch.serve`` plus
``--device``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.core import workload as wl
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.serving.autoscale import DvfsServingSimulator, RooflineTerms
from repro_torch.serving.engine import ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--technique", default="proposed")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card, or an error without "
                         "one) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    ok, why = shape_applicable(cfg, SHAPES["decode_32k"])
    if not ok:
        raise SystemExit(f"launch.serve: --arch {args.arch}: {why}")
    layout = transformer.model_layout(cfg)
    params = common.init_params(torch.Generator(device=dev).manual_seed(0), layout)
    engine = ServeEngine(cfg=cfg, params=params,
                         capacity=args.prompt_len + args.new_tokens,
                         batch_size=args.batch, device=dev)

    # real generation for one batch (proves the engine path end to end)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    toks = engine.generate(prompts, args.new_tokens)
    print(f"generated {tuple(toks.shape)} tokens; sample: {toks[0, :8].tolist()}")

    # DVFS controller over a bursty load (modeled power; roofline terms
    # default to a decode-shaped chip profile)
    terms = RooflineTerms(t_compute=0.002, t_memory=0.012, t_collective=0.001)
    sim = DvfsServingSimulator(terms=terms, technique=args.technique, device=dev)
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=512, seed=3))
    s = sim.run_trace(trace)
    print(f"technique={s.technique} power_gain={s.power_gain:.2f}x "
          f"qos_violations={s.qos_violation_rate:.3f} "
          f"served={s.served_fraction:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
