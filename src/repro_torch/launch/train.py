"""End-to-end training driver on one device.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
      --steps 200 --batch 8 --seq 128                           # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 8 --batch 4 --seq 2048

Wires the training path together: config → model init (float32 masters,
seeded) → ``SyntheticPipeline`` → ``make_train_step`` (loss,
microbatching, AdamW) → ``CheckpointManager`` (``--ckpt-dir``: resumes
from the newest committed step, saves every ``--ckpt-every``).  The flags
and printed lines are those of ``repro.launch.train`` plus ``--device``.

One device: the reference's host mesh and sharding rules
(``launch/mesh.py``, ``parallel/sharding.py``) are not ported.  A run
whose training state (float32 parameters and gradients, both AdamW
moments) does not fit the device's memory is refused before any weights
are drawn — ``--full`` llama3-405b (405 B parameters) among them, and
``--full`` falcon-mamba-7b on one 80 GB card (112 GB of state by
``count_params``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig, count_params
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.step import make_train_step


def train_state_bytes(cfg: ModelConfig) -> int:
    """Bytes of float32 parameters and gradients and both moments."""
    n = count_params(cfg)
    return n * (4 + 4 + 2 * torch.finfo(getattr(torch, cfg.moment_dtype)).bits // 8)


def refusal(cfg: ModelConfig, dev: torch.device) -> Optional[str]:
    """Why ``cfg`` cannot train on ``dev``, or None."""
    if dev.type == "cuda":
        memory = torch.cuda.get_device_properties(dev).total_memory
    else:
        memory = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    need = train_state_bytes(cfg)
    if need > memory:
        return (f"--arch {cfg.name}: the training state ({count_params(cfg):,} parameters, "
                f"{need / 1e9:.1f} GB with gradients and moments) does not fit one {dev.type} "
                f"device ({memory / 1e9:.1f} GB); sharding across devices is not ported")
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card, or an error without "
                         "one) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    why = refusal(cfg, dev)
    if why is not None:
        raise SystemExit(f"launch.train: {why}")
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=args.lr, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 10, 1)),
        microbatch=args.microbatch)

    layout = transformer.model_layout(cfg)
    params = common.init_params(torch.Generator(device=dev).manual_seed(0), layout)
    opt_state = adamw_init(params, cfg.moment_dtype)
    step_fn = make_train_step(cfg, tcfg)
    pipe = SyntheticPipeline(DataConfig(global_batch=args.batch, seq_len=args.seq,
                                        vocab_size=cfg.vocab_size), cfg)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    start = 0
    if ckpt is not None:
        restored = ckpt.restore_latest((params, opt_state))
        if restored is not None:
            (params, opt_state), start = restored
            print(f"restored checkpoint at step {start}")

    t0 = time.time()
    losses = []
    for i, batch in zip(range(start, args.steps), pipe):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            print(f"step {i+1:5d} loss={losses[-1]:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms/step", flush=True)
            t0 = time.time()
        if ckpt is not None and (i + 1) % args.ckpt_every == 0:
            ckpt.save((params, opt_state), step=i + 1)
    pipe.close()
    if ckpt is not None:
        ckpt.wait()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"loss {first:.4f} → {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
