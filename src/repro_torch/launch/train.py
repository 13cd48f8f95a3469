"""End-to-end training driver on a mesh of ranks.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
      --steps 200 --batch 8 --seq 128                           # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 8 --batch 4 --seq 2048
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train --full

Wires the training path together: process group and host mesh
(``make_host_mesh``: all ranks of ``torchrun`` on ("data", "model") =
(ranks, 1), or one rank for a plain run) → ``default_rules(mesh,
fsdp=cfg.fsdp)`` → model init (float32 masters, the same seeded draw on
every rank, each keeping its shard) → ``SyntheticPipeline`` (each rank's
rows of the global batch) → ``make_train_step`` (loss, microbatching,
the data-group reductions, AdamW) → ``CheckpointManager`` (``--ckpt-dir``:
resumes from the newest committed step onto this mesh, saves every
``--ckpt-every``, gathered to rank 0).  Rank 0 prints the lines of
``repro.launch.train``; the flags are its flags plus ``--device``.

A run is refused before any weights are drawn when one rank's share of
the training state (float32 parameters and gradients, both AdamW moments;
a leaf the rules shard over ``data`` counts 1/data of its bytes) does
not fit the device, and when the ranks' rows would split an MoE routing
group of the global batch (that would route a different model).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig, count_params
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common, transformer
from repro_torch.models.common import ParamDef
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.step import make_train_step

MAX_DATA_RANKS = 1 << 16   # the widest data axis refusal() tries


def train_state_bytes(cfg: ModelConfig) -> int:
    """Bytes of float32 parameters and gradients and both moments."""
    n = count_params(cfg)
    return n * (4 + 4 + 2 * torch.finfo(getattr(torch, cfg.moment_dtype)).bits // 8)


def rank_share(cfg: ModelConfig, rules: Optional[shd.ShardingRules] = None) -> float:
    """The share of the layout's elements one rank holds under ``rules``:
    a leaf whose spec splits it over mesh axes counts 1/(their sizes)."""
    held = total = 0
    for _, d in common.tree_leaves(transformer.model_layout(cfg)):
        n = int(np.prod(d.shape, dtype=np.int64))
        total += n
        if rules is None or rules.mesh is None:
            held += n
            continue
        split = 1
        for entry in rules.resolve(d.axes, d.shape):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= rules.mesh_axis_size(a)
        held += n // split
    return held / total


def ranks_to_fit(cfg: ModelConfig, memory: int) -> Optional[int]:
    """The fewest data-parallel ranks (a power of two) whose per-rank
    state fits ``memory`` under ``default_rules(fsdp=cfg.fsdp)``, or None."""
    need, d = train_state_bytes(cfg), 1
    while d <= MAX_DATA_RANKS:
        rules = shd.default_rules(shd.ShapeMesh({"data": d, "model": 1}), fsdp=cfg.fsdp)
        if need * rank_share(cfg, rules) <= memory:
            return d
        d *= 2
    return None


def refusal(cfg: ModelConfig, dev: torch.device,
            rules: Optional[shd.ShardingRules] = None) -> Optional[str]:
    """Why ``cfg`` cannot train on ``dev`` as one rank under ``rules``
    (None: one device, every leaf whole), or None."""
    if dev.type == "cuda":
        memory = torch.cuda.get_device_properties(dev).total_memory
    else:
        memory = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    need = train_state_bytes(cfg)
    per_rank = need * rank_share(cfg, rules)
    if per_rank <= memory:
        return None
    ranks = 1 if rules is None or rules.mesh is None else rules.mesh_axis_size("data")
    fit = ranks_to_fit(cfg, memory)
    hint = (f"it would fit as one of {fit} data-parallel ranks (FSDP)" if fit is not None
            else "no number of data-parallel ranks fits it: fsdp is off, so every rank "
                 "holds it whole")
    return (f"--arch {cfg.name}: the training state ({count_params(cfg):,} parameters, "
            f"{need / 1e9:.1f} GB with gradients and moments) does not fit one {dev.type} "
            f"device ({memory / 1e9:.1f} GB): one of {ranks} rank(s) holds "
            f"{per_rank / 1e9:.1f} GB; {hint}")


def split_refusal(cfg: ModelConfig, batch: int, seq: int, n_ranks: int,
                  microbatch: int = 0) -> Optional[str]:
    """Why ``batch`` rows cannot split over ``n_ranks`` data ranks (with
    ``microbatch``) as the one-process step would see them, or None."""
    n = max(microbatch, 1)
    if batch % (n * n_ranks):
        return (f"--batch {batch} does not split into {n} microbatch(es) of whole rows on "
                f"each of {n_ranks} data rank(s)")
    if cfg.moe is not None and n_ranks > 1:
        tokens = batch // n * seq                      # of one global microbatch
        group = min(cfg.moe.group_size, tokens)
        if (tokens // n_ranks) % group:
            return (f"--arch {cfg.name}: a rank's {tokens // n_ranks} tokens a microbatch are "
                    f"not a whole number of the global batch's {group}-token routing groups; "
                    f"the split would route a different model")
    return None


def state_layout(layout: Any) -> tuple:
    """The layout of ``(params, opt_state)``, leaf for leaf."""
    return (layout, AdamWState(step=ParamDef((), ()), m=layout, v=layout))


def state_shardings(layout: Any, rules: shd.ShardingRules) -> tuple:
    """A ``NamedSharding`` per leaf of ``(params, opt_state)`` on the
    rules' mesh (the step count whole)."""
    named = shd.named_shardings(layout, rules)
    return (named, AdamWState(step=shd.NamedSharding(rules.mesh, ()), m=named, v=named))


def init_state(cfg: ModelConfig, rules: shd.ShardingRules, dev: torch.device, seed: int = 0):
    """Seeded float32 masters and zero moments, this rank's shards: every
    rank draws the same leaves and keeps its piece of each as it goes."""
    layout = transformer.model_layout(cfg)
    named = dict(common.tree_leaves(shd.named_shardings(layout, rules)))
    params = common.init_params(torch.Generator(device=dev).manual_seed(seed), layout,
                                keep=lambda path, x: named[path].shard(x))
    return params, adamw_init(params, cfg.moment_dtype)


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
                    help="'cuda' (the default: the card, this rank's under torchrun, or an "
                         "error without one) or 'cpu' (the plain path, gloo between ranks)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    owned = mesh_mod.init_group(dev)
    try:
        return _train(args, dev)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, dev: torch.device) -> int:
    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = mesh_mod.make_host_mesh()
    dev = mesh_mod.mesh_device(mesh)
    rules = shd.default_rules(mesh, fsdp=cfg.fsdp)
    n_data, rank = mesh.size(0), mesh.get_local_rank("data")
    why = (refusal(cfg, dev, rules)
           or split_refusal(cfg, args.batch, args.seq, n_data, args.microbatch))
    if why is not None:
        raise SystemExit(f"launch.train: {why}")
    lead = dist.get_rank() == 0
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=args.lr, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 10, 1)),
        microbatch=args.microbatch)

    layout = transformer.model_layout(cfg)
    shardings = state_shardings(layout, rules)
    with shd.use_rules(rules):
        params, opt_state = init_state(cfg, rules, dev)
        step_fn = make_train_step(cfg, tcfg)
        pipe = SyntheticPipeline(DataConfig(global_batch=args.batch, seq_len=args.seq,
                                            vocab_size=cfg.vocab_size), cfg,
                                 rank=rank, n_ranks=n_data, microbatch=args.microbatch)
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

        start = 0
        if ckpt is not None:
            restored = ckpt.restore_latest((params, opt_state), shardings)
            if restored is not None:
                (params, opt_state), start = restored
                if lead:
                    print(f"restored checkpoint at step {start}")

        t0 = time.time()
        losses = []
        for i, batch in zip(range(start, args.steps), pipe):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (i + 1) % args.log_every == 0:
                dt = (time.time() - t0) / args.log_every
                if lead:
                    print(f"step {i+1:5d} loss={losses[-1]:.4f} "
                          f"grad_norm={float(metrics['grad_norm']):.3f} "
                          f"{dt*1e3:.0f} ms/step", flush=True)
                t0 = time.time()
            if ckpt is not None and (i + 1) % args.ckpt_every == 0:
                ckpt.save((params, opt_state), step=i + 1, shardings=shardings)
        pipe.close()
        if ckpt is not None:
            ckpt.wait()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    if lead:
        print(f"loss {first:.4f} → {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
