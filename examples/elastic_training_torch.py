"""Fault-tolerant training through the PyTorch / CUDA port: checkpoint /
restart with injected node failures, and straggler-aware work
rebalancing.

  PYTHONPATH=src python examples/elastic_training_torch.py               # on the CUDA card
  PYTHONPATH=src python examples/elastic_training_torch.py --device cpu  # plain PyTorch path

The twin of ``examples/elastic_training.py``: the same printed lines.
Without a card and without ``--device cpu`` it exits with an error.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import FaultInjector, run_with_restarts
from repro_torch.runtime.straggler import StragglerMitigator
from repro_torch.train.step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (the plain path)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("llama3.2-1b", reduced=True)
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=1e-3, total_steps=60,
                                                 warmup_steps=5))
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, tcfg)
    pipe = SyntheticPipeline(DataConfig(global_batch=8, seq_len=64,
                                        vocab_size=cfg.vocab_size), cfg)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
               for _ in range(60)]
    pipe.close()
    losses = []

    def train_one(state, step):
        p, o = state
        p, o, m = step_fn(p, o, batches[step % len(batches)])
        losses.append(float(m["loss"]))
        return (p, o)

    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d)
        injector = FaultInjector(fail_at={17: 2, 41: 7})
        out = run_with_restarts(train_one, (params, opt), n_steps=60, ckpt=ckpt,
                                ckpt_every=10, injector=injector)
    print(f"[fault] completed {out['steps']} steps with "
          f"{out['restarts']} node failures + restarts")
    print(f"[fault] loss {losses[0]:.3f} → {np.mean(losses[-5:]):.3f}")

    # straggler mitigation: node 5 slows down; shares rebalance
    mit = StragglerMitigator(n_nodes=8, granularity=2)
    rng = np.random.default_rng(0)
    for step in range(12):
        times = 1.0 + 0.05 * rng.standard_normal(8)
        if step >= 4:
            times[5] *= 1.8          # node 5 degrades
        mit.observe(times)
    shares = mit.shares(64)
    print(f"[straggler] batch shares after degradation: {shares} "
          f"(node 5 gets {shares[5]})")
    print(f"[straggler] evictions flagged: {mit.evictions()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
