"""Learning-rate schedules (port of ``repro.optim.schedule``).

The JAX package computes the schedule in float32 (x64 is off); so does
this one, on float32 tensors, so that the two give the same rate to the
last bit where the operations round alike.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def make_schedule(cfg: OptimizerConfig):
    """``lr(step)``: linear warmup, then constant or a cosine decay to 10 %
    of the peak.  ``step`` is an int tensor (or int); the rate is a float32
    scalar tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
        if cfg.schedule == "constant":
            return cfg.learning_rate * warm
        t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * t))
        return cfg.learning_rate * warm * (0.1 + 0.9 * cos)

    return lr
