"""Periodic-bias predictor (paper §IV-A, first paragraph), over ``[K]``.

Port of ``repro.core.predictors.periodic``: for a known period, the
forecast of the upcoming step is the mean workload of its phase over the
periods seen so far (the paper's "bias"), and 1.0 (nominal) until that
phase has been seen once.  The period is a call-site argument, so this is
a standalone state machine, not a registered family.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PeriodicState(NamedTuple):
    phase_sum: torch.Tensor    # [K, P] float32 running sum per phase
    phase_count: torch.Tensor  # [K, P] float32
    step: torch.Tensor         # [K] int64


def init_periodic(period: int, k: int, device: torch.device) -> PeriodicState:
    return PeriodicState(phase_sum=torch.zeros((k, period), device=device),
                         phase_count=torch.zeros((k, period), device=device),
                         step=torch.zeros(k, dtype=torch.long, device=device))


def periodic_predict(state: PeriodicState, period: int) -> torch.Tensor:
    """``[K]`` mean of the upcoming phase (``step % period``) over the
    previous periods; 1.0 until a full period has been seen."""
    phase = (state.step % period)[:, None]
    cnt = state.phase_count.gather(1, phase)[:, 0]
    mean = state.phase_sum.gather(1, phase)[:, 0] / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, mean, 1.0)


def periodic_observe(state: PeriodicState, w: torch.Tensor,
                     period: int) -> PeriodicState:
    phase = (state.step % period)[:, None]
    return PeriodicState(
        phase_sum=state.phase_sum.scatter_add(1, phase, w[:, None]),
        phase_count=state.phase_count.scatter_add(
            1, phase, torch.ones_like(w)[:, None]),
        step=state.step + 1)
