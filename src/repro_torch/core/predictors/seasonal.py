"""Seasonal-naive forecaster with an EWMA-envelope fallback, over ``[K]``.

Port of ``repro.core.predictors.seasonal``: once a full season has been
seen, the forecast is the bin observed one season ago minus the
controller's ``margin_bins`` (on a replayed, tiled trace that value is
exact, so the margin is pure headroom); before that, or with
``season == 0``, it is the bin of the upper envelope
``max(EWMA level, last w)``.  The exact-phase forecast is −1 wherever
that phase's workload lies below ``margin_bins / M``; the shared shell
clips it to bin 0, as the JAX package's shell does, so no negative bin
ever reaches a table gather.

:func:`detect_period` finds an exact tiling period on the host (numpy,
float64), and :func:`config_for_trace` sets ``season`` from it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.predictors.base import (Predictor, PredictorConfig,
                                              register, workload_to_bin)


class SeasonalInner(NamedTuple):
    ring: torch.Tensor   # [K, max(season, 1)] float32 — last w per phase
    level: torch.Tensor  # [K] float32 — EWMA half of the fallback envelope
    last: torch.Tensor   # [K] float32 — last observed w (naive half)
    step: torch.Tensor   # [K] int64 — observations so far


class SeasonalNaivePredictor(Predictor):
    name = "seasonal_naive"

    def init_inner(self, cfg: PredictorConfig, k: int,
                   device: torch.device) -> SeasonalInner:
        return SeasonalInner(
            ring=torch.ones((k, max(cfg.season, 1)), device=device),
            level=torch.ones(k, device=device),
            last=torch.ones(k, device=device),
            step=torch.zeros(k, dtype=torch.long, device=device))

    def predict_inner(self, cfg: PredictorConfig,
                      inner: SeasonalInner) -> torch.Tensor:
        fallback = workload_to_bin(torch.maximum(inner.level, inner.last),
                                   cfg.n_bins)
        if cfg.season == 0:
            return fallback
        phase = (inner.step % cfg.season)[:, None]
        exact = (workload_to_bin(inner.ring.gather(1, phase)[:, 0],
                                 cfg.n_bins) - cfg.margin_bins)
        return torch.where(inner.step >= cfg.season, exact, fallback)

    def observe_inner(self, cfg: PredictorConfig, inner: SeasonalInner,
                      w: torch.Tensor, actual_bin: torch.Tensor,
                      predicted_bin: torch.Tensor) -> SeasonalInner:
        level = inner.level + cfg.ewma_alpha * (w - inner.level)
        ring = inner.ring
        if cfg.season > 0:
            ring = ring.scatter(1, (inner.step % cfg.season)[:, None],
                                w[:, None])
        return SeasonalInner(ring=ring, level=level, last=w,
                             step=inner.step + 1)


register(SeasonalNaivePredictor())


def detect_period(trace, min_period: int = 8, tol: float = 1e-6) -> int:
    """Smallest exact tiling period of ``trace``, or 0 if none: every
    sample matches the one a period earlier within ``tol``, with at least
    a quarter period of repeats past the first occurrence."""
    w = np.asarray(trace, np.float64)
    n = len(w)
    for p in range(min_period, (4 * n) // 5 + 1):
        if n - p < max(p // 4, 1):
            break
        if np.abs(w[p:] - w[:-p]).max() <= tol:
            return p
    return 0


def config_for_trace(cfg: PredictorConfig, trace, min_period: int = 8,
                     tol: float = 1e-6) -> PredictorConfig:
    """``cfg`` with ``season`` set to the trace's exact tiling period (0,
    the envelope fallback alone, when the trace does not tile)."""
    return dataclasses.replace(
        cfg, season=detect_period(trace, min_period=min_period, tol=tol))
