"""Holt-Winters (additive) predictor — level, trend, season — over ``[K]``.

Port of ``repro.core.predictors.holt_winters``.  The forecast is
``ŷ = ℓ + b + s[phase]``, binned (and clipped) by the shared shell.  With
``season > 0`` an additive ring of per-phase offsets is learned, read at
``phase = step % season``; with ``season == 0`` the one-entry ring is
never read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.predictors.base import (Predictor, PredictorConfig,
                                              register, workload_to_bin)


class HoltWintersInner(NamedTuple):
    level: torch.Tensor   # [K] float32 — smoothed level ℓ
    trend: torch.Tensor   # [K] float32 — smoothed one-step trend b
    season: torch.Tensor  # [K, max(season, 1)] float32 — per-phase offsets
    step: torch.Tensor    # [K] int64 — completed observations


def _phase(cfg: PredictorConfig, step: torch.Tensor) -> torch.Tensor:
    """The upcoming step's ring slot as a ``[K, 1]`` index."""
    return (step % cfg.season)[:, None]


class HoltWintersPredictor(Predictor):
    name = "holt_winters"

    def init_inner(self, cfg: PredictorConfig, k: int,
                   device: torch.device) -> HoltWintersInner:
        return HoltWintersInner(
            level=torch.ones(k, device=device),    # assume peak pre-evidence
            trend=torch.zeros(k, device=device),
            season=torch.zeros((k, max(cfg.season, 1)), device=device),
            step=torch.zeros(k, dtype=torch.long, device=device))

    def predict_inner(self, cfg: PredictorConfig,
                      inner: HoltWintersInner) -> torch.Tensor:
        yhat = inner.level + inner.trend
        if cfg.season > 0:
            yhat = yhat + inner.season.gather(1, _phase(cfg, inner.step))[:, 0]
        return workload_to_bin(yhat, cfg.n_bins)

    def observe_inner(self, cfg: PredictorConfig, inner: HoltWintersInner,
                      w: torch.Tensor, actual_bin: torch.Tensor,
                      predicted_bin: torch.Tensor) -> HoltWintersInner:
        a, b, g = cfg.hw_alpha, cfg.hw_beta, cfg.hw_gamma
        if cfg.season > 0:
            phase = _phase(cfg, inner.step)
            s = inner.season.gather(1, phase)[:, 0]
            level = a * (w - s) + (1.0 - a) * (inner.level + inner.trend)
            season = inner.season.scatter(
                1, phase, (g * (w - level) + (1.0 - g) * s)[:, None])
        else:
            level = a * w + (1.0 - a) * (inner.level + inner.trend)
            season = inner.season
        trend = b * (level - inner.level) + (1.0 - b) * inner.trend
        return HoltWintersInner(level=level, trend=trend, season=season,
                                step=inner.step + 1)


register(HoltWintersPredictor())
