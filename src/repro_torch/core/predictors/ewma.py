"""Exponentially weighted moving-average predictor, batched over ``[K]``.

Port of ``repro.core.predictors.ewma``: one smoothed level per cell,
``ℓ ← ℓ + α·(w − ℓ)``, whose bin is the forecast.  It pools all recent
history into one estimate, where the Markov chain conditions on an exact
1-of-M current bin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.predictors.base import (Predictor, PredictorConfig,
                                              register, workload_to_bin)


class EwmaInner(NamedTuple):
    level: torch.Tensor  # [K] float32 — smoothed workload fraction


class EwmaPredictor(Predictor):
    name = "ewma"

    def init_inner(self, cfg: PredictorConfig, k: int,
                   device: torch.device) -> EwmaInner:
        # Before any evidence, assume peak (matches warmup's nominal run).
        return EwmaInner(level=torch.ones(k, device=device))

    def predict_inner(self, cfg: PredictorConfig,
                      inner: EwmaInner) -> torch.Tensor:
        return workload_to_bin(inner.level, cfg.n_bins)

    def observe_inner(self, cfg: PredictorConfig, inner: EwmaInner,
                      w: torch.Tensor, actual_bin: torch.Tensor,
                      predicted_bin: torch.Tensor) -> EwmaInner:
        return EwmaInner(level=inner.level
                         + cfg.ewma_alpha * (w - inner.level))


register(EwmaPredictor())
