"""Hurst-aware multi-scale EWMA hierarchy (long memory), over ``[K]``.

Port of ``repro.core.predictors.hierarchy``.  A bank of EWMAs at the
spans ``hier_scales`` (α_j = 2/(scale_j + 1)) is blended with weights
from the long-memory autocorrelation: ``ω_j ∝ scale_j^(2H−2)``, and
``g = clip(2H − 1, 0, 1)`` between the fastest level and the weighted
combination.  ``ω``, ``g`` and the α's are computed in float64 on the
host and enter as float32 constants, as the JAX package folds them into
its compiled program.  :func:`config_for_trace` measures ``H`` with the
port's ``core.workload.estimate_hurst``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import workload
from repro_torch.core.predictors.base import (Predictor, PredictorConfig,
                                              register, workload_to_bin)


class HierarchyInner(NamedTuple):
    levels: torch.Tensor  # [K, J] float32 — EWMA bank, fastest scale first


def _weights(cfg: PredictorConfig) -> Tuple[Tuple[float, ...], float]:
    """(per-scale weights ω[J], blend g) as float64 host constants."""
    scales = np.asarray(cfg.hier_scales, np.float64)
    omega = scales ** (2.0 * cfg.hurst - 2.0)
    omega = omega / omega.sum()
    g = float(np.clip(2.0 * cfg.hurst - 1.0, 0.0, 1.0))
    return tuple(float(x) for x in omega), g


@functools.lru_cache(maxsize=None)
def _alphas(scales: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """α_j = 2/(scale_j + 1) as a float32 ``[J]`` tensor on ``device``, made
    once, so the step loop copies nothing to the device."""
    return torch.tensor([2.0 / (s + 1.0) for s in scales], dtype=torch.float32,
                        device=device)


class HierarchyPredictor(Predictor):
    name = "hierarchy"

    def init_inner(self, cfg: PredictorConfig, k: int,
                   device: torch.device) -> HierarchyInner:
        # Assume peak at every scale before any evidence.
        return HierarchyInner(levels=torch.ones((k, len(cfg.hier_scales)),
                                                device=device))

    def predict_inner(self, cfg: PredictorConfig,
                      inner: HierarchyInner) -> torch.Tensor:
        omega, g = _weights(cfg)
        # Σ ω·levels left to right, each product and sum rounded to float32.
        long_mem = omega[0] * inner.levels[:, 0]
        for j in range(1, len(omega)):
            long_mem = long_mem + omega[j] * inner.levels[:, j]
        yhat = (1.0 - g) * inner.levels[:, 0] + g * long_mem
        return workload_to_bin(yhat, cfg.n_bins)

    def observe_inner(self, cfg: PredictorConfig, inner: HierarchyInner,
                      w: torch.Tensor, actual_bin: torch.Tensor,
                      predicted_bin: torch.Tensor) -> HierarchyInner:
        alphas = _alphas(cfg.hier_scales, inner.levels.device)
        return HierarchyInner(levels=inner.levels
                              + alphas * (w[:, None] - inner.levels))


register(HierarchyPredictor())


def config_for_trace(cfg: PredictorConfig, trace,
                     min_block: int = 8) -> PredictorConfig:
    """``cfg`` with ``hurst`` measured from a concrete trace (clipped to
    [0.5, 1]); a trace too short to estimate (NaN) keeps the default."""
    h = workload.estimate_hurst(np.asarray(trace, np.float64),
                                min_block=min_block)
    if not np.isfinite(h):
        return cfg
    return dataclasses.replace(cfg, hurst=float(np.clip(h, 0.5, 1.0)))
