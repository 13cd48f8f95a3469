"""Predictor protocol, registry and the family-agnostic scoring shell.

Port of ``repro.core.predictors.base``, batched over a leading ``[K]``
axis of fleet cells: every state leaf carries ``[K, ...]`` and every
prediction is a ``[K]`` int64 bin (the JAX package's int32 bins, widened
because torch indexes with int64).

The shell handles what every family needs identically:

* **warmup** (§IV-A): for the first ``warmup_steps`` observations the
  platform runs at nominal frequency, encoded as predicting the top bin;
* **scoring**: exact-bin mispredictions and margin-aware misses
  (``actual > predicted + margin_bins``), post-warmup only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_POLICIES = ("argmax", "quantile", "expected")
_UPDATE_MODES = ("always", "threshold")


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """Static predictor configuration.

    ``kind`` names a registered family.  ``n_bins`` and ``margin_bins``
    are synced from the owning ``ControllerConfig``; family-specific
    fields are ignored by the other families.
    """

    n_bins: int = 10
    warmup_steps: int = 32
    kind: str = "markov"
    margin_bins: int = 1
    # --- markov ---
    policy: str = "argmax"
    quantile: float = 0.9
    mispred_threshold: int = 4
    update_mode: str = "always"
    count_decay: float = 1.0
    # --- ewma / hierarchy short window ---
    ewma_alpha: float = 0.35
    # --- holt_winters ---
    hw_alpha: float = 0.45
    hw_beta: float = 0.10
    hw_gamma: float = 0.25
    season: int = 0
    # --- hierarchy ---
    hier_scales: Tuple[int, ...] = (1, 4, 16, 64)
    hurst: float = 0.76

    def __post_init__(self):
        if _REGISTRY and self.kind not in _REGISTRY:
            raise ValueError(f"unknown predictor kind {self.kind!r}; "
                             f"registered: {available()}")
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"choose from {_POLICIES}")
        if self.update_mode not in _UPDATE_MODES:
            raise ValueError(f"unknown update_mode {self.update_mode!r}; "
                             f"choose from {_UPDATE_MODES}")
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(f"quantile {self.quantile} must be in (0, 1]")
        if not 0.0 < self.count_decay <= 1.0:
            raise ValueError(f"count_decay {self.count_decay} must be in "
                             "(0, 1]")
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps {self.warmup_steps} must be ≥ 0")
        if self.n_bins < 1:
            raise ValueError(f"n_bins {self.n_bins} must be ≥ 1")
        if self.margin_bins < 0:
            raise ValueError(f"margin_bins {self.margin_bins} must be ≥ 0")
        for name in ("ewma_alpha", "hw_alpha", "hw_beta", "hw_gamma"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} {v} must be in (0, 1]")
        if self.season < 0:
            raise ValueError(f"season {self.season} must be ≥ 0")
        scales = tuple(int(s) for s in self.hier_scales)
        if not scales or any(s < 1 for s in scales) or \
                list(scales) != sorted(set(scales)):
            raise ValueError(f"hier_scales {self.hier_scales} must be "
                             "strictly increasing positive ints")
        object.__setattr__(self, "hier_scales", scales)
        if not 0.5 <= self.hurst <= 1.0:
            raise ValueError(f"hurst {self.hurst} must be in [0.5, 1.0]")


class PredictorState(NamedTuple):
    """Family state ``inner`` plus the shared ``[K]`` int64 counters.

    ``mispredictions`` counts post-warmup exact-bin misses;
    ``margin_misses`` only those the controller's ``t%`` margin does not
    absorb (``actual > predicted + margin_bins``).
    """

    inner: Any
    steps: torch.Tensor
    mispredictions: torch.Tensor
    margin_misses: torch.Tensor


def workload_to_bin(w: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Discretize a workload fraction in [0, 1] into bin 0..M-1 (int64)."""
    return torch.clamp(torch.floor(w * n_bins).long(), 0, n_bins - 1)


def bin_upper_edge(b: torch.Tensor, n_bins: int) -> torch.Tensor:
    return (b.float() + 1.0) / n_bins


class Predictor:
    """One forecasting family: set ``name``, implement the three
    ``*_inner`` hooks over ``[K]``-batched state, and :func:`register` it."""

    name: str = ""

    def init_inner(self, cfg: PredictorConfig, k: int, device: torch.device):
        raise NotImplementedError

    def predict_inner(self, cfg: PredictorConfig, inner) -> torch.Tensor:
        """Raw next-bin prediction ``[K]`` (the shell clips to [0, M))."""
        raise NotImplementedError

    def observe_inner(self, cfg: PredictorConfig, inner, w: torch.Tensor,
                      actual_bin: torch.Tensor, predicted_bin: torch.Tensor):
        """Fold one observation (``w`` and its bin) into the family state."""
        raise NotImplementedError


_REGISTRY: Dict[str, Predictor] = {}


def register(predictor: Predictor, overwrite: bool = False) -> Predictor:
    if not predictor.name:
        raise ValueError("predictor must set a non-empty .name")
    if predictor.name in _REGISTRY and not overwrite:
        raise ValueError(f"predictor {predictor.name!r} already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[predictor.name] = predictor
    return predictor


def get(kind: str) -> Predictor:
    if kind not in _REGISTRY:
        raise KeyError(f"unknown predictor kind {kind!r}; "
                       f"registered: {available()}")
    return _REGISTRY[kind]


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def init_state(cfg: PredictorConfig, k: int,
               device: torch.device) -> PredictorState:
    """Fresh state for ``k`` independent cells."""
    zero = torch.zeros(k, dtype=torch.long, device=device)
    return PredictorState(inner=get(cfg.kind).init_inner(cfg, k, device),
                          steps=zero, mispredictions=zero, margin_misses=zero)


def predict(cfg: PredictorConfig, state: PredictorState) -> torch.Tensor:
    """Next step's bin per cell; the top bin during warmup (§IV-A)."""
    raw = torch.clamp(get(cfg.kind).predict_inner(cfg, state.inner).long(),
                      0, cfg.n_bins - 1)
    return torch.where(state.steps < cfg.warmup_steps, cfg.n_bins - 1, raw)


def observe(cfg: PredictorConfig, state: PredictorState, w: torch.Tensor,
            predicted_bin: torch.Tensor) -> PredictorState:
    """Fold one observed workload fraction per cell into the state and
    score it (warmup steps are not scored)."""
    actual = workload_to_bin(w, cfg.n_bins)
    scored = state.steps >= cfg.warmup_steps
    exact_miss = (predicted_bin != actual) & scored
    margin_miss = (actual > predicted_bin + cfg.margin_bins) & scored
    inner = get(cfg.kind).observe_inner(cfg, state.inner, w, actual,
                                        predicted_bin)
    return PredictorState(inner=inner, steps=state.steps + 1,
                          mispredictions=state.mispredictions + exact_miss,
                          margin_misses=state.margin_misses + margin_miss)


def forecast_fraction(cfg: PredictorConfig,
                      state: PredictorState) -> torch.Tensor:
    """Next step's forecast as a fraction in (0, 1]: the predicted bin's
    upper edge (the availability plane reads it as usable nodes)."""
    return bin_upper_edge(predict(cfg, state), cfg.n_bins)


class TraceEval(NamedTuple):
    """Whole-trace evaluation of one family (see :func:`evaluate_trace`):
    the bins predicted and observed at each step, the final one-cell
    state, and the post-warmup exact and margin-aware accuracies
    (float32 scalars)."""

    predicted: torch.Tensor        # [T] int64
    actual: torch.Tensor           # [T] int64
    final_state: PredictorState
    exact_accuracy: torch.Tensor
    margin_accuracy: torch.Tensor


def evaluate_trace(cfg: PredictorConfig, trace, device=None) -> TraceEval:
    """predict → bin → observe over a whole workload trace, one step at a
    time on a one-cell state on ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    w = torch.as_tensor(np.asarray(trace, np.float32), device=dev)
    state = init_state(cfg, 1, dev)
    preds, acts = [], []
    for t in range(w.shape[0]):
        p = predict(cfg, state)
        preds.append(p)
        acts.append(workload_to_bin(w[t:t + 1], cfg.n_bins))
        state = observe(cfg, state, w[t:t + 1], p)
    # As the JAX package's compiled scan computes ``1 − misses / n``: the
    # division by the static count as a multiplication by its float32
    # reciprocal (``scheduler.div_static``), fused with the subtraction
    # into one multiply-add (one rounding; exact here in float64).
    inv = float(np.float32(1.0)
                / np.float32(max(w.shape[0] - cfg.warmup_steps, 1)))

    def accuracy(misses: torch.Tensor) -> torch.Tensor:
        return (1.0 - misses[0].double() * inv).float()

    return TraceEval(
        predicted=torch.cat(preds), actual=torch.cat(acts),
        final_state=state,
        exact_accuracy=accuracy(state.mispredictions),
        margin_accuracy=accuracy(state.margin_misses))


class _PersistenceInner(NamedTuple):
    last_bin: torch.Tensor  # [K] int64


class PersistencePredictor(Predictor):
    """Last-value forecaster: the next step's bin is this step's."""

    name = "persistence"

    def init_inner(self, cfg, k, device) -> _PersistenceInner:
        # Before any evidence, assume peak (matches warmup's nominal run).
        return _PersistenceInner(last_bin=torch.full(
            (k,), cfg.n_bins - 1, dtype=torch.long, device=device))

    def predict_inner(self, cfg, inner: _PersistenceInner) -> torch.Tensor:
        return inner.last_bin

    def observe_inner(self, cfg, inner, w, actual_bin,
                      predicted_bin) -> _PersistenceInner:
        return _PersistenceInner(last_bin=actual_bin)


register(PersistencePredictor())
