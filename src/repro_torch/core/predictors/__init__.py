"""Workload predictors of the port (paper §IV-A, §V), batched over ``[K]``
fleet cells: the shared predict/observe shell, its name registry and the
six families of the JAX package —

* ``markov`` — the paper's online transition-count chain (argmax /
  quantile / expected policies, threshold re-learning);
* ``persistence`` — last-bin baseline (the default availability
  forecaster);
* ``ewma`` — single exponentially smoothed level;
* ``holt_winters`` — level + trend + optional additive season;
* ``hierarchy`` — Hurst-weighted multi-scale EWMA bank;
* ``seasonal_naive`` — replay-exact seasonal ring with an EWMA fallback;

plus the standalone ``periodic`` helpers.  ``PredictorConfig(kind=...)``
selects a family everywhere (``ControllerConfig``, ``run_campaign``,
``python -m repro_torch.launch.campaign --predictor``); every family runs
through the one control step.
"""

# Base first (it holds the registry), then the families, each of which
# registers itself on import.
from repro_torch.core.predictors.base import (  # noqa: F401
    Predictor,
    PredictorConfig,
    PredictorState,
    PersistencePredictor,
    TraceEval,
    available,
    bin_upper_edge,
    evaluate_trace,
    forecast_fraction,
    get,
    init_state,
    observe,
    predict,
    register,
    workload_to_bin,
)
from repro_torch.core.predictors.markov import (  # noqa: F401
    MarkovPredictor,
    transition_matrix,
)
from repro_torch.core.predictors.ewma import EwmaPredictor  # noqa: F401
from repro_torch.core.predictors.holt_winters import (  # noqa: F401
    HoltWintersPredictor,
)
from repro_torch.core.predictors.hierarchy import (  # noqa: F401
    HierarchyPredictor,
    config_for_trace,
)
from repro_torch.core.predictors.seasonal import (  # noqa: F401
    SeasonalNaivePredictor,
    detect_period,
)
from repro_torch.core.predictors.periodic import (  # noqa: F401
    PeriodicState,
    init_periodic,
    periodic_observe,
    periodic_predict,
)

__all__ = [
    "Predictor",
    "PredictorConfig",
    "PredictorState",
    "PersistencePredictor",
    "MarkovPredictor",
    "EwmaPredictor",
    "HoltWintersPredictor",
    "HierarchyPredictor",
    "SeasonalNaivePredictor",
    "TraceEval",
    "detect_period",
    "available",
    "bin_upper_edge",
    "config_for_trace",
    "evaluate_trace",
    "forecast_fraction",
    "get",
    "init_state",
    "observe",
    "predict",
    "register",
    "transition_matrix",
    "workload_to_bin",
    "PeriodicState",
    "init_periodic",
    "periodic_observe",
    "periodic_predict",
]
