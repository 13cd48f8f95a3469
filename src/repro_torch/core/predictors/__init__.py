"""Workload predictors of the port (paper §IV-A, §V): the shared shell
plus the two families the §V fleet path runs — ``markov`` (the default
workload forecaster) and ``persistence`` (the default availability
forecaster).  Every state is batched over ``[K]`` fleet cells."""

from repro_torch.core.predictors.base import (  # noqa: F401
    Predictor,
    PredictorConfig,
    PredictorState,
    PersistencePredictor,
    available,
    bin_upper_edge,
    forecast_fraction,
    get,
    init_state,
    observe,
    predict,
    register,
    workload_to_bin,
)
from repro_torch.core.predictors.markov import MarkovPredictor  # noqa: F401

__all__ = [
    "Predictor",
    "PredictorConfig",
    "PredictorState",
    "PersistencePredictor",
    "MarkovPredictor",
    "available",
    "bin_upper_edge",
    "forecast_fraction",
    "get",
    "init_state",
    "observe",
    "predict",
    "register",
    "workload_to_bin",
]
