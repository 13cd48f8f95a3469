"""DVFS-integrated serving autoscaler — the paper's controller driving a
serving fleet (port of ``repro.serving.autoscale``, the trace-driven part).

Per control interval τ the simulator counts offered load, predicts the
next τ's load with the Markov chain, picks the frequency level for the
predicted bin plus the margin, and looks up the jointly optimal
(V_core, V_hbm) for it in the operating table built from the model's
roofline terms; it integrates modeled chip power and tracks QoS.  The
baselines (power gating, core-only, hbm-only, DFS, hybrid) share the loop,
exactly as in :mod:`repro_torch.core.controller`.

``run_request_load`` (the closed loop through a continuous batcher) and
``serving/batching.py`` are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import controller as ctl


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Seconds per step from the compiled dry-run (analysis.roofline)."""
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def alpha_tpu(self) -> float:
        """Memory-vs-compute share — the paper's α transplanted."""
        return self.t_memory / max(self.t_compute, 1e-12)


@dataclasses.dataclass
class DvfsServingSimulator:
    """Serving simulation with the paper's controller.

    ``device`` follows the port's rule and is resolved when a run starts:
    ``None`` is the CUDA card (and raises without one), ``"cpu"`` the
    plain path.
    """

    terms: RooflineTerms
    technique: str = "proposed"
    n_chips: int = 8
    steps_per_tau: int = 32
    controller_cfg: Optional[ctl.ControllerConfig] = None
    watts_nominal: float = 200.0
    device: Optional[str] = None

    def __post_init__(self):
        self.platform = ctl.tpu_platform(
            self.terms.t_compute, self.terms.t_memory,
            self.terms.t_collective, watts_nominal=self.watts_nominal)
        self.cfg = self.controller_cfg or ctl.ControllerConfig(
            technique=self.technique, n_nodes=self.n_chips)

    def run_trace(self, occupancy_trace: np.ndarray) -> ctl.Summary:
        """Run the §V loop over a per-τ occupancy trace."""
        res = ctl.simulate(self.platform, self.cfg, occupancy_trace,
                           device=self.device)
        return ctl.summarize(self.platform, self.cfg, occupancy_trace, res)


def compare_techniques(terms: RooflineTerms, trace: np.ndarray,
                       n_chips: int = 8,
                       techniques=("proposed", "core_only", "bram_only",
                                   "freq_only", "power_gating", "hybrid"),
                       device=None) -> Dict[str, ctl.Summary]:
    """Paper Table II on the serving platform (modeled power), through the
    fused fleet path: one table sweep and one step loop for all
    techniques."""
    platform = ctl.tpu_platform(terms.t_compute, terms.t_memory,
                                terms.t_collective)
    out = ctl.compare_all_batched([platform], trace, techniques=techniques,
                                  n_nodes=n_chips, device=device)
    return out[platform.name]
