"""PLL reprogramming overhead (paper §V, Eqs. 4-5) — the part the fleet
path reads: the PLL configuration and the capacity a single PLL's lock
stall costs each step.  Port of ``repro.core.pll``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PllConfig:
    t_lock: float = 10e-6       # seconds (typical; ≤ 100 µs worst case)
    p_pll: float = 0.1          # W per PLL
    p_design: float = 20.0      # W — fully utilized FPGA (paper §V)
    dual: bool = True


def stall_fraction(cfg: PllConfig, tau: float) -> float:
    """Capacity lost to clock stabilization (zero with dual PLLs)."""
    return 0.0 if cfg.dual else min(cfg.t_lock / tau, 1.0)
