"""PLL reprogramming overhead model (paper §V, Eqs. 4-5).  Port of
``repro.core.pll``.

A PLL's output is unreliable after reprogramming until its *lock* signal
re-asserts (≤ 100 µs).  With a single PLL the platform stalls for
``t_lock`` every time step; with two PLLs (one generating the current
clock while the shadow one is reprogrammed, muxed at the step boundary)
there is no stall, at the cost of a second PLL's standing power.

Break-even (Eq. 5, with t_lock ≪ τ):   P_design · t_lock > P_PLL · τ.
With the paper's practical numbers (P_design ≈ 20 W, P_PLL ≈ 0.1 W,
t_lock ≈ 10 µs) the break-even sits at τ ≈ 2 ms: dual-PLL is the more
*energy*-efficient choice for τ **below** it, because the wasted
P_design·t_lock lock energy is amortized over a shorter step, while for
larger τ the second always-on PLL's standing energy dominates.  The
paper nevertheless deploys dual-PLL at its seconds-to-minutes τ
(Fig. 9c): Eq. 5 compares pure energies and ignores that the single-PLL
stall also costs *capacity* (QoS) every step — a trade the deployment
values separately (see ``stall_fraction``, the part the fleet path reads).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PllConfig:
    t_lock: float = 10e-6       # seconds (typical; ≤ 100 µs worst case)
    p_pll: float = 0.1          # W per PLL
    p_design: float = 20.0      # W — fully utilized FPGA (paper §V)
    dual: bool = True


def energy_overhead_single(cfg: PllConfig, tau: float) -> float:
    """Eq. 4: design energy wasted during lock + single PLL energy."""
    return cfg.p_design * cfg.t_lock + cfg.p_pll * (tau + cfg.t_lock)


def energy_overhead_dual(cfg: PllConfig, tau: float) -> float:
    """Two PLLs running for the whole step; no stall."""
    return 2.0 * cfg.p_pll * tau


def energy_overhead(cfg: PllConfig, tau: float) -> float:
    return energy_overhead_dual(cfg, tau) if cfg.dual else \
        energy_overhead_single(cfg, tau)


def stall_fraction(cfg: PllConfig, tau: float) -> float:
    """Capacity lost to clock stabilization (zero with dual PLLs)."""
    return 0.0 if cfg.dual else min(cfg.t_lock / tau, 1.0)


def breakeven_tau(cfg: PllConfig) -> float:
    """τ *below* which dual-PLL is more energy-efficient (Eq. 5)."""
    # dual wins iff  2·P_PLL·τ < P_design·t_lock + P_PLL·(τ + t_lock)
    #   ⇔ τ < (P_design + P_PLL)·t_lock / P_PLL
    return (cfg.p_design + cfg.p_pll) * cfg.t_lock / cfg.p_pll


def should_use_dual(cfg: PllConfig, tau: float) -> bool:
    """True iff dual-PLL is the more *energy*-efficient choice at τ (Eq. 5).

    That is τ < :func:`breakeven_tau`: the second always-on PLL's
    standing energy grows with τ while the single-PLL lock waste does
    not, so dual wins energy-wise only below the break-even.  The paper's
    deployment still uses dual-PLL at seconds-to-minutes τ (Fig. 9c,
    ``PllConfig.dual`` defaults True) because the single-PLL stall also
    costs per-step *capacity* — a QoS consideration outside Eq. 5's pure
    energy comparison.
    """
    return tau < breakeven_tau(cfg)
