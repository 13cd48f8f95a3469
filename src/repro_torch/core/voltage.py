"""Joint (V_core, V_bram) optimization under a delay constraint (§III, §V).

Port of the array-parameterized half of ``repro.core.voltage``: the
shared voltage grids, technique masks over the one full grid, the masked
argmin every sweep path shares, and the per-bin frequency levels.  The
sweep functions broadcast: ``PlatformParams`` leaves ``[*Lp, terms]``
against frequency levels ``[*Lf]`` give ``[*broadcast(Lp, Lf)]`` points,
which is how the plain grid-argmin version sweeps a whole fleet at once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import characterization as char


class OperatingPoint(NamedTuple):
    """One solution of the constrained minimization (fields broadcast)."""

    v_core: torch.Tensor    # selected core-rail voltage (V)
    v_bram: torch.Tensor    # selected bram/hbm-rail voltage (V)
    f_rel: torch.Tensor     # relative frequency in (0, 1]
    power: torch.Tensor     # modeled power at the point (arbitrary units)
    feasible: torch.Tensor  # bool — False iff no grid point met timing


@dataclasses.dataclass(frozen=True)
class VoltageGrids:
    """Discretized rail set-points (25 mV DC-DC resolution by default).

    Both grids ascend and end at the nominal voltage, so ``[-1]`` is the
    nominal corner every technique mask keeps.
    """

    core: torch.Tensor
    bram: torch.Tensor

    @staticmethod
    def default(step: float = char.V_STEP,
                core_rail: char.Rail = char.CORE_RAIL,
                bram_rail: char.Rail = char.BRAM_RAIL) -> "VoltageGrids":
        return VoltageGrids(core=core_rail.grid(step), bram=bram_rail.grid(step))

    @staticmethod
    def core_only(step: float = char.V_STEP) -> "VoltageGrids":
        """Only V_core scales; V_bram pinned at nominal."""
        return VoltageGrids(core=char.CORE_RAIL.grid(step),
                            bram=char._f32([char.V_BRAM_NOM]))

    @staticmethod
    def bram_only(step: float = char.V_STEP) -> "VoltageGrids":
        """Only V_bram scales; V_core pinned at nominal."""
        return VoltageGrids(core=char._f32([char.V_CORE_NOM]),
                            bram=char.BRAM_RAIL.grid(step))

    @staticmethod
    def frequency_only() -> "VoltageGrids":
        """DFS baseline: both rails pinned at nominal."""
        return VoltageGrids(core=char._f32([char.V_CORE_NOM]),
                            bram=char._f32([char.V_BRAM_NOM]))

    def to(self, device) -> "VoltageGrids":
        return VoltageGrids(core=self.core.to(device), bram=self.bram.to(device))


def masked_grid_argmin(power: torch.Tensor, feasible: torch.Tensor,
                       core_grid: torch.Tensor, bram_grid: torch.Tensor,
                       f_rel: torch.Tensor,
                       fallback_power: torch.Tensor) -> OperatingPoint:
    """Select the minimum-power feasible grid point over the last two axes.

    ``power``/``feasible`` are ``[..., C, B]``.  Ties break toward the
    lowest row-major flat index (``torch.argmin`` keeps the first
    minimum), as in the JAX package.  When nothing is feasible the point
    falls back to nominal rails at ``fallback_power``.
    """
    masked = torch.where(feasible, power, torch.inf).flatten(-2)
    idx = masked.argmin(-1)
    n_b = bram_grid.shape[0]
    any_f = feasible.flatten(-2).any(-1)
    p = torch.where(any_f, masked.gather(-1, idx[..., None])[..., 0],
                    fallback_power)
    return OperatingPoint(
        v_core=torch.where(any_f, core_grid[idx // n_b], core_grid[-1]),
        v_bram=torch.where(any_f, bram_grid[idx % n_b], bram_grid[-1]),
        f_rel=torch.broadcast_to(f_rel, p.shape), power=p, feasible=any_f)


def technique_grid_mask(technique: str, grids: VoltageGrids) -> torch.Tensor:
    """Boolean ``[C, B]`` mask of grid points a technique may select."""
    c, b = grids.core.shape[0], grids.bram.shape[0]
    if technique in ("proposed", "hybrid", "headroom"):
        # The node-count axis of hybrid/headroom is the controller's gear
        # sweep, not the mask.
        return torch.ones((c, b), dtype=torch.bool, device=grids.core.device)
    mask = torch.zeros((c, b), dtype=torch.bool, device=grids.core.device)
    if technique == "core_only":
        mask[:, -1] = True      # V_bram pinned at nominal
    elif technique == "bram_only":
        mask[-1, :] = True      # V_core pinned at nominal
    elif technique in ("freq_only", "nominal", "power_gating"):
        mask[-1, -1] = True     # both rails nominal
    else:
        raise ValueError(technique)
    return mask


def _with_grid_axes(p: char.PlatformParams) -> char.PlatformParams:
    """Insert the two grid axes before each leaf's term axis."""
    per_platform = ("delay_mode", "nominal_power_arb", "watts_scale")
    return char.PlatformParams(*[
        x[..., None, None] if name in per_platform else x[..., None, None, :]
        for name, x in zip(char.PlatformParams._fields, p)])


def optimize_point_params(params: char.PlatformParams, f_rel: torch.Tensor,
                          core_grid: torch.Tensor, bram_grid: torch.Tensor,
                          mask: torch.Tensor,
                          slack_eps: float = 1e-6) -> OperatingPoint:
    """Minimize power over the masked grid subject to timing at ``f_rel``.

    The clock period stretches by ``1/f_rel``; a grid point meets timing
    when its normalized delay is within ``(1 + slack_eps)`` of that.
    ``params`` leaves ``[*Lp, terms]`` broadcast against ``f_rel``
    ``[*Lf]``; ``mask`` broadcasts against ``[*Lp ∨ Lf, C, B]``.
    """
    f_rel = char._f32(f_rel, core_grid.device)
    stretch = 1.0 / torch.clamp(f_rel, min=1e-6)
    vc, vb = core_grid[:, None], bram_grid[None, :]
    pg = _with_grid_axes(params)
    delay = char.params_delay(pg, vc, vb)                        # [*Lp, C, B]
    power = char.params_power(pg, vc, vb, f_rel[..., None, None])
    feasible = (delay <= stretch[..., None, None] * (1.0 + slack_eps)) & mask
    return masked_grid_argmin(
        power, feasible, core_grid, bram_grid, f_rel,
        char.params_power(params, core_grid[-1], bram_grid[-1], f_rel))


def optimize_batch_params(params: char.PlatformParams, f_rels: torch.Tensor,
                          core_grid: torch.Tensor, bram_grid: torch.Tensor,
                          mask: torch.Tensor,
                          slack_eps: float = 1e-6) -> OperatingPoint:
    """:func:`optimize_point_params` for one platform over ``[M]`` levels."""
    return optimize_point_params(params, f_rels, core_grid, bram_grid, mask,
                                 slack_eps=slack_eps)


def bin_frequency_levels(n_bins: int, margin: float,
                         f_floor: float = 0.05) -> torch.Tensor:
    """Frequency level for each workload bin: bin upper edge + t margin.

    Bin ``i`` covers workload in ``(i/M, (i+1)/M]``; §V requires
    ``t > 1/M`` so a one-bin under-prediction is still covered.
    """
    edges = (torch.arange(n_bins, dtype=char.F32) + 1.0) / n_bins
    return torch.clamp(edges + margin, f_floor, 1.0)
