"""Joint (V_core, V_bram) optimization under a delay constraint (§III, §V).

Port of ``repro.core.voltage``, both halves.

* The closure half, the paper's §III optimizer as written: a platform is
  a pair of closures over (V_core, V_bram), ``DelayFn`` and ``PowerFn``
  (``fpga_delay_fn``, ``tpu_delay_fn``, a power model's ``power``);
  ``optimize_point`` / ``optimize_batch`` minimise power over a grid under
  the delay constraint, and ``build_operating_table`` precomputes one
  point per frequency level for the runtime's ceil-lookup
  (``OperatingTable.lookup``).  Plain torch on the caller's device: the
  JAX package's closure path reaches no Pallas kernel either.  Where the
  JAX package ``vmap``s over levels, a level axis broadcasts here.
* The array-parameterized half (the fleet path): the shared voltage
  grids, technique masks over the one full grid, the masked argmin every
  sweep path shares, and the per-bin frequency levels.  The sweep
  functions broadcast: ``PlatformParams`` leaves ``[*Lp, terms]`` against
  frequency levels ``[*Lf]`` give ``[*broadcast(Lp, Lf)]`` points, which
  is how the plain grid-argmin version sweeps a whole fleet at once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal, NamedTuple

import torch

from repro_torch.core import characterization as char

DelayFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (v_core, v_bram) -> delay
PowerFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]  # (.., f_rel)


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


# ---------------------------------------------------------------------------
# Delay compositions (the closure path)
# ---------------------------------------------------------------------------


def fpga_delay_fn(alpha: float, core_mix: dict[str, float] | None = None) -> DelayFn:
    """Paper Eq. 1/2 — serial critical path, normalized to 1 at nominals;
    ``alpha`` is the BRAM share of the nominal critical path delay."""

    def delay(v_core: torch.Tensor, v_bram: torch.Tensor) -> torch.Tensor:
        d = (char.core_delay_factor(v_core, core_mix)
             + alpha * char.bram_delay_factor(v_bram))
        return d / (1.0 + alpha)

    return delay


def tpu_delay_fn(t_compute: float, t_memory: float, t_collective: float,
                 composition: Literal["max", "sum"] = "max") -> DelayFn:
    """Roofline composition of terms in seconds: compute and collective on
    the core domain, memory on the HBM domain; 1.0 at nominal voltages."""

    def combine(a, b, c):
        if composition == "max":
            return torch.maximum(torch.maximum(a, b), c)
        return a + b + c

    nominal = combine(char._f32(t_compute), char._f32(t_memory), char._f32(t_collective))

    def delay(v_core: torch.Tensor, v_hbm: torch.Tensor) -> torch.Tensor:
        dc = char.tpu_core_delay_factor(v_core)
        dm = char.tpu_hbm_delay_factor(v_hbm)
        return combine(t_compute * dc, t_memory * dm, t_collective * dc) / nominal

    return delay


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


def optimize_point(delay_fn: DelayFn, power_fn: PowerFn, f_rel, grids: VoltageGrids,
                   slack_eps: float = 1e-6) -> OperatingPoint:
    """Minimize power over the voltage grid subject to timing at ``f_rel``.

    The clock period stretches by ``1/f_rel``; a grid point meets timing
    when its normalized delay is within ``(1 + slack_eps)`` of that.  Ties
    go to the first row-major grid index; with nothing feasible, the
    nominal corner.  ``f_rel`` may have any shape ``[*L]`` (one point per
    element), on the grids' device.
    """
    f_rel = char._f32(f_rel, grids.core.device)
    f = f_rel[..., None, None]
    stretch = 1.0 / torch.clamp(f, min=1e-6)
    vc, vb = grids.core[:, None], grids.bram[None, :]
    delay, power = torch.broadcast_tensors(delay_fn(vc, vb), power_fn(vc, vb, f))
    return masked_grid_argmin(
        power, delay <= stretch * (1.0 + slack_eps), grids.core, grids.bram, f_rel,
        power_fn(grids.core[-1], grids.bram[-1], f_rel))


def optimize_batch(delay_fn: DelayFn, power_fn: PowerFn, f_rels,
                   grids: VoltageGrids) -> OperatingPoint:
    """:func:`optimize_point` over a vector of frequency levels ``[M]`` (the
    JAX package's ``vmap``, here a broadcast level axis)."""
    return optimize_point(delay_fn, power_fn, f_rels, grids)


class OperatingTable(NamedTuple):
    """Per-frequency-level optimal operating points, for runtime lookup.

    ``f_levels`` ascends; ``lookup(f_req)`` returns the lowest level with
    ``f_level >= f_req`` (a ceil-lookup, so QoS holds), clipped to the top.
    """

    f_levels: torch.Tensor   # [L]
    v_core: torch.Tensor     # [L]
    v_bram: torch.Tensor     # [L]
    power: torch.Tensor      # [L]

    def lookup(self, f_req) -> OperatingPoint:
        f_req = char._f32(f_req, self.f_levels.device)
        idx = torch.searchsorted(self.f_levels, f_req, side="left")
        idx = torch.clamp(idx, 0, self.f_levels.shape[0] - 1)
        return OperatingPoint(v_core=self.v_core[idx], v_bram=self.v_bram[idx],
                              f_rel=self.f_levels[idx], power=self.power[idx],
                              feasible=torch.ones_like(idx, dtype=torch.bool))


def build_operating_table(delay_fn: DelayFn, power_fn: PowerFn, f_levels,
                          grids: VoltageGrids | None = None) -> OperatingTable:
    """Precompute the optimal (V_core, V_bram) per frequency level (the
    paper's synthesis-time table, §V), levels sorted ascending, on the
    grids' device (``VoltageGrids.default()`` when None)."""
    grids = VoltageGrids.default() if grids is None else grids
    f_levels = torch.sort(char._f32(f_levels, grids.core.device)).values
    pts = optimize_batch(delay_fn, power_fn, f_levels, grids)
    return OperatingTable(f_levels=f_levels, v_core=pts.v_core, v_bram=pts.v_bram,
                          power=pts.power)


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
