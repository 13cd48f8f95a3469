"""The §V DVFS controller over a fleet of platforms (paper Fig. 9).

Port of the materialized fleet path of ``repro.core.controller``:

  workload counter → predictor → frequency selector → voltage lookup into
  the per-bin operating table precomputed at synthesis time → PLL → rails.

* :func:`fleet_bin_tables` builds every (platform × technique) table with
  one fused grid sweep (``kernels.grid_argmin``: the CUDA kernel on the
  card, its plain PyTorch version on the CPU), plus the hybrid gear argmin
  and the closed forms for nominal and power gating;
* :func:`simulate_fleet` runs the runtime loop for every fleet cell at
  once: a Python loop over steps whose state is ``[K]``-batched tensors
  that never leave the device until the last step;
* :func:`compare_all_batched` reduces the runs to the paper's
  :class:`Summary` metrics on the host, in numpy, exactly as the JAX
  package does;
* the single-platform path — :func:`build_bin_tables`, :func:`simulate`,
  :func:`summarize`, :func:`run_technique`, :func:`compare_all` — is the
  fleet path on a one-platform fleet (the JAX package's closure path, which
  it holds equal to its fleet path); :func:`analytic_platform` is the §III
  (α, β) model of the paper's Fig. 4–6 sweeps;
* :func:`simulate_fleet_stream` is the streaming engine of every campaign:
  the trace goes to the device ``[K, C]`` (or ``[K, C, T]`` with a tenant
  plane) one chunk at a time, the ``Summary`` reductions ride the step
  loop, and memory never grows with the trace length.

Entry points take ``device``: ``None`` means the CUDA card and raises on
a machine without one; ``"cpu"`` runs the plain path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import characterization as char
from repro_torch.core import pll as pll_mod
from repro_torch.core import predictors as pred_mod
from repro_torch.core import scheduler as sched_mod
from repro_torch.core import voltage as volt_mod
from repro_torch.core.accelerators import Accelerator
from repro_torch.device import resolve_device
from repro_torch.kernels.grid_argmin import grid_argmin

TECHNIQUES = ("proposed", "core_only", "bram_only", "freq_only",
              "power_gating", "nominal", "hybrid", "headroom")

DEFAULT_TECHNIQUES = ("proposed", "core_only", "bram_only", "freq_only",
                      "power_gating", "hybrid")


# ---------------------------------------------------------------------------
# Platforms and configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """One compute node's delay/power characterization, in both forms.

    ``params`` is the array-parameterized model the fleet path sweeps (B1
    on the card).  ``delay_fn(v_core, v_bram)`` — normalized delay, 1.0 at
    nominal rails — and ``power_fn(v_core, v_bram, f_rel)`` — power in
    arbitrary units — are the same model as closures, for the §III
    optimizer (``voltage.optimize_point``, ``build_operating_table``);
    ``nominal_power_arb`` is ``power_fn`` at nominal, so ``watts_nominal``
    pins the absolute scale.  ``fpga_platform``, ``analytic_platform``
    and ``tpu_platform`` set all of them.
    """

    name: str
    params: char.PlatformParams
    watts_nominal: float
    delay_fn: volt_mod.DelayFn
    power_fn: volt_mod.PowerFn
    nominal_power_arb: float

    @property
    def watts_scale(self) -> float:
        return self.watts_nominal / self.nominal_power_arb

    def power_watts(self, v_core, v_bram, f_rel) -> torch.Tensor:
        return self.power_fn(v_core, v_bram, f_rel) * self.watts_scale


def fpga_platform(acc: Accelerator, activity: float = 0.125,
                  watts_nominal: float = 20.0) -> PlatformSpec:
    """Paper's platform: one accelerator mapped on its smallest device."""
    pm = acc.power_model(activity)
    mix = dict(acc.core_mix or {}) or None
    return PlatformSpec(
        name=f"fpga:{acc.name}",
        params=char.fpga_platform_params(acc.util, acc.device(), acc.alpha,
                                         mix, activity, watts_nominal),
        watts_nominal=watts_nominal,
        delay_fn=volt_mod.fpga_delay_fn(acc.alpha, mix),
        power_fn=pm.power,
        nominal_power_arb=float(pm.nominal_power()))


def analytic_platform(alpha: float = 0.2, beta: float = 0.4,
                      watts_nominal: float = 20.0) -> PlatformSpec:
    """The §III motivational model: Eq. 1-3 with free (α, β).

    Delay ``(D_l(V_core) + α·D_m(V_bram)) / (1+α)``; power the core-rail
    mix plus ``β``-weighted BRAM power, so nominal power is ``1 + β``
    (``params.nominal_power_arb``) — the Fig. 4/5/6 sweeps.
    """
    logic, routing, mem = (char.FPGA_LIBRARY[k] for k in ("logic", "routing", "memory"))
    one, vc0, vb0 = char._f32(1.0), char._f32(char.V_CORE_NOM), char._f32(char.V_BRAM_NOM)
    core_nom = float(0.4 * logic.total_power(vc0, one) + 0.6 * routing.total_power(vc0, one))
    mem_nom = float(mem.total_power(vb0, one))

    def power_fn(v_core, v_bram, f_rel):
        p_core = (0.4 * logic.total_power(v_core, f_rel)
                  + 0.6 * routing.total_power(v_core, f_rel)) / core_nom
        return p_core + beta * (mem.total_power(v_bram, f_rel) / mem_nom)

    return PlatformSpec(
        name=f"analytic:a{alpha}b{beta}",
        params=char.analytic_platform_params(alpha, beta, watts_nominal),
        watts_nominal=watts_nominal,
        delay_fn=volt_mod.fpga_delay_fn(alpha),
        power_fn=power_fn,
        nominal_power_arb=1.0 + beta)


def tpu_platform(t_compute: float, t_memory: float, t_collective: float,
                 name: str = "tpu", composition: str = "max",
                 watts_nominal: float = 200.0) -> PlatformSpec:
    """TPU adaptation: roofline terms (seconds) from the compiled dry-run;
    core and ICI ride the core rail, HBM the second rail, and one relative
    frequency applies to both domains."""
    chip = char.TpuChipPowerModel()

    def power_fn(v_core, v_hbm, f_rel):
        return chip.power(v_core, v_hbm, f_rel, f_rel)

    return PlatformSpec(
        name=f"tpu:{name}",
        params=char.tpu_platform_params(t_compute, t_memory, t_collective,
                                        composition, watts_nominal),
        watts_nominal=watts_nominal,
        delay_fn=volt_mod.tpu_delay_fn(t_compute, t_memory, t_collective,
                                       composition=composition),
        power_fn=power_fn,
        nominal_power_arb=float(chip.nominal_power()))


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    technique: str = "proposed"
    n_bins: int = 25
    margin: float = 0.05          # paper's t — additive, must exceed 1/M (§V)
    tau: float = 1.0              # time-step length (s)
    n_nodes: int = 8
    f_floor: float = 0.10         # lowest selectable relative frequency
    use_oracle: bool = False      # perfect prediction (upper bound)
    gated_power_frac: float = 0.0  # residual power of a power-gated node
    #: Workload forecaster: a ``PredictorConfig`` or a registered kind.
    predictor: pred_mod.PredictorConfig | str = dataclasses.field(
        default_factory=pred_mod.PredictorConfig)
    #: Availability forecaster over ``avail / n_nodes`` (bins = node counts).
    avail_predictor: pred_mod.PredictorConfig | str = "persistence"
    #: Failure depth the ``headroom`` technique provisions spare capacity for.
    headroom_frac: float = 0.5
    #: Tenant scheduler: a ``SchedulerConfig`` or a registered name.
    scheduler: sched_mod.SchedulerConfig | str = "none"
    pll: pll_mod.PllConfig = dataclasses.field(default_factory=pll_mod.PllConfig)
    v_step: float = char.V_STEP

    def __post_init__(self):
        if self.technique not in TECHNIQUES:
            raise ValueError(f"unknown technique {self.technique!r}")
        if isinstance(self.scheduler, str):
            object.__setattr__(self, "scheduler",
                               sched_mod.get(self.scheduler))
        elif not isinstance(self.scheduler, sched_mod.SchedulerConfig):
            raise TypeError(
                f"scheduler must be a registered name or SchedulerConfig, "
                f"got {type(self.scheduler).__name__}")
        if self.margin < 1.0 / self.n_bins + 1e-9:
            # §V: t must exceed 1/M so the capacity provisioned for bin i
            # still covers a one-bin under-prediction.
            raise ValueError(
                f"margin {self.margin} must exceed 1/n_bins = "
                f"{1.0 / self.n_bins:.4f} (paper §V: t > 1/M)")
        pcfg = self.predictor
        if isinstance(pcfg, str):
            pcfg = pred_mod.PredictorConfig(kind=pcfg)
        # margin_bins = ⌊t·M⌋: the whole bins the provisioned margin absorbs.
        object.__setattr__(self, "predictor", dataclasses.replace(
            pcfg, n_bins=self.n_bins,
            margin_bins=int(np.floor(self.margin * self.n_bins + 1e-9))))
        if not 0.0 <= self.headroom_frac < 1.0:
            raise ValueError(f"headroom_frac {self.headroom_frac} must be "
                             "in [0, 1)")
        if int(np.ceil(self.headroom_frac * self.n_nodes - 1e-9)) \
                >= self.n_nodes:
            raise ValueError(
                f"headroom_frac {self.headroom_frac} plans for the whole "
                f"fleet lost (ceil(frac·{self.n_nodes}) = {self.n_nodes}) "
                "— the reserve must leave at least one planned node; "
                "lower it")
        acfg = self.avail_predictor
        if isinstance(acfg, str):
            acfg = pred_mod.PredictorConfig(kind=acfg)
        # Availability bins are usable-node counts; no margin.
        object.__setattr__(self, "avail_predictor", dataclasses.replace(
            acfg, n_bins=self.n_nodes, margin_bins=0))


class BinTables(NamedTuple):
    """Per-workload-bin operating points — the §V synthesis-time table.

    Fields are ``[..., M]`` (``headroom`` is ``[...]``).  ``power`` is the
    fleet total at the configured ``n_nodes``; with ``a`` nodes available a
    step draws ``min(n_active, a)·node_power + max(a − n_active, 0)·
    gated_power``.
    """

    capacity: torch.Tensor
    power: torch.Tensor
    v_core: torch.Tensor
    v_bram: torch.Tensor
    f_rel: torch.Tensor
    n_active: torch.Tensor
    node_power: torch.Tensor
    gated_power: torch.Tensor
    headroom: torch.Tensor


def nominal_node_watts(platform: PlatformSpec) -> float:
    """One node's watts at nominal rails and full frequency — the
    denominator of the paper's power-reduction factor."""
    return float(_nominal_watts(char.stack_platform_params([platform.params]))[0])


def pll_standing_watts(cfg: ControllerConfig) -> float:
    """Standing PLL power per node (two PLLs in the Fig. 9c architecture)."""
    return (2 if cfg.pll.dual else 1) * cfg.pll.p_pll


def _hybrid_gears(cfg: ControllerConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Node-count gears: ``(gears [G], f_node [G, M], feasible [G, M])``.

    Gear ``g`` keeps ``g`` of ``n_nodes`` nodes on, each running at
    ``level·n/g`` — infeasible above 1.
    """
    levels = volt_mod.bin_frequency_levels(cfg.n_bins, cfg.margin, cfg.f_floor)
    gears = torch.arange(1, cfg.n_nodes + 1, dtype=torch.float32)
    f_need = levels[None, :] * cfg.n_nodes / gears[:, None]
    return gears, torch.clamp(f_need, cfg.f_floor, 1.0), f_need <= 1.0 + 1e-9


def _headroom_spare(cfg: ControllerConfig) -> int:
    """Lost nodes ``headroom`` provisions for: ``ceil(frac·n_nodes)``."""
    return int(np.ceil(cfg.headroom_frac * cfg.n_nodes - 1e-9))


def _sweep_rows(cfg: ControllerConfig, techniques: Sequence[str]
                ) -> Tuple[volt_mod.VoltageGrids, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Masked sweep rows: one per DVFS technique, then one per hybrid gear.

    Returns ``(grids, levels [M], row_masks [R, C, B], row_levels [R, M])``
    on the CPU.
    """
    dvfs = [t for t in techniques
            if t not in ("nominal", "power_gating", "hybrid", "headroom")]
    grids = volt_mod.VoltageGrids.default(cfg.v_step)
    levels = volt_mod.bin_frequency_levels(cfg.n_bins, cfg.margin, cfg.f_floor)
    row_masks = [volt_mod.technique_grid_mask(t, grids) for t in dvfs]
    row_levels = [levels] * len(dvfs)
    if "hybrid" in techniques or "headroom" in techniques:
        gears, f_node, _ = _hybrid_gears(cfg)
        row_masks += [volt_mod.technique_grid_mask("hybrid", grids)] * len(gears)
        row_levels += list(f_node)
    return grids, levels, torch.stack(row_masks), torch.stack(row_levels)


def _nominal_watts(params: char.PlatformParams) -> torch.Tensor:
    """Per-platform watts of one node at nominal rails and full clock [P]."""
    return char.params_power_watts(params, char.V_CORE_NOM, char.V_BRAM_NOM, 1.0)


def fleet_bin_tables(params: char.PlatformParams, cfg: ControllerConfig,
                     techniques: Sequence[str] = DEFAULT_TECHNIQUES,
                     device=None) -> BinTables:
    """§V synthesis-time tables for a stacked fleet: fields ``[P, T, M]``.

    DVFS techniques and the hybrid/headroom gears share one masked sweep
    (one ``grid_argmin`` launch); nominal and power gating are closed
    forms in the platform's nominal watts.
    """
    dev = resolve_device(device)
    params = params.to(dev)
    m = cfg.n_bins
    pll_watts = pll_standing_watts(cfg)
    stall = pll_mod.stall_fraction(cfg.pll, cfg.tau)
    n_p = params.watts_scale.shape[0]

    def full(x):
        return torch.full((n_p, m), float(x), device=dev)

    per_tech: Dict[str, BinTables] = {}
    dvfs = [t for t in techniques
            if t not in ("nominal", "power_gating", "hybrid", "headroom")]
    geared = [t for t in ("hybrid", "headroom") if t in techniques]
    if dvfs or geared:
        grids, levels, row_masks, row_levels = _sweep_rows(cfg, techniques)
        grids, levels = grids.to(dev), levels.to(dev)
        pts = grid_argmin(params, row_masks.to(dev), row_levels.to(dev),
                          grids.core, grids.bram)
        node_w = pts.power * params.watts_scale[:, None, None]   # [P, R, M]
        for i, t in enumerate(dvfs):
            per_tech[t] = BinTables(
                capacity=(levels * (1.0 - stall)).expand(n_p, m),
                power=(node_w[:, i] + pll_watts) * cfg.n_nodes,
                v_core=pts.v_core[:, i], v_bram=pts.v_bram[:, i],
                f_rel=levels.expand(n_p, m), n_active=full(cfg.n_nodes),
                node_power=node_w[:, i] + pll_watts, gated_power=full(0.0),
                headroom=torch.zeros(n_p, device=dev))
        # hybrid and headroom share the gear rows; headroom's reserve is a
        # runtime policy flagged by its ``headroom`` field.
        if geared:
            gears, f_node, gear_ok = (x.to(dev) for x in _hybrid_gears(cfg))
            h_w = node_w[:, len(dvfs):]                         # [P, G, M]
            nom_w = _nominal_watts(params)                      # [P]
            g3 = gears[None, :, None]
            total = (g3 * (h_w + pll_watts)
                     + (cfg.n_nodes - g3) * cfg.gated_power_frac
                     * nom_w[:, None, None])
            total = torch.where(gear_ok[None], total, torch.inf)
            gi = total.argmin(1, keepdim=True)                  # [P, 1, M]

            def pick(x):  # the chosen gear of a [P, G, M] field
                return x.expand_as(h_w).gather(1, gi)[:, 0]

            f_sel = pick(f_node[None])
            n_sel = gears[gi[:, 0]]
            for t in geared:
                per_tech[t] = BinTables(
                    capacity=(n_sel / cfg.n_nodes) * f_sel * (1.0 - stall),
                    power=pick(total),
                    v_core=pick(pts.v_core[:, len(dvfs):]),
                    v_bram=pick(pts.v_bram[:, len(dvfs):]),
                    f_rel=f_sel, n_active=n_sel,
                    node_power=pick(h_w) + pll_watts,
                    gated_power=(cfg.gated_power_frac * nom_w)[:, None]
                    .expand(n_p, m),
                    headroom=torch.full((n_p,), cfg.headroom_frac
                                        if t == "headroom" else 0.0,
                                        device=dev))

    if "nominal" in techniques or "power_gating" in techniques:
        node_w = _nominal_watts(params)                         # [P]
        node_pll = (node_w + pll_watts)[:, None].expand(n_p, m)
        if "nominal" in techniques:
            per_tech["nominal"] = BinTables(
                capacity=full(1.0),
                power=((node_w + pll_watts) * cfg.n_nodes)[:, None].expand(n_p, m),
                v_core=full(char.V_CORE_NOM), v_bram=full(char.V_BRAM_NOM),
                f_rel=full(1.0), n_active=full(cfg.n_nodes),
                node_power=node_pll, gated_power=full(0.0),
                headroom=torch.zeros(n_p, device=dev))
        if "power_gating" in techniques:
            # Active nodes scale linearly with the bin's upper edge and run
            # at nominal V/f; no extra margin (§III baseline).
            edges = (np.arange(m) + 1.0) / m
            n_active = torch.as_tensor(
                np.minimum(np.ceil(edges * cfg.n_nodes), cfg.n_nodes),
                dtype=torch.float32).to(dev)
            gated = ((cfg.n_nodes - n_active) * cfg.gated_power_frac
                     * node_w[:, None])
            per_tech["power_gating"] = BinTables(
                capacity=(n_active / cfg.n_nodes).expand(n_p, m),
                power=n_active * (node_w[:, None] + pll_watts) + gated,
                v_core=full(char.V_CORE_NOM), v_bram=full(char.V_BRAM_NOM),
                f_rel=full(1.0), n_active=n_active.expand(n_p, m),
                node_power=node_pll,
                gated_power=(cfg.gated_power_frac * node_w)[:, None]
                .expand(n_p, m),
                headroom=torch.zeros(n_p, device=dev))

    return BinTables(*[torch.stack([getattr(per_tech[t], f) for t in techniques],
                                   dim=1)
                       for f in BinTables._fields])


def build_bin_tables(platform: PlatformSpec, cfg: ControllerConfig,
                     device=None) -> BinTables:
    """The optimal operating point for every workload bin of one platform
    and ``cfg.technique``: fields ``[M]`` (``headroom`` ``[]``), through
    :func:`fleet_bin_tables` on a one-platform fleet (one ``grid_argmin``
    launch on the card for a DVFS or geared technique)."""
    params = char.stack_platform_params([platform.params])
    tables = fleet_bin_tables(params, cfg, (cfg.technique,), device=device)
    return BinTables(*[x[0, 0] for x in tables])


# ---------------------------------------------------------------------------
# The runtime loop
# ---------------------------------------------------------------------------


class TraceResult(NamedTuple):
    power: torch.Tensor            # [..., S] platform watts per step
    capacity: torch.Tensor         # [..., S] delivered relative throughput
    violations: torch.Tensor       # [..., S] bool — demand exceeded capacity
    backlog: torch.Tensor          # [..., S] carried-over work
    predicted_bin: torch.Tensor    # [..., S]
    actual_bin: torch.Tensor       # [..., S]
    v_core: torch.Tensor           # [..., S]
    v_bram: torch.Tensor           # [..., S]
    f_rel: torch.Tensor            # [..., S]
    n_active: torch.Tensor         # [..., S] powered-on nodes
    mispredictions: torch.Tensor   # [...] post-warmup exact-bin misses
    margin_misses: torch.Tensor    # [...] post-warmup beyond-margin misses
    final_predictor: pred_mod.PredictorState


@dataclasses.dataclass(frozen=True)
class Summary:
    technique: str
    mean_power_w: float
    #: Nominal baseline of the available fleet (the configured one here).
    nominal_power_w: float
    power_gain: float            # nominal / mean — the paper's headline metric
    qos_violation_rate: float
    served_fraction: float       # work served in-step / work offered
    misprediction_rate: float    # post-warmup mispredictions / post-warmup steps
    mean_backlog: float
    margin_misprediction_rate: float = float("nan")
    latency_p50: float = float("nan")
    latency_p99: float = float("nan")
    nominal_power_configured_w: float = float("nan")
    power_gain_vs_configured: float = float("nan")


class _StepOut(NamedTuple):
    """Per-step fields of one §V control step: ten aggregate ``[K]``
    fields, then the per-tenant ``[K, T]`` outcome the streaming
    reductions read."""

    power: torch.Tensor
    capacity: torch.Tensor
    violation: torch.Tensor
    backlog: torch.Tensor
    predicted_bin: torch.Tensor
    actual_bin: torch.Tensor
    v_core: torch.Tensor
    v_bram: torch.Tensor
    f_rel: torch.Tensor
    n_active: torch.Tensor
    tenant_served: torch.Tensor
    tenant_backlog: torch.Tensor
    tenant_violation: torch.Tensor
    tenant_starved: torch.Tensor


#: Per-step fields ``emit=`` may request — the aggregate ``[K]`` ones.
_EMITTABLE = ("power", "capacity", "violation", "backlog", "predicted_bin",
              "actual_bin", "v_core", "v_bram", "f_rel", "n_active")


def _at(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather: ``tab[k, idx[k]]`` for ``[K, M]`` tables."""
    return tab.gather(-1, idx[:, None])[:, 0]


def availability_point(tables: BinTables, selected: torch.Tensor,
                       avail_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamp bin ``selected``'s point to ``avail_t`` usable nodes:
    ``(n_act, capacity, power)``.  Dead nodes draw nothing; gated-but-alive
    nodes keep the gating residual."""
    n_tab = _at(tables.n_active, selected)
    n_act = torch.minimum(n_tab, avail_t)
    cap = _at(tables.capacity, selected) * (n_act / torch.clamp(n_tab, min=1.0))
    pwr = (n_act * _at(tables.node_power, selected)
           + torch.clamp(avail_t - n_act, min=0.0)
           * _at(tables.gated_power, selected))
    return n_act, cap, pwr


def _headroom_bump(tables: BinTables, cfg: ControllerConfig,
                   astate: pred_mod.PredictorState, selected: torch.Tensor,
                   backlog_agg: torch.Tensor) -> torch.Tensor:
    """Raise ``selected`` to the lowest bin whose availability-degraded
    delivery covers its demand plus backlog, planning for at most
    ``ceil(headroom·n_nodes)`` lost nodes; cells without headroom keep
    their bin."""
    m = cfg.n_bins
    n = float(cfg.n_nodes)
    a_hat = torch.clamp(pred_mod.forecast_fraction(cfg.avail_predictor, astate)
                        * cfg.n_nodes, 1.0, n)
    spare = torch.ceil(tables.headroom * cfg.n_nodes - 1e-9)
    a_res = torch.clamp(torch.maximum(a_hat, cfg.n_nodes - spare), max=n)
    needed = torch.minimum(sched_mod.div_static(selected + 1.0, m) + backlog_agg,
                           tables.capacity.amax(-1))
    delivered = tables.capacity * (
        torch.minimum(tables.n_active, a_res[:, None])
        / torch.clamp(tables.n_active, min=1.0))
    bins = torch.arange(m, device=selected.device)
    cand = torch.where(delivered >= (needed - 1e-9)[:, None], bins, m)
    bump = torch.clamp(cand.amin(-1), max=m - 1)
    return torch.where(tables.headroom > 0,
                       torch.maximum(selected, bump), selected)


_Carry = Tuple[pred_mod.PredictorState, pred_mod.PredictorState, torch.Tensor,
               torch.Tensor]


def _control_step(tables: BinTables, cfg: ControllerConfig, carry: _Carry,
                  w_t: torch.Tensor, avail_t: torch.Tensor,
                  spec: sched_mod.TenantSpec, sched: torch.Tensor,
                  any_headroom: bool) -> Tuple[_Carry, _StepOut]:
    """One §V control step for all ``K`` cells: predict → schedule-shape →
    select → clamp to availability → serve → observe.

    ``w_t`` is ``[K, T]`` offered work per tenant and ``avail_t`` ``[K]``
    usable nodes.  A step violates QoS when its demand (offered work plus
    carried backlog; only admitted work with the scheduler on) exceeds the
    delivered capacity.  ``any_headroom`` is False when no cell reserved
    headroom, which skips a bump that would leave every bin unchanged.
    """
    mstate, astate, backlog_t, place = carry
    w_agg = (w_t * spec.active).sum(-1)
    backlog_agg = (backlog_t * spec.active).sum(-1)
    predicted = pred_mod.predict(cfg.predictor, mstate)
    actual = pred_mod.workload_to_bin(w_agg, cfg.n_bins)
    base = actual if cfg.use_oracle else predicted
    shaped = sched_mod.provision_bin(spec, base, backlog_t, cfg.n_bins)
    shaped = sched_mod.opportunistic_bin(tables.power, tables.capacity, shaped,
                                         backlog_agg)
    selected = torch.where(sched[0] > 0, shaped, base)
    if any_headroom:
        selected = _headroom_bump(tables, cfg, astate, selected, backlog_agg)

    n_act, cap, pwr = availability_point(tables, selected, avail_t)

    demand = w_t + backlog_t
    alloc = sched_mod.schedule_step(spec, sched, demand, cap, n_act, place)
    total = (demand * spec.active).sum(-1)
    due = (torch.clamp(demand - 0.8 * spec.slack(), min=0.0)
           * spec.active).sum(-1)
    violation = torch.where(sched[0] > 0, due, total) > cap + 1e-9

    mstate = pred_mod.observe(cfg.predictor, mstate, w_agg, predicted)
    # Availability bins are node counts: a count of ``a`` is observed as
    # bin ``a − 1`` (the half-step keeps floor() off the bin edge).
    astate = pred_mod.observe(cfg.avail_predictor, astate,
                              (avail_t - 0.5) / cfg.n_nodes,
                              pred_mod.predict(cfg.avail_predictor, astate))
    out = _StepOut(power=pwr, capacity=cap, violation=violation,
                   backlog=alloc.backlog.sum(-1), predicted_bin=predicted,
                   actual_bin=actual, v_core=_at(tables.v_core, selected),
                   v_bram=_at(tables.v_bram, selected),
                   f_rel=_at(tables.f_rel, selected), n_active=n_act,
                   tenant_served=alloc.served, tenant_backlog=alloc.backlog,
                   tenant_violation=alloc.violation,
                   tenant_starved=alloc.starved)
    return (mstate, astate, alloc.backlog, alloc.place), out


def _scan_control_loop(tables: BinTables, cfg: ControllerConfig,
                       traces: torch.Tensor, avail: torch.Tensor
                       ) -> TraceResult:
    """The §V runtime loop over ``[K]`` cells: tables ``[K, M]``, traces
    and availability ``[K, S]``.  Aggregate only: each trace rides as one
    default tenant with the scheduler off.  Nothing leaves the device
    inside the loop."""
    dev = traces.device
    k, s = traces.shape
    spec = sched_mod.default_tenants(1).to(dev)
    sched = sched_mod.scheduler_values(sched_mod.SCHEDULERS["none"], dev)
    any_headroom = bool((tables.headroom > 0).any())
    carry = (pred_mod.init_state(cfg.predictor, k, dev),
             pred_mod.init_state(cfg.avail_predictor, k, dev),
             torch.zeros((k, 1), device=dev), torch.zeros((k, 1), device=dev))
    outs = {e: [] for e in _EMITTABLE}
    for t in range(s):
        carry, out = _control_step(tables, cfg, carry, traces[:, t, None],
                                   avail[:, t], spec, sched, any_headroom)
        for e in _EMITTABLE:
            outs[e].append(getattr(out, e))
    mstate = carry[0]
    steps = {e: torch.stack(xs, dim=-1) for e, xs in outs.items()}
    return TraceResult(violations=steps.pop("violation"), **steps,
                       mispredictions=mstate.mispredictions,
                       margin_misses=mstate.margin_misses,
                       final_predictor=mstate)


def _broadcast_traces(traces: np.ndarray, lead: Tuple[int, ...]) -> np.ndarray:
    """Expand traces to ``lead + (S,)`` as a zero-copy numpy view.

    Accepts one shared trace ``[S]`` or per-cell traces whose leading
    axes match ``lead`` dim for dim (1s broadcast).
    """
    traces = np.asarray(traces, np.float32)
    if traces.ndim == 1:
        return np.broadcast_to(traces, lead + traces.shape)
    if (traces.ndim - 1 == len(lead)
            and all(a == b or a == 1
                    for a, b in zip(traces.shape[:-1], lead))):
        return np.broadcast_to(traces, lead + traces.shape[-1:])
    # No rank-extending broadcasting: [P, S] traces against [P, T, M]
    # tables would silently line P up against T whenever P == T.
    raise ValueError(
        f"traces leading axes {traces.shape[:-1]} must match the "
        f"tables' leading axes {lead} dim-for-dim (1s broadcast), or "
        "pass a single [S] trace; expand per-platform traces to "
        "[P, 1, S] explicitly")


def _broadcast_avail(avail, lead: Tuple[int, ...], n_nodes: int,
                     s: int) -> np.ndarray:
    """Expand a usable-nodes schedule to ``lead + (S,)``; ``None`` means a
    healthy fleet with ``n_nodes`` available every step."""
    if avail is None:
        return np.broadcast_to(np.float32(n_nodes), lead + (s,))
    avail = _broadcast_traces(np.asarray(avail), lead)
    if avail.shape[-1] != s:
        raise ValueError(f"avail length {avail.shape[-1]} != trace "
                         f"length {s}")
    return avail


def simulate_fleet(tables: BinTables, traces, cfg: ControllerConfig,
                   avail=None, device=None) -> TraceResult:
    """Run the §V loop for every fleet cell at once.

    ``tables`` fields carry leading axes ``[..., M]`` (``[P, T, M]`` from
    :func:`fleet_bin_tables`); ``traces`` is one shared trace ``[S]`` or
    per-cell traces broadcastable to ``[..., S]``; ``avail`` is an
    optional usable-nodes schedule with the same rules (``None``: all
    ``cfg.n_nodes`` every step).  Returns ``[..., S]`` fields on
    ``device``.
    """
    dev = resolve_device(device)
    lead = tuple(tables.capacity.shape[:-1])
    k = int(np.prod(lead, dtype=np.int64)) if lead else 1
    flat = BinTables(*[x.to(dev).reshape((k,) + x.shape[len(lead):])
                       for x in tables])
    traces = _broadcast_traces(np.asarray(traces), lead)
    s = traces.shape[-1]
    avail = _broadcast_avail(avail, lead, cfg.n_nodes, s)
    traces = torch.tensor(traces.reshape(k, s), device=dev)
    avail = torch.tensor(avail.reshape(k, s), device=dev)
    return _unflatten(_scan_control_loop(flat, cfg, traces, avail), lead)


def simulate(platform: PlatformSpec, cfg: ControllerConfig, trace,
             avail=None, device=None) -> TraceResult:
    """Run the §V control loop over one workload trace ``[S]``.

    ``avail`` is an optional per-step usable-node trace; ``None`` means a
    healthy fleet.  Returns ``[S]`` fields on ``device``.
    """
    tables = build_bin_tables(platform, cfg, device=device)
    return simulate_fleet(tables, np.asarray(trace, np.float32), cfg,
                          avail=avail, device=device)


def summarize(platform: PlatformSpec, cfg: ControllerConfig, trace,
              result: TraceResult, avail=None) -> Summary:
    """Reduce a :func:`simulate` run to the paper's :class:`Summary`.

    ``power_gain`` is priced against the *available* fleet's nominal
    watts (dead nodes earn no baseline credit),
    ``power_gain_vs_configured`` against the configured one; both
    coincide on healthy runs.
    """
    node_nom = nominal_node_watts(platform) + pll_standing_watts(cfg)
    nominal_cfg_w = node_nom * cfg.n_nodes
    mean_avail = (float(cfg.n_nodes) if avail is None
                  else float(np.mean(np.asarray(avail))))
    nominal_w = node_nom * mean_avail
    mean_w = float(result.power.mean())
    offered = float(np.sum(np.asarray(trace, np.float32)))
    served = offered - float(result.backlog[-1])
    n_scored = max(result.power.shape[0] - cfg.predictor.warmup_steps, 1)
    return Summary(
        technique=cfg.technique,
        mean_power_w=mean_w,
        nominal_power_w=nominal_w,
        power_gain=nominal_w / mean_w,
        qos_violation_rate=float(result.violations.float().mean()),
        served_fraction=served / max(offered, 1e-9),
        misprediction_rate=float(result.mispredictions) / n_scored,
        mean_backlog=float(result.backlog.mean()),
        margin_misprediction_rate=float(result.margin_misses) / n_scored,
        nominal_power_configured_w=nominal_cfg_w,
        power_gain_vs_configured=nominal_cfg_w / mean_w,
    )


def run_technique(platform: PlatformSpec, trace, technique: str,
                  avail=None, device=None, **cfg_kwargs) -> Summary:
    """One platform, one technique: :func:`simulate` then :func:`summarize`."""
    cfg = ControllerConfig(technique=technique, **cfg_kwargs)
    result = simulate(platform, cfg, trace, avail=avail, device=device)
    return summarize(platform, cfg, trace, result, avail=avail)


def compare_all(platform: PlatformSpec, trace,
                techniques: Sequence[str] = DEFAULT_TECHNIQUES,
                device=None, **cfg_kwargs) -> Dict[str, Summary]:
    """:func:`run_technique` for each technique (one table build each)."""
    return {t: run_technique(platform, trace, t, device=device, **cfg_kwargs)
            for t in techniques}


def _tree_map(fn, x):
    """``fn`` on every tensor of a (nested) NamedTuple."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*[_tree_map(fn, v) for v in x])


def _unflatten(x, lead: Tuple[int, ...]):
    """Reshape every tensor of a (nested) NamedTuple from ``[K, ...]`` to
    ``lead + [...]``."""
    return _tree_map(lambda t: t.reshape(lead + t.shape[1:]), x)


# ---------------------------------------------------------------------------
# Fleet summaries
# ---------------------------------------------------------------------------


def fleet_node_nominal_watts(params: char.PlatformParams,
                             cfg: ControllerConfig) -> np.ndarray:
    """Per-platform nominal watts of ONE node (incl. PLLs) [P], float32."""
    return _nominal_watts(params).cpu().numpy() + pll_standing_watts(cfg)


def fleet_nominal_watts(params: char.PlatformParams,
                        cfg: ControllerConfig) -> np.ndarray:
    """Per-platform configured-fleet nominal watts [P]."""
    return fleet_node_nominal_watts(params, cfg) * cfg.n_nodes


def compare_all_batched(platforms: Sequence[PlatformSpec], trace,
                        techniques: Sequence[str] = DEFAULT_TECHNIQUES,
                        device=None, **cfg_kwargs
                        ) -> Dict[str, Dict[str, Summary]]:
    """Every platform × technique through the §V path at once.

    Returns ``{platform.name: {technique: Summary}}``.  The tables come
    from one grid sweep and the runs from one step loop over all cells;
    the summaries are reduced on the host in numpy.
    """
    names = [p.name for p in platforms]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate platform names {dupes}: results are "
                         "keyed by name — pass distinct names")
    dev = resolve_device(device)
    cfg = ControllerConfig(**cfg_kwargs)
    params = char.stack_platform_params([p.params for p in platforms]).to(dev)
    tables = fleet_bin_tables(params, cfg, techniques, device=dev)  # [P, T, M]
    res = simulate_fleet(tables, trace, cfg, device=dev)            # [P, T, S]
    return summarize_fleet(platforms, techniques, trace, params, cfg, res)


def summarize_fleet(platforms: Sequence[PlatformSpec],
                    techniques: Sequence[str], trace,
                    params: char.PlatformParams, cfg: ControllerConfig,
                    res: TraceResult) -> Dict[str, Dict[str, Summary]]:
    """Reduce a ``[P, T, S]`` fleet run to the paper's :class:`Summary`
    per platform and technique, on the host in numpy (the one host sync
    of :func:`compare_all_batched`)."""
    nominal_w = fleet_nominal_watts(params, cfg)                    # [P]
    offered = float(np.sum(np.asarray(trace, np.float32)))
    power = res.power.cpu().numpy()
    viol = res.violations.cpu().numpy()
    backlog = res.backlog.cpu().numpy()
    mispred = res.mispredictions.cpu().numpy()
    margin_miss = res.margin_misses.cpu().numpy()
    n_scored = max(power.shape[-1] - cfg.predictor.warmup_steps, 1)

    out: Dict[str, Dict[str, Summary]] = {}
    for i, plat in enumerate(platforms):
        per_tech = {}
        for j, tech in enumerate(techniques):
            mean_w = float(power[i, j].mean())
            served = offered - float(backlog[i, j, -1])
            per_tech[tech] = Summary(
                technique=tech,
                mean_power_w=mean_w,
                nominal_power_w=float(nominal_w[i]),
                power_gain=float(nominal_w[i]) / mean_w,
                qos_violation_rate=float(viol[i, j].mean()),
                served_fraction=served / max(offered, 1e-9),
                misprediction_rate=float(mispred[i, j]) / n_scored,
                mean_backlog=float(backlog[i, j].mean()),
                margin_misprediction_rate=float(margin_miss[i, j]) / n_scored,
                nominal_power_configured_w=float(nominal_w[i]),
                power_gain_vs_configured=float(nominal_w[i]) / mean_w,
            )
        out[plat.name] = per_tech
    return out


# ---------------------------------------------------------------------------
# Streaming fleet evaluation (memory independent of the trace length)
# ---------------------------------------------------------------------------
#
# ``simulate_fleet`` keeps all ten per-step fields as ``[K, S]`` tensors.
# The streaming path instead carries the Summary reductions through the step
# loop and feeds the trace to the device one ``[K, C]`` chunk at a time: per
# chunk one host-to-device copy per input, the steps through the one
# ``_control_step``, then the chunk's float32 sums added on the host in
# float64.  Per-step fields are kept only on request (``emit=``).


class _StreamAcc(NamedTuple):
    """Streaming carry: controller state plus the chunk's float32 sums.

    ``backlog``/``place`` are per-tenant ``[K, T]`` carries; the ``t_*``
    fields are per-tenant sums ``[K, T]`` (aggregate runs have ``T = 1``).
    """

    mstate: pred_mod.PredictorState
    astate: pred_mod.PredictorState   # availability-plane forecaster
    backlog: torch.Tensor       # [K, T] carried per-tenant backlog
    place: torch.Tensor         # [K, T] per-tenant node placement
    power_sum: torch.Tensor     # [K] Σ watts
    viol_sum: torch.Tensor      # [K] Σ violations
    backlog_sum: torch.Tensor   # [K] Σ aggregate backlog
    offered_sum: torch.Tensor   # [K] Σ aggregate w_t
    avail_sum: torch.Tensor     # [K] Σ usable nodes
    t_viol_sum: torch.Tensor    # [K, T] Σ per-tenant QoS violations
    t_starve_sum: torch.Tensor  # [K, T] Σ per-tenant starvation steps
    t_served_sum: torch.Tensor  # [K, T] Σ per-tenant served work
    t_offered_sum: torch.Tensor  # [K, T] Σ per-tenant offered work


class FleetSummary(NamedTuple):
    """Per-cell reductions of a streaming fleet run (host numpy).

    Every field carries the tables' leading axes (``[P, T]``,
    ``[P, T, N]``, …), never the trace length; ``emitted`` holds the
    requested per-step fields as ``[..., S]`` arrays.  The ``tenant_*``
    fields are ``[..., T]`` (``T = 1`` for aggregate runs; padding tenants
    report zeros).
    """

    mean_power_w: np.ndarray
    qos_violation_rate: np.ndarray
    served_fraction: np.ndarray
    mean_backlog: np.ndarray
    final_backlog: np.ndarray
    offered: np.ndarray
    mispredictions: np.ndarray
    n_steps: int
    final_predictor: pred_mod.PredictorState
    emitted: Dict[str, np.ndarray]
    mean_avail_nodes: np.ndarray
    margin_misses: np.ndarray
    tenant_qos_violation_rate: np.ndarray
    tenant_starvation_rate: np.ndarray
    tenant_served_fraction: np.ndarray
    tenant_final_backlog: np.ndarray


def _stream_chunk(tables: BinTables, cfg: ControllerConfig, acc: _StreamAcc,
                  chunk: torch.Tensor, avail, spec: sched_mod.TenantSpec,
                  sched: torch.Tensor, any_headroom: bool,
                  emit: Tuple[str, ...]
                  ) -> Tuple[_StreamAcc, Dict[str, torch.Tensor]]:
    """One chunk of steps on the device: ``chunk`` is ``[K, C, T]``,
    ``avail`` ``[K, C]`` or one ``[K]`` row for every step.  The sums
    restart at zero; nothing goes back to the host."""
    zero = torch.zeros_like(acc.power_sum)
    zt = torch.zeros_like(acc.backlog)
    acc = acc._replace(power_sum=zero, viol_sum=zero, backlog_sum=zero,
                       offered_sum=zero, avail_sum=zero, t_viol_sum=zt,
                       t_starve_sum=zt, t_served_sum=zt, t_offered_sum=zt)
    ys = {e: [] for e in emit}
    for i in range(chunk.shape[1]):
        w_t = chunk[:, i]
        a_t = avail if avail.dim() == 1 else avail[:, i]
        (ms, ast, bl, pl), out = _control_step(
            tables, cfg, (acc.mstate, acc.astate, acc.backlog, acc.place),
            w_t, a_t, spec, sched, any_headroom)
        acc = _StreamAcc(
            mstate=ms, astate=ast, backlog=bl, place=pl,
            power_sum=acc.power_sum + out.power,
            viol_sum=acc.viol_sum + out.violation.float(),
            backlog_sum=acc.backlog_sum + out.backlog,
            offered_sum=acc.offered_sum + (w_t * spec.active).sum(-1),
            avail_sum=acc.avail_sum + a_t,
            t_viol_sum=acc.t_viol_sum + out.tenant_violation.float(),
            t_starve_sum=acc.t_starve_sum + out.tenant_starved.float(),
            t_served_sum=acc.t_served_sum + out.tenant_served,
            t_offered_sum=acc.t_offered_sum + w_t * spec.active)
        for e in emit:
            ys[e].append(getattr(out, e))
    return acc, {e: torch.stack(y, dim=-1) for e, y in ys.items()}


def _broadcast_tenant_traces(traces: np.ndarray, lead: Tuple[int, ...],
                             n_tenants: int) -> np.ndarray:
    """Expand a tenant plane to ``lead + (S, T)`` as a zero-copy view: one
    shared ``[S, T]`` plane or per-cell planes whose leading axes match
    ``lead`` dim for dim (1s broadcast)."""
    traces = np.asarray(traces, np.float32)
    if traces.ndim < 2 or traces.shape[-1] != n_tenants:
        raise ValueError(
            f"tenant plane must end in [S, T={n_tenants}] to match the "
            f"tenant spec, got shape {traces.shape}")
    if traces.ndim == 2:
        return np.broadcast_to(traces, lead + traces.shape)
    if (traces.ndim - 2 == len(lead)
            and all(a == b or a == 1
                    for a, b in zip(traces.shape[:-2], lead))):
        return np.broadcast_to(traces, lead + traces.shape[-2:])
    raise ValueError(
        f"tenant plane leading axes {traces.shape[:-2]} must match the "
        f"tables' leading axes {lead} dim-for-dim (1s broadcast), or "
        "pass a single shared [S, T] plane")


def _flatten_tenant_spec(spec: sched_mod.TenantSpec, lead: Tuple[int, ...],
                         k: int, device) -> sched_mod.TenantSpec:
    """Broadcast spec leaves (shared ``[T]`` or per-cell ``lead + (T,)``,
    1s broadcast) to ``[K, T]`` tensors on ``device``."""
    t = spec.n_tenants

    def one(x, name):
        x = np.asarray(x, np.float32)
        if x.ndim == 0 or x.shape[-1] != t:
            raise ValueError(f"tenant spec leaf {name!r} must end in "
                             f"[T={t}], got shape {x.shape}")
        if x.ndim == 1:
            x = np.broadcast_to(x, lead + x.shape)
        elif (x.ndim - 1 == len(lead)
                and all(a == b or a == 1
                        for a, b in zip(x.shape[:-1], lead))):
            x = np.broadcast_to(x, lead + x.shape[-1:])
        else:
            raise ValueError(
                f"tenant spec leaf {name!r} leading axes {x.shape[:-1]} "
                f"must match the tables' leading axes {lead} dim-for-dim "
                "(1s broadcast), or pass shared [T] leaves")
        return torch.tensor(x.reshape(k, t), device=device)

    return sched_mod.TenantSpec(*[one(x, n) for n, x in
                                  zip(spec._fields, spec)])


def simulate_fleet_stream(tables: BinTables, traces, cfg: ControllerConfig,
                          chunk_size: int = 1024, emit: Sequence[str] = (),
                          shard: bool = True, avail=None,
                          tenant_spec: Optional[sched_mod.TenantSpec] = None,
                          device=None) -> FleetSummary:
    """Streaming :func:`simulate_fleet`: memory independent of the trace
    length.

    ``tables`` fields carry leading axes ``[..., M]`` that flatten into one
    fleet axis ``K``.  ``traces`` (one shared ``[S]`` trace or per-cell
    ``[..., S]``) and ``avail`` (the same rules; ``None`` is a healthy
    fleet) stay stride-0 numpy views: only a ``[K, C]`` chunk
    (``C = chunk_size``) is ever made dense and copied to the device, one
    copy per input per chunk.  The tail chunk runs just its remaining
    steps.  Per chunk the ``Summary`` sums accumulate in float32 on the
    device from zero and are added on the host in float64 afterwards.
    ``emit`` names per-step :class:`TraceResult` fields to keep as
    ``[..., S]`` host arrays in ``FleetSummary.emitted``.

    ``tenant_spec`` (shared ``[T]`` or per-cell ``lead + (T,)`` leaves)
    switches ``traces`` to a tenant plane, shared ``[S, T]`` or per-cell
    ``[..., S, T]``; ``cfg.scheduler`` then splits each step's capacity
    across tenants and shapes the provisioned bin, and per-tenant QoS lands
    in the ``tenant_*`` fields.  Without a spec the workload rides as one
    default tenant with the scheduler off, as :func:`simulate_fleet` runs.

    ``shard`` is accepted for the JAX package's signature: the port runs
    every cell on ``device`` (on one device the JAX package pads nothing
    either); sharding over several cards is not ported.
    """
    alias = {"violations": "violation"}
    emit = tuple(emit)
    emit_internal = tuple(alias.get(e, e) for e in emit)
    for e, ei in zip(emit, emit_internal):
        if ei not in _EMITTABLE:
            per_step = tuple(f for f in TraceResult._fields
                             if f not in ("mispredictions",
                                          "final_predictor"))
            raise ValueError(f"unknown emit field {e!r}; "
                             f"choose from {per_step}")
    dev = resolve_device(device)
    lead = tuple(tables.capacity.shape[:-1])
    k = int(np.prod(lead, dtype=np.int64)) if lead else 1
    flat = BinTables(*[x.to(dev).reshape((k,) + x.shape[len(lead):])
                       for x in tables])
    spec_in = tenant_spec if tenant_spec is not None \
        else sched_mod.default_tenants(1)
    t = spec_in.n_tenants
    if tenant_spec is None:
        traces = _broadcast_traces(np.asarray(traces), lead)[..., None]
    else:
        traces = _broadcast_tenant_traces(np.asarray(traces), lead, t)
    s = traces.shape[-2]
    avail_full = _broadcast_avail(avail, lead, cfg.n_nodes, s)
    c = max(1, min(int(chunk_size), s))
    scfg = cfg.scheduler if tenant_spec is not None \
        else sched_mod.SCHEDULERS["none"]
    sched = sched_mod.scheduler_values(scfg, dev)
    spec = _flatten_tenant_spec(spec_in, lead, k, dev)
    any_headroom = bool((flat.headroom > 0).any())
    # A healthy fleet's schedule is one constant row for every step.
    av_const = (torch.full((k,), float(cfg.n_nodes), device=dev)
                if avail is None else None)

    zk = torch.zeros(k, device=dev)
    zt = torch.zeros((k, t), device=dev)
    acc = _StreamAcc(mstate=pred_mod.init_state(cfg.predictor, k, dev),
                     astate=pred_mod.init_state(cfg.avail_predictor, k, dev),
                     backlog=zt, place=zt, power_sum=zk, viol_sum=zk,
                     backlog_sum=zk, offered_sum=zk, avail_sum=zk,
                     t_viol_sum=zt, t_starve_sum=zt, t_served_sum=zt,
                     t_offered_sum=zt)
    sum_fields = _StreamAcc._fields[4:]
    sums = {f: np.zeros(tuple(getattr(acc, f).shape), np.float64)
            for f in sum_fields}
    emitted = {e: [] for e in emit}
    for s0 in range(0, s, c):
        # Slicing the step axis keeps the stride-0 view: only k·C elements
        # (k·C·T for a tenant plane) are made dense, then copied once.
        chunk = torch.from_numpy(
            np.array(traces[..., s0:s0 + c, :]).reshape(k, -1, t)).to(dev)
        av = av_const if av_const is not None else torch.from_numpy(
            np.array(avail_full[..., s0:s0 + c]).reshape(k, -1)).to(dev)
        acc, ys = _stream_chunk(flat, cfg, acc, chunk, av, spec, sched,
                                any_headroom, emit_internal)
        for f in sum_fields:
            sums[f] += getattr(acc, f).cpu().numpy().astype(np.float64)
        for e, ei in zip(emit, emit_internal):
            emitted[e].append(ys[ei].cpu().numpy())

    def cut(x):
        x = np.asarray(x)
        return x.reshape(lead + x.shape[1:])

    backlog = acc.backlog.cpu().numpy().astype(np.float64)
    served = sums["offered_sum"] - backlog.sum(-1)
    mstate = _tree_map(lambda x: x.cpu().numpy(), _unflatten(acc.mstate, lead))
    return FleetSummary(
        mean_power_w=cut(sums["power_sum"] / s),
        qos_violation_rate=cut(sums["viol_sum"] / s),
        served_fraction=cut(served / np.maximum(sums["offered_sum"], 1e-9)),
        mean_backlog=cut(sums["backlog_sum"] / s),
        final_backlog=cut(backlog.sum(-1)),
        offered=cut(sums["offered_sum"]),
        mispredictions=mstate.mispredictions,
        n_steps=s,
        final_predictor=mstate,
        emitted={e: cut(np.concatenate(v, axis=-1))
                 for e, v in emitted.items()},
        mean_avail_nodes=cut(sums["avail_sum"] / s),
        margin_misses=mstate.margin_misses,
        tenant_qos_violation_rate=cut(sums["t_viol_sum"] / s),
        tenant_starvation_rate=cut(sums["t_starve_sum"] / s),
        tenant_served_fraction=cut(sums["t_served_sum"] / np.maximum(
            sums["t_offered_sum"], 1e-9)),
        tenant_final_backlog=cut(backlog))
