"""The §V DVFS controller over a fleet of platforms (paper Fig. 9).

Port of the materialized fleet path of ``repro.core.controller``:

  workload counter → predictor → frequency selector → voltage lookup into
  the per-bin operating table precomputed at synthesis time → PLL → rails.

* :func:`fleet_bin_tables` builds every (platform × technique) table with
  one fused grid sweep (``kernels.grid_argmin``: the CUDA kernel on the
  card, its plain PyTorch version on the CPU), plus the hybrid gear argmin
  and the closed forms for nominal and power gating;
* :func:`simulate_fleet` runs the runtime loop for every fleet cell at
  once: one control step over ``[K]``-batched tensors that never leave
  the device until the last step, replayed once a step;
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
  loop, and memory never grows with the trace length;
* the three fleet programs (the table sweep, the materializing loop, the
  streaming chunk) are built once per key, as the JAX package's jits are
  compiled, and counted by :func:`fleet_trace_counts`; on the card the
  two loops' programs are the control step captured as a CUDA graph.

Entry points take ``device``: ``None`` means the CUDA card and raises on
a machine without one; ``"cpu"`` runs the plain path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.core import characterization as char
from repro_torch.core import pll as pll_mod
from repro_torch.core import predictors as pred_mod
from repro_torch.core import scheduler as sched_mod
from repro_torch.core import voltage as volt_mod
from repro_torch.core.accelerators import Accelerator
from repro_torch.device import resolve_device
from repro_torch.kernels.grid_argmin import grid_argmin
from repro_torch.parallel import sharding as shd

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


class WeakLeaf(torch.Tensor):
    """A table field the JAX package builds weakly typed (from a Python
    scalar: ``jnp.full``, a product with a Python float).  A jit key holds
    each input's weak type, so two same-shaped tables whose fields differ
    in it are two programs there (a geared technique's ``headroom`` is
    weak, power gating's is not).  The port keys its fleet programs on the
    same flag (:func:`_signature`), carried by this subclass through views
    and ops as JAX carries it: an op's result is weak only where every
    tensor it reads is.  Values and arithmetic are a plain tensor's."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        if not ins or not all(isinstance(x, WeakLeaf) for x in ins):
            return out
        return tree_map(lambda x: x.as_subclass(WeakLeaf)
                        if isinstance(x, torch.Tensor) and not isinstance(x, WeakLeaf) else x,
                        out)


#: The fields of each technique's tables that the JAX package's
#: ``fleet_bin_tables`` makes weakly typed; a stacked field is weak where
#: every technique's is.
_WEAK_FIELDS = {
    **dict.fromkeys(("proposed", "core_only", "bram_only", "freq_only"),
                    ("capacity", "v_core", "v_bram", "f_rel", "n_active")),
    "power_gating": ("v_core", "v_bram"),
    "nominal": ("v_core", "v_bram", "n_active"),
    "hybrid": ("v_core", "v_bram", "headroom"),
    "headroom": ("v_core", "v_bram", "headroom"),
}


def _weak_fields(tables: BinTables, technique: str) -> BinTables:
    """``tables`` with ``_WEAK_FIELDS[technique]`` marked weak."""
    return tables._replace(**{f: getattr(tables, f).as_subclass(WeakLeaf)
                              for f in _WEAK_FIELDS[technique]})


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
    (one ``grid_argmin`` launch, the "tables" program, keyed on the
    shapes of the stacked params, the row masks and levels and the grids);
    nominal and power gating are closed forms in the platform's nominal
    watts.
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
        ins = (params, row_masks.to(dev), row_levels.to(dev), grids.core, grids.bram)
        # the "tables" program is one grid_argmin launch (B1), made directly
        pts = _program("tables", (ins[1].device, _signature(*ins)), lambda: grid_argmin)(*ins)
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

    per_tech = {t: _weak_fields(x, t) for t, x in per_tech.items()}
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
                  spec: sched_mod.TenantSpec, sched: torch.Tensor
                  ) -> Tuple[_Carry, _StepOut]:
    """One §V control step for all ``K`` cells: predict → schedule-shape →
    select → clamp to availability → serve → observe.

    ``w_t`` is ``[K, T]`` offered work per tenant and ``avail_t`` ``[K]``
    usable nodes.  A step violates QoS when its demand (offered work plus
    carried backlog; only admitted work with the scheduler on) exceeds the
    delivered capacity.  The headroom bump always runs, as in the JAX
    package: it leaves every bin of a cell without headroom unchanged, and
    the step reads no value on the host.
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


# ---------------------------------------------------------------------------
# The fleet's programs: one per (shapes, static config) key
# ---------------------------------------------------------------------------
#
# The JAX package jit-compiles three fleet programs, each once per key (the
# shapes of its inputs and the static ``ControllerConfig``), and counts its
# traces (``fleet_trace_counts``).  The port builds one program per such
# key and keeps it for the life of the process: on the card the §V control
# step is captured as a CUDA graph over the program's static buffers and
# replayed once a step, the step index a device tensor the graph reads and
# advances; on the CPU the same step runs eagerly on the same buffers.  A
# call copies its values into the buffers and gets copies of the outputs
# back (the next replay overwrites the buffers).  The tables program is one
# ``grid_argmin`` launch, made from the keyed program directly.

_TRACE_COUNTS = {"tables": 0, "simulate": 0, "stream": 0}
_PROGRAMS: Dict[str, dict] = {kind: {} for kind in _TRACE_COUNTS}
_EAGER = [False]
#: dtypes of the per-step fields that are not float32.
_STEP_DTYPES = {"violation": torch.bool, "predicted_bin": torch.long,
                "actual_bin": torch.long, "tenant_violation": torch.bool,
                "tenant_starved": torch.bool}


def _step_buffer(field: str, k: int, n_tenants: int, n_steps: int,
                 dev: torch.device) -> torch.Tensor:
    """A program's buffer of one per-step field: ``[K, S]``, a tenant
    field ``[K, T, S]``."""
    lead = (k, n_tenants) if field.startswith("tenant_") else (k,)
    return torch.zeros(lead + (n_steps,), dtype=_STEP_DTYPES.get(field, torch.float32),
                       device=dev)


def _runtime_cfg(cfg: ControllerConfig) -> ControllerConfig:
    """The static part of the runtime programs' key: the technique only
    changed the tables, the scheduler rides as values and headroom's
    fraction lives in ``BinTables.headroom``, so none of them may split the
    program cache.  The predictor configs stay (a program per family), as
    in the JAX package.  Shared with the warmer (``core.aot``)."""
    return dataclasses.replace(cfg, technique="proposed", scheduler="none",
                               headroom_frac=0.0)


def fleet_trace_counts() -> Dict[str, int]:
    """Programs built in this process for each of the three fleet programs:
    ``{"tables", "simulate", "stream"}`` — the grid sweep of
    :func:`fleet_bin_tables`, the materializing loop of
    :func:`simulate_fleet` and the chunk of :func:`simulate_fleet_stream`.

    The counterpart of the JAX package's trace counters, keyed as its jits
    are: on the input shapes plus the static config (:func:`_runtime_cfg`),
    never on platform constants, trace values, the scheduler or the
    technique; the port adds the device.  Sweeping new accelerators, seeds,
    scenarios or replayed traces at the same fleet shape ``[K]``, chunk
    ``C`` and config leaves the counts unchanged.  On the card each
    runtime program is a captured CUDA graph; on the CPU it is the eager
    step, counted the same way."""
    return dict(_TRACE_COUNTS)


@contextlib.contextmanager
def eager_step_loops():
    """Run the card's captured steps eagerly inside this context: the same
    ops on the same buffers, launched one by one instead of replayed, to
    hold the graphs against the eager loop.  Programs are built and
    counted as outside it."""
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = False


def _leaves(tree) -> list:
    """The tensors of a (nested) NamedTuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _signature(*trees) -> tuple:
    """Shape, dtype and weak flag (:class:`WeakLeaf`) of every tensor of
    ``trees``: the abstract values a jit key holds."""
    return tuple((tuple(x.shape), x.dtype, isinstance(x, WeakLeaf))
                 for tree in trees for x in _leaves(tree))


def _program(kind: str, key: tuple, build):
    """The ``kind`` program of ``key``, built (and counted) on first use."""
    cache = _PROGRAMS[kind]
    prog = cache.get(key)
    if prog is None:
        prog = cache[key] = build()
        _TRACE_COUNTS[kind] += 1
    return prog


def _buffers(tree, dev):
    """Static buffers holding a copy of ``tree``'s tensors on ``dev``."""
    return _tree_map(lambda x: x.detach().as_subclass(torch.Tensor)
                     .to(dev, copy=True).contiguous(), tree)


def _copy_into(dst, src) -> None:
    for d, x in zip(_leaves(dst), _leaves(src)):
        d.copy_(x)


class _StepLoop:
    """``step`` (a function of no arguments that reads and writes static
    buffers) run ``n`` times a call: on a CUDA device captured once as a
    CUDA graph, after one warm-up run on a side stream, and replayed; on
    the CPU called eagerly.  A capture that fails, or captures nothing,
    raises."""

    def __init__(self, step, dev: torch.device):
        self.step, self.dev, self.graph = step, dev, None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    step()
                torch.cuda.current_stream(dev).wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                # a capture stream of this device (the default one is made once,
                # on the first device that captures); an empty graph is an error
                with warnings.catch_warnings():
                    warnings.filterwarnings("error", message="The CUDA Graph is empty")
                    with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev),
                                          capture_error_mode="thread_local"):
                        step()

    def run(self, n: int) -> None:
        if self.graph is None or _EAGER[0]:
            for _ in range(n):
                self.step()
            return
        with torch.cuda.device(self.dev):
            for _ in range(n):
                self.graph.replay()


class _SimulateProgram:
    """``_simulate_fleet_jit``'s counterpart: the §V loop over ``[K]``
    cells, tables ``[K, M]``, traces and availability ``[K, S]``, every
    per-step field kept as ``[K, S]``.  Aggregate only: each trace rides
    as one default tenant with the scheduler off."""

    def __init__(self, cfg: ControllerConfig, tables: BinTables,
                 traces: torch.Tensor, avail: torch.Tensor):
        dev = traces.device
        k, s = traces.shape
        self.cfg = cfg
        self.tables, self.traces, self.avail = (_buffers(x, dev)
                                                for x in (tables, traces, avail))
        self.spec = sched_mod.default_tenants(1).to(dev)
        self.sched = sched_mod.scheduler_values(sched_mod.SCHEDULERS["none"], dev)
        self.init = (pred_mod.init_state(cfg.predictor, k, dev),
                     pred_mod.init_state(cfg.avail_predictor, k, dev),
                     torch.zeros((k, 1), device=dev), torch.zeros((k, 1), device=dev))
        self.carry = _buffers(self.init, dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.outs = {e: _step_buffer(e, k, 1, s, dev) for e in _EMITTABLE}
        self.loop = _StepLoop(self._step, dev)

    def _step(self) -> None:
        t = self.t
        carry, out = _control_step(self.tables, self.cfg, self.carry,
                                   self.traces.index_select(1, t),
                                   self.avail.index_select(1, t)[:, 0],
                                   self.spec, self.sched)
        for e in _EMITTABLE:
            self.outs[e].index_copy_(1, t, getattr(out, e)[:, None])
        _copy_into(self.carry, carry)
        t.add_(1)

    def __call__(self, tables: BinTables, traces: torch.Tensor,
                 avail: torch.Tensor) -> TraceResult:
        _copy_into((self.tables, self.traces, self.avail, self.carry),
                   (tables, traces, avail, self.init))
        self.t.zero_()
        self.loop.run(traces.shape[1])
        mstate = _tree_map(torch.clone, self.carry[0])
        steps = {e: x.clone() for e, x in self.outs.items()}
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
    ``cfg.n_nodes`` every step, the same ``[K, S]`` input).  Returns
    ``[..., S]`` fields on ``device``.  One program per key (the tables'
    ``[K, M]``, ``S``, the config's runtime part and the device;
    ``fleet_trace_counts()["simulate"]``).
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
    run_cfg = _runtime_cfg(cfg)
    prog = _program("simulate", (traces.device, run_cfg, _signature(flat, traces, avail)),
                    lambda: _SimulateProgram(run_cfg, flat, traces, avail))
    return _unflatten(prog(flat, traces, avail), lead)


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


def _tree_map(fn, x, *rest):
    """``fn`` on every tensor of a (nested) NamedTuple or tuple, or on the
    tensors at the same place in several of them."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    vals = [_tree_map(fn, *vs) for vs in zip(x, *rest)]
    return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)


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


class _StreamProgram:
    """``_fleet_stream_chunk_jit``'s counterpart: one chunk of ``C`` steps
    over ``[K]`` cells, the workload ``[K, C, T]``, availability ``[K, C]``
    (the tail chunk zero-padded), the ``[K, T]`` tenant spec and the
    scheduler vector as values.  The sums restart at zero each chunk;
    nothing goes back to the host."""

    def __init__(self, cfg: ControllerConfig, emit: Tuple[str, ...],
                 tables: BinTables, acc: _StreamAcc, chunk: torch.Tensor,
                 avail: torch.Tensor, spec: sched_mod.TenantSpec,
                 sched: torch.Tensor):
        dev = chunk.device
        self.cfg, self.emit = cfg, emit
        self.tables, self.acc, self.chunk, self.avail, self.spec, self.sched = (
            _buffers(x, dev) for x in (tables, acc, chunk, avail, spec, sched))
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        k, c, n_tenants = chunk.shape
        self.ys = {e: _step_buffer(e, k, n_tenants, c, dev) for e in emit}
        self.loop = _StepLoop(self._step, dev)

    def _step(self) -> None:
        t, acc, spec = self.t, self.acc, self.spec
        w_t = self.chunk.index_select(1, t)[:, 0]
        a_t = self.avail.index_select(1, t)[:, 0]
        (ms, ast, bl, pl), out = _control_step(
            self.tables, self.cfg, (acc.mstate, acc.astate, acc.backlog, acc.place),
            w_t, a_t, spec, self.sched)
        new = _StreamAcc(
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
        for e, y in self.ys.items():
            y.index_copy_(y.dim() - 1, t, getattr(out, e)[..., None])
        _copy_into(acc, new)
        t.add_(1)

    def __call__(self, tables: BinTables, acc: _StreamAcc, chunk: torch.Tensor,
                 avail: torch.Tensor, valid: np.ndarray, spec: sched_mod.TenantSpec,
                 sched: torch.Tensor) -> Tuple[_StreamAcc, Dict[str, torch.Tensor]]:
        """The chunk's carry and sums, and the ``emit`` fields ``[K, C]``.
        ``valid`` is the host ``[C]`` step mask, a prefix: the steps past it
        are not run, so they leave the carry and the sums as they are."""
        n = int(np.count_nonzero(valid))
        if not valid[:n].all():
            raise ValueError("the valid steps of a chunk must be a prefix")
        _copy_into((self.tables, self.acc, self.chunk, self.avail, self.spec, self.sched),
                   (tables, acc, chunk, avail, spec, sched))
        for f in _StreamAcc._fields[4:]:
            getattr(self.acc, f).zero_()
        self.t.zero_()
        self.loop.run(n)
        return (_tree_map(torch.clone, self.acc),
                {e: y.clone() for e, y in self.ys.items()})


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


def _fleet_mesh_of(shard):
    """The fleet mesh ``shard`` asks for: a mesh itself; ``True`` and
    ``False`` none (see :func:`simulate_fleet_stream`)."""
    if shard is True or shard is False or shard is None:
        return None
    return shard


def simulate_fleet_stream(tables: BinTables, traces, cfg: ControllerConfig,
                          chunk_size: int = 1024, emit: Sequence[str] = (),
                          shard=True, avail=None,
                          tenant_spec: Optional[sched_mod.TenantSpec] = None,
                          device=None) -> FleetSummary:
    """Streaming :func:`simulate_fleet`: memory independent of the trace
    length.

    ``tables`` fields carry leading axes ``[..., M]`` that flatten into one
    fleet axis ``K``.  ``traces`` (one shared ``[S]`` trace or per-cell
    ``[..., S]``) and ``avail`` (the same rules; ``None`` is a healthy
    fleet) stay stride-0 numpy views: only a ``[K, C]`` chunk
    (``C = chunk_size``) is ever made dense and copied to the device, one
    copy per input per chunk (a healthy fleet's ``[K, C]`` availability is
    made once).  The tail chunk is zero-padded to ``C`` under a valid mask,
    so it runs the same program; its steps past the trace are not run.
    Each chunk runs the "stream" program of its key (``K``, ``C``, the
    tenant width, ``emit``, the config's runtime part and the device;
    ``fleet_trace_counts()["stream"]``): on the card a captured CUDA graph
    of one step, replayed ``C`` times.  Per chunk the ``Summary`` sums
    accumulate in float32 on the device from zero and are added on the
    host in float64 afterwards.
    ``emit`` names per-step :class:`TraceResult` fields to keep as
    ``[..., S]`` host arrays in ``FleetSummary.emitted``.

    ``tenant_spec`` (shared ``[T]`` or per-cell ``lead + (T,)`` leaves)
    switches ``traces`` to a tenant plane, shared ``[S, T]`` or per-cell
    ``[..., S, T]``; ``cfg.scheduler`` then splits each step's capacity
    across tenants and shapes the provisioned bin, and per-tenant QoS lands
    in the ``tenant_*`` fields.  Without a spec the workload rides as one
    default tenant with the scheduler off, as :func:`simulate_fleet` runs.

    **Sharding.**  A ``FleetMesh`` (``parallel.sharding.fleet_mesh()``
    over every local card, or ``fleet_mesh(devices=[...])``) splits ``K``
    over its devices.  Cells are independent, so each device streams its
    own slice of ``K`` with no collective, and the tables and spec move to
    it once.  ``K`` is padded to a multiple of the device count as the
    reference pads it (tables edge-padded, trace and availability rows and
    spec rows copied from cell 0), and the padding is cut off every
    result.  Each chunk is issued on every device before any sum is read
    back; the memory bound is ``[K / d, C]`` a device.

    ``shard=True`` (the reference's default, which splits over every local
    device) runs on ``device``, as ``False`` does: each device runs its own
    program, and a slice's step takes as long on its card as the whole
    fleet's does on one (the step is a fixed count of small kernels), so
    on 4 × H100 the default campaign at 2048 steps took 1.28 s split
    against 1.16 s on one card.
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
    spec = _flatten_tenant_spec(spec_in, lead, k, dev)
    run_cfg = _runtime_cfg(cfg)

    mesh = _fleet_mesh_of(shard)
    devices = mesh.devices if mesh is not None else (dev,)
    k_pad = -(-k // len(devices)) * len(devices)
    if k_pad != k:
        pad = k_pad - k
        flat = BinTables(*[torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
                           for x in flat])
        spec = sched_mod.TenantSpec(*[torch.cat([x, x[:1].expand(pad, t)]) for x in spec])
    if mesh is not None:
        rules = shd.fleet_rules(mesh)
        parts = list(zip(devices, shd.shard_fleet(flat, rules), shd.shard_fleet(spec, rules)))
    else:
        parts = [(dev, flat, spec)]
    rows = k_pad // len(parts)

    def host_chunk(x: np.ndarray, s0: int) -> np.ndarray:
        """Steps ``s0 : s0 + c`` of ``lead + (S, ...)`` rows as ``[k_pad, c,
        ...]``: padded to ``k_pad`` rows with cell 0, and the tail chunk
        with zero steps to ``c``.  Slicing the step axis keeps a stride-0
        view: only k·C elements (k·C·T for a tenant plane) are made dense."""
        x = np.array(x[..., s0:s0 + c, :] if x.ndim > len(lead) + 1 else x[..., s0:s0 + c])
        x = x.reshape((k,) + x.shape[len(lead):])
        if x.shape[1] < c:
            x = np.concatenate([x, np.zeros((k, c - x.shape[1]) + x.shape[2:], x.dtype)], 1)
        if k_pad == k:
            return x
        return np.concatenate([x, np.broadcast_to(x[:1], (k_pad - k,) + x.shape[1:])])

    states = []
    for d, _, _ in parts:
        zk = torch.zeros(rows, device=d)
        zt = torch.zeros((rows, t), device=d)
        states.append(_StreamAcc(
            mstate=pred_mod.init_state(cfg.predictor, rows, d),
            astate=pred_mod.init_state(cfg.avail_predictor, rows, d),
            backlog=zt, place=zt, power_sum=zk, viol_sum=zk, backlog_sum=zk,
            offered_sum=zk, avail_sum=zk, t_viol_sum=zt, t_starve_sum=zt,
            t_served_sum=zt, t_offered_sum=zt))
    scheds = [sched_mod.scheduler_values(scfg, d) for d, _, _ in parts]
    # A healthy fleet's schedule: one [rows, C] chunk of n_nodes, made once.
    av_const = ([torch.full((rows, c), float(cfg.n_nodes), device=d) for d, _, _ in parts]
                if avail is None else None)

    sum_fields = _StreamAcc._fields[4:]
    sums = {f: np.zeros((k_pad,) + tuple(getattr(states[0], f).shape[1:]), np.float64)
            for f in sum_fields}
    emitted = {e: [] for e in emit}
    for s0 in range(0, s, c):
        n_valid = min(c, s - s0)
        valid = np.arange(c) < n_valid
        chunk = host_chunk(traces, s0)
        av = None if av_const is not None else host_chunk(avail_full, s0)
        ys_parts = []
        for i, (d, ftab, fspec) in enumerate(parts):    # every device's chunk first
            ins = (ftab, states[i], torch.from_numpy(chunk[i * rows:(i + 1) * rows]).to(d),
                   av_const[i] if av_const is not None
                   else torch.from_numpy(av[i * rows:(i + 1) * rows]).to(d))
            key = (ins[2].device, run_cfg, emit_internal, _signature(*ins, fspec, scheds[i]))
            prog = _program("stream", key, lambda: _StreamProgram(
                run_cfg, emit_internal, *ins, fspec, scheds[i]))
            states[i], ys = prog(*ins, valid, fspec, scheds[i])
            ys_parts.append(ys)
        for f in sum_fields:                             # then read the sums
            sums[f] += np.concatenate([getattr(a, f).cpu().numpy() for a in states]
                                      ).astype(np.float64)
        for e, ei in zip(emit, emit_internal):
            emitted[e].append(np.concatenate([ys[ei][:, :n_valid].cpu().numpy()
                                              for ys in ys_parts]))

    def cut(x):
        x = np.asarray(x)[:k]
        return x.reshape(lead + x.shape[1:])

    backlog = np.concatenate([a.backlog.cpu().numpy() for a in states]).astype(np.float64)
    served = sums["offered_sum"] - backlog.sum(-1)
    mstate = _tree_map(lambda *xs: cut(np.concatenate([x.cpu().numpy() for x in xs])),
                       *[a.mstate for a in states])
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
