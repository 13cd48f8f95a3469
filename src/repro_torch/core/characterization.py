"""Delay/power-vs-voltage library and array-parameterized platforms.

Port of ``repro.core.characterization`` (paper Figs. 1-3): the same
alpha-power-law delay, ``C·V²·f`` dynamic power and
``V·exp(κ(V−V0))`` static power, the same fitted constants, and the same
padded ``PlatformParams`` term arrays — so both packages compute on
identical constants.

Platform constructors run on the host and return CPU tensors: they are
constant tables, like numpy arrays.  The fleet entry points
(``controller.fleet_bin_tables`` and friends) move them to their device.
Everything is float32, as the JAX package runs with x64 off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Rails
# ---------------------------------------------------------------------------

#: Nominal rail voltages (V).  §III: core 0.8 V, BRAM 0.95 V.
V_CORE_NOM: float = 0.80
V_BRAM_NOM: float = 0.95
#: Crash voltage — lowest safe operating point for either scalable rail.
V_CRASH: float = 0.50
#: DC-DC converter resolution (25 mV, ref. [39] in the paper).
V_STEP: float = 0.025

F32 = torch.float32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


@dataclasses.dataclass(frozen=True)
class Rail:
    """A supply rail with its scaling range."""

    name: str
    v_nominal: float
    v_min: float
    v_max: float
    scalable: bool = True

    def grid(self, step: float = V_STEP) -> torch.Tensor:
        """All voltage set-points for this rail (ascending, ends at nominal).

        Anchored at ``v_max`` so ``grid[-1]`` is exactly the nominal point
        for any ``step``; a step that does not divide the range shortens
        the bottom end.
        """
        if not self.scalable:
            return _f32([self.v_nominal])
        n = int(np.floor((self.v_max - self.v_min) / step + 1e-9)) + 1
        return self.v_max - step * torch.arange(n - 1, -1, -1, dtype=F32)


CORE_RAIL = Rail("core", V_CORE_NOM, V_CRASH, V_CORE_NOM)
BRAM_RAIL = Rail("bram", V_BRAM_NOM, V_CRASH, V_BRAM_NOM)
IO_RAIL = Rail("io", 1.5, 1.5, 1.5, scalable=False)
CONFIG_RAIL = Rail("config", 1.0, 1.0, 1.0, scalable=False)


# ---------------------------------------------------------------------------
# Per-resource characterization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResourceChar:
    """Delay/power characterization of one resource class on one rail.

    ``D(V) = [V / (V - vth)^alpha] / [V0 / (V0 - vth)^alpha]``;
    ``P_dyn = p_dyn0·(V/V0)²·f_rel``;
    ``P_stat = p_stat0·(V/V0)·exp(kappa·(V - V0))``, scaled by
    ``p_stat_idle_frac`` for unconfigured units.
    """

    name: str
    rail: str
    vth: float
    alpha: float
    p_dyn0: float
    p_stat0: float
    kappa: float
    p_stat_idle_frac: float = 1.0

    def v_nominal(self) -> float:
        return {"core": V_CORE_NOM, "bram": V_BRAM_NOM,
                "io": IO_RAIL.v_nominal, "config": CONFIG_RAIL.v_nominal}[self.rail]

    def delay_factor(self, v: torch.Tensor) -> torch.Tensor:
        v0 = self.v_nominal()
        num = v / torch.clamp(v - self.vth, min=1e-6) ** self.alpha
        den = v0 / (v0 - self.vth) ** self.alpha
        return num / den

    def dynamic_power(self, v: torch.Tensor, f_rel: torch.Tensor) -> torch.Tensor:
        x = v / self.v_nominal()
        return self.p_dyn0 * (x * x) * f_rel

    def static_power(self, v: torch.Tensor, *, idle: bool = False) -> torch.Tensor:
        v0 = self.v_nominal()
        p = self.p_stat0 * (v / v0) * torch.exp(self.kappa * (v - v0))
        return p * self.p_stat_idle_frac if idle else p

    def total_power(self, v: torch.Tensor, f_rel: torch.Tensor) -> torch.Tensor:
        return self.dynamic_power(v, f_rel) + self.static_power(v)


# Constants fitted against every Table II cell (scripts/fit_library.py in
# the JAX package); kept verbatim so both packages share one model.
FPGA_LIBRARY: Dict[str, ResourceChar] = {
    "logic": ResourceChar("logic", "core", vth=0.34, alpha=1.40,
                          p_dyn0=24.64, p_stat0=0.1125, kappa=3.0,
                          p_stat_idle_frac=0.3272),
    "routing": ResourceChar("routing", "core", vth=0.24, alpha=1.15,
                            p_dyn0=30.72, p_stat0=0.165, kappa=3.0,
                            p_stat_idle_frac=0.3272),
    "dsp": ResourceChar("dsp", "core", vth=0.30, alpha=1.30,
                        p_dyn0=12.8, p_stat0=1.344, kappa=3.0,
                        p_stat_idle_frac=0.35),
    "memory": ResourceChar("memory", "bram", vth=0.38, alpha=1.10,
                           p_dyn0=102.4, p_stat0=2.856, kappa=10.2,
                           p_stat_idle_frac=0.2499),
    "memory_l": ResourceChar("memory_l", "bram", vth=0.38, alpha=1.10,
                             p_dyn0=768.0, p_stat0=21.42, kappa=10.2,
                             p_stat_idle_frac=0.2499),
    "io": ResourceChar("io", "io", vth=0.45, alpha=1.0,
                       p_dyn0=11.2, p_stat0=0.0125, kappa=4.0,
                       p_stat_idle_frac=0.02),
    "config": ResourceChar("config", "config", vth=0.55, alpha=1.0,
                           p_dyn0=0.0, p_stat0=0.01, kappa=3.0,
                           p_stat_idle_frac=1.0),
}

#: Composition of the non-memory part of a typical FPGA critical path.
CORE_PATH_MIX: Dict[str, float] = {"logic": 0.35, "routing": 0.55, "dsp": 0.10}


def core_delay_factor(v_core: torch.Tensor,
                      mix: Mapping[str, float] | None = None) -> torch.Tensor:
    """Weighted delay factor of the core-rail share of the critical path
    (the closure path's; ``fpga_platform_params`` folds the same weights)."""
    mix = dict(CORE_PATH_MIX if mix is None else mix)
    total = sum(mix.values())
    acc = 0.0
    for name, w in mix.items():
        acc = acc + (w / total) * FPGA_LIBRARY[name].delay_factor(v_core)
    return acc


def bram_delay_factor(v_bram: torch.Tensor) -> torch.Tensor:
    return FPGA_LIBRARY["memory"].delay_factor(v_bram)


# ---------------------------------------------------------------------------
# Device sizing (VTR-style smallest square fabric, §VI)
# ---------------------------------------------------------------------------

IO_SIGNALS_PER_PAD = 4
IO_PADS_PER_TILE = 2
TILE_FRAC_M9K = 0.10
TILE_FRAC_M144K = 0.004
TILE_FRAC_DSP = 0.05


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    labs: int
    dsps: int
    m9ks: int
    m144ks: int
    io: int


@dataclasses.dataclass(frozen=True)
class Utilization:
    """Post-P&R resource usage of one application (paper Table I)."""

    labs: int
    dsps: int
    m9ks: int
    m144ks: int
    io: int
    f_mhz: float


def vtr_device(util: Utilization, name: str = "auto") -> Device:
    """Smallest square fabric fitting the design (VTR's auto-sizing, §VI)."""
    sig_per_side = 4 * IO_PADS_PER_TILE * IO_SIGNALS_PER_PAD

    def fits(w: int) -> bool:
        tiles = w * w
        io = 4 * w * IO_PADS_PER_TILE * IO_SIGNALS_PER_PAD
        m9k = int(tiles * TILE_FRAC_M9K)
        m144k = int(tiles * TILE_FRAC_M144K)
        dsp = int(tiles * TILE_FRAC_DSP)
        labs = tiles - m9k - m144k - dsp
        return (io >= util.io and m9k >= util.m9ks and m144k >= util.m144ks
                and dsp >= util.dsps and labs >= util.labs)

    w = max(4, int(np.ceil(util.io / sig_per_side / 4)) if util.io else 4)
    while not fits(w):
        w += 1
    tiles = w * w
    m9k = int(tiles * TILE_FRAC_M9K)
    m144k = int(tiles * TILE_FRAC_M144K)
    dsp = int(tiles * TILE_FRAC_DSP)
    return Device(name=f"{name}-w{w}",
                  labs=tiles - m9k - m144k - dsp, dsps=dsp, m9ks=m9k,
                  m144ks=m144k, io=4 * w * IO_PADS_PER_TILE * IO_SIGNALS_PER_PAD)


@dataclasses.dataclass(frozen=True)
class AppPowerModel:
    """Closed-form device power as a function of (V_core, V_bram, f_rel)."""

    util: Utilization
    device: Device
    activity: float = 0.125

    def _counts(self) -> Dict[str, Tuple[float, float]]:
        """resource → (used_units, idle_units)."""
        u, d = self.util, self.device
        return {
            "logic": (float(u.labs), float(d.labs - u.labs)),
            "routing": (float(u.labs), float(d.labs - u.labs)),
            "dsp": (float(u.dsps), float(d.dsps - u.dsps)),
            "memory": (float(u.m9ks), float(d.m9ks - u.m9ks)),
            "memory_l": (float(u.m144ks), float(d.m144ks - u.m144ks)),
            "io": (float(u.io), float(d.io - u.io)),
            "config": (float(d.labs + 8 * d.dsps + 4 * d.m9ks), 0.0),
        }

    def power(self, v_core: torch.Tensor, v_bram: torch.Tensor,
              f_rel: torch.Tensor) -> torch.Tensor:
        """Total device power (arbitrary units) at an operating point."""
        rails = {"core": v_core, "bram": v_bram}
        total = 0.0
        for name, (used, idle) in self._counts().items():
            res = FPGA_LIBRARY[name]
            v = rails.get(res.rail, _f32(res.v_nominal()))
            dyn = used * self.activity * res.dynamic_power(v, f_rel)
            stat = used * res.static_power(v) + idle * res.static_power(v, idle=True)
            total = total + dyn + stat
        return total

    def nominal_power(self) -> torch.Tensor:
        return self.power(_f32(V_CORE_NOM), _f32(V_BRAM_NOM), _f32(1.0))

    def power_breakdown(self, v_core, v_bram, f_rel) -> Dict[str, torch.Tensor]:
        """Each resource's power (Eq. 3 bookkeeping); they sum to :meth:`power`."""
        rails = {"core": v_core, "bram": v_bram}
        out: Dict[str, torch.Tensor] = {}
        for name, (used, idle) in self._counts().items():
            res = FPGA_LIBRARY[name]
            v = rails.get(res.rail, _f32(res.v_nominal()))
            dyn = used * self.activity * res.dynamic_power(v, f_rel)
            stat = used * res.static_power(v) + idle * res.static_power(v, idle=True)
            out[name] = dyn + stat
        return out

    def beta(self) -> float:
        """The paper's β: BRAM-rail power relative to core-rail power at nominal."""
        bd = self.power_breakdown(_f32(V_CORE_NOM), _f32(V_BRAM_NOM), _f32(1.0))
        mem = float(bd["memory"] + bd["memory_l"])
        core = float(bd["logic"] + bd["routing"] + bd["dsp"])
        return mem / core


# ---------------------------------------------------------------------------
# TPU adaptation library (v5e-class chip model, kept for tpu_platform_params)
# ---------------------------------------------------------------------------

TPU_LIBRARY: Dict[str, ResourceChar] = {
    "core": ResourceChar("core", "core", vth=0.31, alpha=1.35,
                         p_dyn0=0.62, p_stat0=0.38, kappa=6.5),
    "hbm": ResourceChar("hbm", "bram", vth=0.42, alpha=1.20,
                        p_dyn0=0.70, p_stat0=0.30, kappa=7.5),
    "uncore": ResourceChar("uncore", "config", vth=0.45, alpha=1.0,
                           p_dyn0=0.05, p_stat0=0.10, kappa=3.0),
}


@dataclasses.dataclass(frozen=True)
class TpuChipPowerModel:
    """Two scalable domains (core, HBM) plus an always-on uncore."""

    w_core: float = 0.55
    w_hbm: float = 0.30
    w_uncore: float = 0.15

    def power(self, v_core, v_hbm, f_core_rel, f_hbm_rel) -> torch.Tensor:
        core, hbm, unc = (TPU_LIBRARY["core"], TPU_LIBRARY["hbm"],
                          TPU_LIBRARY["uncore"])
        v_unc = _f32(unc.v_nominal())
        p_core = self.w_core * (core.dynamic_power(v_core, f_core_rel)
                                + core.static_power(v_core))
        p_hbm = self.w_hbm * (hbm.dynamic_power(v_hbm, f_hbm_rel)
                              + hbm.static_power(v_hbm))
        p_unc = self.w_uncore * (unc.dynamic_power(v_unc, f_core_rel)
                                 + unc.static_power(v_unc))
        return p_core + p_hbm + p_unc

    def nominal_power(self) -> torch.Tensor:
        one = _f32(1.0)
        return self.power(_f32(V_CORE_NOM), _f32(V_BRAM_NOM), one, one)


def tpu_core_delay_factor(v: torch.Tensor) -> torch.Tensor:
    return TPU_LIBRARY["core"].delay_factor(v)


def tpu_hbm_delay_factor(v: torch.Tensor) -> torch.Tensor:
    return TPU_LIBRARY["hbm"].delay_factor(v)


# ---------------------------------------------------------------------------
# Array-parameterized platforms (the fleet path)
# ---------------------------------------------------------------------------
#
#   delay(Vc, Vb)    = combine_i  w_i · D(V_rail_i; vth_i, alpha_i, v0_i)
#   power(Vc, Vb, f) = Σ_i dyn_i·(V/v0)²·f + stat_i·(V/v0)·exp(κ_i·(V−v0))
#
# ``combine`` is Σ (FPGA serial critical path, Eq. 1) or max (TPU
# roofline).  Padding terms carry zero weight and are inert.

RAIL_CORE, RAIL_BRAM, RAIL_FIXED = 0, 1, 2

#: Padded term counts, equal to the JAX package's so shapes line up.
DELAY_TERMS_PAD = 4
POWER_TERMS_PAD = 8


class PlatformParams(NamedTuple):
    """One platform's delay/power model as tensors.

    Leaves may carry leading batch axes; ``stack_platform_params`` builds
    a fleet whose leaves are ``[K, ...]``.  Rails and ``delay_mode`` are
    int32, everything else float32.
    """

    dl_weight: torch.Tensor
    dl_vth: torch.Tensor
    dl_alpha: torch.Tensor
    dl_v0: torch.Tensor
    dl_rail: torch.Tensor      # int32 — RAIL_CORE / RAIL_BRAM
    delay_mode: torch.Tensor   # int32 — 0: sum (Eq. 1), 1: max (roofline)
    pw_rail: torch.Tensor      # int32 — RAIL_CORE / RAIL_BRAM / RAIL_FIXED
    pw_v0: torch.Tensor
    pw_dyn: torch.Tensor
    pw_stat: torch.Tensor
    pw_kappa: torch.Tensor
    nominal_power_arb: torch.Tensor
    watts_scale: torch.Tensor  # watts per arbitrary power unit

    def to(self, device) -> "PlatformParams":
        return PlatformParams(*[x.to(device) for x in self])


#: Fields that hold integer codes rather than floats.
INT_FIELDS = ("dl_rail", "delay_mode", "pw_rail")


def sum_terms(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (term) axis in index order.

    A fixed left-to-right order keeps the plain version, the CUDA kernel
    and the CPU run on one rounding sequence.
    """
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def params_delay(p: PlatformParams, v_core, v_bram) -> torch.Tensor:
    """Normalized critical-path / step delay (1.0 at nominal rails).

    Leaves ``[*L, D]`` broadcast right-aligned against ``v[..., None]``.
    """
    dev = p.dl_rail.device
    vc, vb = torch.broadcast_tensors(_f32(v_core, dev), _f32(v_bram, dev))
    v = torch.where(p.dl_rail == RAIL_CORE, vc[..., None], vb[..., None])
    num = v / torch.clamp(v - p.dl_vth, min=1e-6) ** p.dl_alpha
    den = p.dl_v0 / (p.dl_v0 - p.dl_vth) ** p.dl_alpha
    d = p.dl_weight * (num / den)
    return torch.where(p.delay_mode == 1, d.amax(-1), sum_terms(d))


def params_power(p: PlatformParams, v_core, v_bram, f_rel) -> torch.Tensor:
    """Platform power (arbitrary units) at an operating point."""
    dev = p.pw_rail.device
    vc, vb, f = torch.broadcast_tensors(_f32(v_core, dev), _f32(v_bram, dev),
                                        _f32(f_rel, dev))
    v = torch.where(p.pw_rail == RAIL_CORE, vc[..., None],
                    torch.where(p.pw_rail == RAIL_BRAM, vb[..., None], p.pw_v0))
    x = v / p.pw_v0
    dyn = p.pw_dyn * (x * x) * f[..., None]
    stat = p.pw_stat * x * torch.exp(p.pw_kappa * (v - p.pw_v0))
    return sum_terms(dyn + stat)


def params_power_watts(p: PlatformParams, v_core, v_bram, f_rel) -> torch.Tensor:
    return params_power(p, v_core, v_bram, f_rel) * p.watts_scale


_RAIL_CODE = {"core": RAIL_CORE, "bram": RAIL_BRAM,
              "io": RAIL_FIXED, "config": RAIL_FIXED}


def _pad(xs: Sequence[float], n: int, fill: float) -> np.ndarray:
    if len(xs) > n:
        raise ValueError(f"{len(xs)} terms exceed pad size {n}")
    return np.asarray(list(xs) + [fill] * (n - len(xs)), np.float32)


def make_platform_params(
        delay_terms: Sequence[Tuple[float, float, float, float, int]],
        power_terms: Sequence[Tuple[int, float, float, float, float]],
        *, delay_mode: int = 0, watts_nominal: float = 20.0,
        delay_pad: int = DELAY_TERMS_PAD,
        power_pad: int = POWER_TERMS_PAD) -> PlatformParams:
    """Assemble :class:`PlatformParams` (CPU tensors) from term tuples.

    ``delay_terms``: (weight, vth, alpha, v0, rail), weights normalized so
    delay == 1 at nominal rails.  ``power_terms``: (rail, v0, dyn_coef,
    stat_coef, kappa).
    """
    if any(t[4] == RAIL_FIXED for t in delay_terms):
        raise ValueError("delay terms must ride a scalable rail "
                         "(RAIL_CORE or RAIL_BRAM)")

    def col(terms, i, pad, fill, dtype=F32):
        return torch.as_tensor(_pad([t[i] for t in terms], pad, fill), dtype=dtype)

    p = PlatformParams(
        dl_weight=col(delay_terms, 0, delay_pad, 0.0),
        dl_vth=col(delay_terms, 1, delay_pad, 0.1),
        dl_alpha=col(delay_terms, 2, delay_pad, 1.0),
        dl_v0=col(delay_terms, 3, delay_pad, 1.0),
        dl_rail=col(delay_terms, 4, delay_pad, RAIL_CORE, torch.int32),
        delay_mode=torch.tensor(delay_mode, dtype=torch.int32),
        pw_rail=col(power_terms, 0, power_pad, RAIL_FIXED, torch.int32),
        pw_v0=col(power_terms, 1, power_pad, 1.0),
        pw_dyn=col(power_terms, 2, power_pad, 0.0),
        pw_stat=col(power_terms, 3, power_pad, 0.0),
        pw_kappa=col(power_terms, 4, power_pad, 0.0),
        nominal_power_arb=_f32(0.0),
        watts_scale=_f32(0.0),
    )
    nominal = float(params_power(p, V_CORE_NOM, V_BRAM_NOM, 1.0))
    return p._replace(nominal_power_arb=_f32(nominal),
                      watts_scale=_f32(watts_nominal / nominal))


def fpga_platform_params(util: Utilization, device: Device, bram_alpha: float,
                         core_mix: Mapping[str, float] | None = None,
                         activity: float = 0.125,
                         watts_nominal: float = 20.0) -> PlatformParams:
    """Array form of the FPGA delay composition + ``AppPowerModel`` (Eq. 1-3)."""
    mix = dict(CORE_PATH_MIX if core_mix is None else core_mix)
    total = sum(mix.values())
    # Mix terms always ride the core rail, whatever their power rail.
    delay_terms = [((w / total) / (1.0 + bram_alpha), FPGA_LIBRARY[n].vth,
                    FPGA_LIBRARY[n].alpha, FPGA_LIBRARY[n].v_nominal(),
                    RAIL_CORE) for n, w in mix.items()]
    mem = FPGA_LIBRARY["memory"]
    delay_terms.append((bram_alpha / (1.0 + bram_alpha), mem.vth, mem.alpha,
                        mem.v_nominal(), RAIL_BRAM))

    pm = AppPowerModel(util=util, device=device, activity=activity)
    power_terms = []
    for name, (used, idle) in pm._counts().items():
        res = FPGA_LIBRARY[name]
        power_terms.append((
            _RAIL_CODE[res.rail], res.v_nominal(),
            used * activity * res.p_dyn0,
            (used + idle * res.p_stat_idle_frac) * res.p_stat0,
            res.kappa))
    return make_platform_params(delay_terms, power_terms, delay_mode=0,
                                watts_nominal=watts_nominal)


def analytic_platform_params(alpha: float = 0.2, beta: float = 0.4,
                             watts_nominal: float = 20.0) -> PlatformParams:
    """Array form of the §III motivational (α, β) model (Figs. 4-6)."""
    mix = dict(CORE_PATH_MIX)
    total = sum(mix.values())
    delay_terms = [((w / total) / (1.0 + alpha), FPGA_LIBRARY[n].vth,
                    FPGA_LIBRARY[n].alpha, FPGA_LIBRARY[n].v_nominal(),
                    RAIL_CORE) for n, w in mix.items()]
    mem = FPGA_LIBRARY["memory"]
    delay_terms.append((alpha / (1.0 + alpha), mem.vth, mem.alpha,
                        mem.v_nominal(), RAIL_BRAM))

    logic, routing = FPGA_LIBRARY["logic"], FPGA_LIBRARY["routing"]
    one = _f32(1.0)
    norm_core = float(0.4 * logic.total_power(_f32(V_CORE_NOM), one)
                      + 0.6 * routing.total_power(_f32(V_CORE_NOM), one))
    norm_mem = float(mem.total_power(_f32(V_BRAM_NOM), one))
    power_terms = [
        (RAIL_CORE, V_CORE_NOM, 0.4 * logic.p_dyn0 / norm_core,
         0.4 * logic.p_stat0 / norm_core, logic.kappa),
        (RAIL_CORE, V_CORE_NOM, 0.6 * routing.p_dyn0 / norm_core,
         0.6 * routing.p_stat0 / norm_core, routing.kappa),
        (RAIL_BRAM, V_BRAM_NOM, beta * mem.p_dyn0 / norm_mem,
         beta * mem.p_stat0 / norm_mem, mem.kappa),
    ]
    return make_platform_params(delay_terms, power_terms, delay_mode=0,
                                watts_nominal=watts_nominal)


def tpu_platform_params(t_compute: float, t_memory: float,
                        t_collective: float, composition: str = "max",
                        watts_nominal: float = 200.0) -> PlatformParams:
    """Roofline terms (seconds) + ``TpuChipPowerModel`` as arrays."""
    terms = np.asarray([t_compute, t_memory, t_collective], np.float64)
    nominal = terms.max() if composition == "max" else terms.sum()
    core, hbm, unc = (TPU_LIBRARY["core"], TPU_LIBRARY["hbm"],
                      TPU_LIBRARY["uncore"])
    delay_terms = [
        (t_compute / nominal, core.vth, core.alpha, core.v_nominal(), RAIL_CORE),
        (t_memory / nominal, hbm.vth, hbm.alpha, hbm.v_nominal(), RAIL_BRAM),
        (t_collective / nominal, core.vth, core.alpha, core.v_nominal(),
         RAIL_CORE),
    ]
    chip = TpuChipPowerModel()
    power_terms = [
        (RAIL_CORE, core.v_nominal(), chip.w_core * core.p_dyn0,
         chip.w_core * core.p_stat0, core.kappa),
        (RAIL_BRAM, hbm.v_nominal(), chip.w_hbm * hbm.p_dyn0,
         chip.w_hbm * hbm.p_stat0, hbm.kappa),
        (RAIL_FIXED, unc.v_nominal(), chip.w_uncore * unc.p_dyn0,
         chip.w_uncore * unc.p_stat0, unc.kappa),
    ]
    return make_platform_params(delay_terms, power_terms,
                                delay_mode=1 if composition == "max" else 0,
                                watts_nominal=watts_nominal)


def stack_platform_params(params: Sequence[PlatformParams]) -> PlatformParams:
    """Stack same-shaped platforms along a new leading fleet axis."""
    if not params:
        raise ValueError("empty platform list")
    return PlatformParams(*[torch.stack(xs) for xs in zip(*params)])
