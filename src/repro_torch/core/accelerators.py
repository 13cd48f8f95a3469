"""The paper's five DNN-accelerator benchmarks (Table I) — port of
``repro.core.accelerators``, verbatim.

Post-place-and-route resource utilization and Fmax on the Stratix-IV-like
fabric, as reported in the paper.  Each is mapped to the smallest device of
the (modeled) family that fits it — the designs are heavily I/O-bound, so
the device is typically much larger than the logic demands, and the static
power of the unused fabric is a first-order effect (paper §VI-B).

The critical-path composition: the paper reports that BRAM contributes a
*similar* share of critical-path delay across all five accelerators ("the
α parameters are close"), with the motivational default α = 0.2 (§III).
We keep α = 0.2 for all five, with the core-side mix shifted toward DSP for
DSP-rich designs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

from repro_torch.core import characterization as char


@dataclasses.dataclass(frozen=True)
class Accelerator:
    name: str
    util: char.Utilization
    alpha: float = 0.2                      # d_m0 / d_l0 (paper §III)
    core_mix: Mapping[str, float] | None = None  # critical-path core share

    def device(self) -> char.Device:
        return char.vtr_device(self.util, name=self.name)

    def power_model(self, activity: float = 0.125) -> char.AppPowerModel:
        return char.AppPowerModel(util=self.util, device=self.device(),
                                  activity=activity)


# Table I of the paper, verbatim.
ACCELERATORS: Dict[str, Accelerator] = {
    "tabla": Accelerator(
        "tabla",
        char.Utilization(labs=127, dsps=0, m9ks=47, m144ks=1, io=567,
                         f_mhz=113.0),
        core_mix={"logic": 0.40, "routing": 0.60, "dsp": 0.0},
    ),
    "dnnweaver": Accelerator(
        "dnnweaver",
        char.Utilization(labs=730, dsps=1, m9ks=166, m144ks=13, io=1655,
                         f_mhz=99.0),
        core_mix={"logic": 0.40, "routing": 0.60, "dsp": 0.0},
    ),
    "diannao": Accelerator(
        "diannao",
        char.Utilization(labs=3430, dsps=112, m9ks=30, m144ks=2, io=4659,
                         f_mhz=83.0),
        core_mix={"logic": 0.30, "routing": 0.50, "dsp": 0.20},
    ),
    "stripes": Accelerator(
        "stripes",
        char.Utilization(labs=12343, dsps=16, m9ks=15, m144ks=1, io=8797,
                         f_mhz=40.0),
        core_mix={"logic": 0.40, "routing": 0.55, "dsp": 0.05},
    ),
    "proteus": Accelerator(
        "proteus",
        char.Utilization(labs=2702, dsps=144, m9ks=15, m144ks=1, io=5033,
                         f_mhz=70.0),
        core_mix={"logic": 0.30, "routing": 0.50, "dsp": 0.20},
    ),
}

#: Paper Table II — power-reduction factors to reproduce (ordering and
#: magnitudes; see EXPERIMENTS.md for our measured deltas).
PAPER_TABLE_II: Dict[str, Dict[str, float]] = {
    "core_only": {"tabla": 2.9, "diannao": 3.1, "stripes": 3.1,
                  "proteus": 3.1, "dnnweaver": 2.9, "average": 3.02},
    "bram_only": {"tabla": 2.7, "diannao": 1.9, "stripes": 1.8,
                  "proteus": 2.0, "dnnweaver": 2.9, "average": 2.26},
    "proposed": {"tabla": 4.1, "diannao": 3.9, "stripes": 3.9,
                 "proteus": 3.8, "dnnweaver": 4.4, "average": 4.02},
}
