"""Three-term roofline (port of ``repro.analysis.roofline``).

    compute    = flops      / peak FLOP/s
    memory     = bytes      / HBM bandwidth
    collective = coll_bytes / link bandwidth

all per device (the per-device form x / peak is the global form divided
by the device count).  ``model_flops_for`` gives the analytic 6·N·D
(training) or 2·N·D (a forward) of a shape in ``configs.SHAPES``.

Hardware: ``HW_V5E`` keeps the JAX package's TPU v5e constants, so the
two packages' reports can be compared; ``HW_H100`` is the card the port
runs on.  ``RooflineReport.mfu`` reads the report's own ``hw`` (the JAX
package's divides by v5e's peak whatever hardware built the report).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float      # per device, dense bf16
    hbm_bw: float          # bytes/s per device
    link_bw: float         # bytes/s per link, one direction
    hbm_bytes: float       # capacity per device


#: TPU v5e-class, as the JAX package states it: 197 TFLOP/s bf16, 819 GB/s
#: HBM, ~50 GB/s a link of ICI, 16 GiB.
HW_V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                  link_bw=50e9, hbm_bytes=16 * 1024 ** 3)

#: NVIDIA H100 SXM5 80 GB at its 700 W limit, from NVIDIA's data sheet:
#: 989.4 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, NVLink
#: 900 GB/s a card (450 GB/s a direction), 80 GiB.  A card set below 700 W
#: (``nvidia-smi --query-gpu=power.limit``) runs slower under load.
HW_H100 = Hardware(name="h100-sxm5-80gb", peak_flops=989.4e12, hbm_bw=3.35e12,
                   link_bw=450e9, hbm_bytes=80 * 1024 ** 3)


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    t_compute: float
    t_memory: float
    t_collective: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float           # 6·N·D analytic (global)
    chips: int
    hw: Hardware = HW_V5E

    @property
    def t_step(self) -> float:
        """Overlapped step-time lower bound (max of terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """model flops / global flops — remat and redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time, against the
        report's own hardware."""
        denom = self.t_step * self.chips * self.hw.peak_flops
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_step_s": self.t_step,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
        }


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, model_flops: float,
                   chips: int, hw: Hardware = HW_V5E) -> RooflineReport:
    return RooflineReport(
        t_compute=flops_per_device / hw.peak_flops,
        t_memory=bytes_per_device / hw.hbm_bw,
        t_collective=coll_bytes_per_device / hw.link_bw,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        model_flops=model_flops,
        chips=chips,
        hw=hw,
    )


def model_flops_for(cfg, shape, active_params: int) -> float:
    """6·N·D for training, 2·N·D for a forward (prefill, decode).

    decode: D = global_batch tokens (one step); prefill/train: B·S tokens.
    """
    if shape.kind == "decode":
        return 2.0 * active_params * shape.global_batch   # one token a sequence
    tokens = shape.global_batch * shape.seq_len
    return (6.0 if shape.kind == "train" else 2.0) * active_params * tokens
