"""Analysis tools of the port (``repro.analysis``): the three-term
roofline, with the H100 beside the JAX package's TPU v5e constants, and
``op_cost``, the op-level cost counter that stands where the JAX
package's ``hlo_parse`` reads XLA's HLO text."""

from repro_torch.analysis.op_cost import OpCost, OpCounter, analyze, collective_bytes
from repro_torch.analysis.roofline import (HW_H100, HW_V5E, Hardware, RooflineReport,
                                           model_flops_for, roofline_terms)

__all__ = ["Hardware", "HW_H100", "HW_V5E", "OpCost", "OpCounter", "RooflineReport",
           "analyze", "collective_bytes", "model_flops_for", "roofline_terms"]
