"""Analysis tools of the port (``repro.analysis``): the three-term
roofline, with the H100 beside the JAX package's TPU v5e constants.
``hlo_parse`` (XLA's HLO text) has no counterpart yet."""

from repro_torch.analysis.roofline import (HW_H100, HW_V5E, Hardware, RooflineReport,
                                           model_flops_for, roofline_terms)

__all__ = ["Hardware", "HW_H100", "HW_V5E", "RooflineReport", "model_flops_for",
           "roofline_terms"]
