"""Plain PyTorch version of the fused masked grid-argmin sweep.

The same fleet sweep as ``repro.kernels.grid_argmin.ref``: every platform
× sweep row × frequency level through
:func:`repro_torch.core.voltage.optimize_point_params`, written as one
broadcast ``[P, R, M, C, B]`` evaluation instead of a ``vmap`` pyramid.
It is what the op runs for CPU tensors and what the CUDA kernel is held
against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import characterization as char
from repro_torch.core import voltage as volt


def grid_argmin_ref(params: char.PlatformParams, masks: torch.Tensor,
                    levels: torch.Tensor, core_grid: torch.Tensor,
                    bram_grid: torch.Tensor,
                    slack_eps: float = 1e-6) -> volt.OperatingPoint:
    """Masked grid sweep + per-bin argmin for a whole fleet.

    ``params`` leaves are stacked ``[P, ...]``; ``masks`` is ``[R, C, B]``
    bool and ``levels`` ``[R, M]``.  Returns ``[P, R, M]`` fields.
    """
    per_cell = char.PlatformParams(*[x.reshape(x.shape[:1] + (1, 1) + x.shape[1:])
                                     for x in params])         # [P, 1, 1, ...]
    return volt.optimize_point_params(per_cell, levels, core_grid, bram_grid,
                                      masks[:, None], slack_eps=slack_eps)
