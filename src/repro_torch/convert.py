"""Bring the JAX package's platform constants into the port.

``platform_params_from_numpy`` takes a ``PlatformParams`` of the JAX
package as numpy arrays, field by field (the caller does the
``np.asarray``), so tests can run both packages on the very same
constants without this package importing jax.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import characterization as char
from repro_torch.device import resolve_device


def platform_params_from_numpy(leaves: Mapping[str, np.ndarray],
                               device) -> char.PlatformParams:
    """``{field: array}`` → :class:`PlatformParams` on ``device``.

    Rails and ``delay_mode`` become int32, every other field float32;
    the field set must be exactly ``PlatformParams._fields``.
    """
    dev = resolve_device(device)
    fields = char.PlatformParams._fields
    if set(leaves) != set(fields):
        missing = sorted(set(fields) - set(leaves))
        extra = sorted(set(leaves) - set(fields))
        raise ValueError(f"PlatformParams fields: missing {missing}, "
                         f"unexpected {extra}")
    return char.PlatformParams(*[
        torch.tensor(np.asarray(leaves[f]),
                     dtype=torch.int32 if f in char.INT_FIELDS
                     else torch.float32, device=dev)
        for f in fields])
