"""Bring the JAX package's constants and weights into the port.

``platform_params_from_numpy`` takes a ``PlatformParams`` of the JAX
package as numpy arrays, field by field, and ``model_params_from_numpy``
a model's parameter pytree as numpy arrays with the same nesting (the
caller does the ``np.asarray``), so tests can run both packages on the
very same constants and weights without this package importing jax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import characterization as char
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer


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


def model_params_from_numpy(tree: Any, cfg: ModelConfig, device) -> Any:
    """A JAX parameter pytree (dicts and lists of numpy arrays) → the
    port's parameter tree of float32 tensors on ``device``.

    Every leaf's path (``slots/0/attn/wq``) and shape must match the
    port's ``model_layout(cfg)`` exactly; a missing, extra or mis-shaped
    leaf raises ``ValueError``.
    """
    dev = resolve_device(device)
    layout = transformer.model_layout(cfg)
    want = dict(common.tree_leaves(layout))
    got = dict(common.tree_leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter leaves: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    for path, d in want.items():
        if tuple(np.shape(got[path])) != d.shape:
            raise ValueError(f"parameter {path}: shape {tuple(np.shape(got[path]))}, "
                             f"want {d.shape}")
    return common.place_leaves(layout, {
        path: torch.tensor(np.asarray(got[path], np.float32), device=dev)
        for path in want})
