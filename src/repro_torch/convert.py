"""Bring the JAX package's constants and weights into the port.

``platform_params_from_numpy`` takes a ``PlatformParams`` of the JAX
package as numpy arrays, field by field, ``model_params_from_numpy`` a
model's parameter pytree as numpy arrays with the same nesting (the
caller does the ``np.asarray``), and ``opt_state_from_numpy`` an
``AdamWState`` of the JAX package as numpy arrays, so tests can run both
packages on the very same constants, weights and optimizer state without
this package importing jax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import characterization as char
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer
from repro_torch.optim.adamw import AdamWState


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


def _check_leaves(tree: Any, layout: Any, what: str) -> dict:
    """``{path: leaf}`` of ``tree``, whose paths and shapes must be the
    layout's exactly (``ValueError`` naming the first that is not)."""
    want = dict(common.tree_leaves(layout))
    got = dict(common.tree_leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"{what} leaves: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    for path, d in want.items():
        if tuple(np.shape(got[path])) != d.shape:
            raise ValueError(f"{what} {path}: shape {tuple(np.shape(got[path]))}, "
                             f"want {d.shape}")
    return got


def _tensor(arr: np.ndarray, dev) -> torch.Tensor:
    """A numpy leaf as a tensor; a bfloat16 one (``ml_dtypes``) through its
    16-bit patterns."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.tensor(arr, device=dev)


def model_params_from_numpy(tree: Any, cfg: ModelConfig, device) -> Any:
    """A JAX parameter pytree (dicts and lists of numpy arrays) → the
    port's parameter tree of float32 tensors on ``device``.

    Every leaf's path (``slots/0/attn/wq``) and shape must match the
    port's ``model_layout(cfg)`` exactly; a missing, extra or mis-shaped
    leaf raises ``ValueError``.
    """
    dev = resolve_device(device)
    layout = transformer.model_layout(cfg)
    got = _check_leaves(tree, layout, "parameter")
    return common.place_leaves(layout, {
        path: torch.tensor(np.asarray(leaf, np.float32), device=dev)
        for path, leaf in got.items()})


def opt_state_from_numpy(state: Any, cfg: ModelConfig, device) -> AdamWState:
    """A JAX ``AdamWState`` as numpy arrays (``step``, and ``m``, ``v`` with
    the parameters' nesting) → the port's :class:`AdamWState` on
    ``device``: step int32, the moments in their own dtype (float32 or
    bfloat16).  Each moment leaf is checked against ``model_layout(cfg)``
    as ``model_params_from_numpy`` checks the parameters."""
    dev = resolve_device(device)
    layout = transformer.model_layout(cfg)
    moments = []
    for name in ("m", "v"):
        got = _check_leaves(getattr(state, name), layout, f"moment {name}")
        moments.append(common.place_leaves(layout, {
            path: _tensor(leaf, dev) for path, leaf in got.items()}))
    step = torch.tensor(np.asarray(state.step, np.int32), device=dev)
    return AdamWState(step=step, m=moments[0], v=moments[1])
