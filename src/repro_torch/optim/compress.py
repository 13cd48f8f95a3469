"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Each gradient is quantized to int8 with one shared float32 scale
(``max|g| / 127``), rounding half to even as ``jnp.round`` does
(``torch.round`` does the same), and the quantization residual is carried
to the next step.  On one device there is no all-reduce to shrink; the
step still applies the quantization, so a run with ``compress_grads``
trains as the reference's does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models import common


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_gradients(grads: Any, error: Optional[Any]) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error-feedback state)."""
    if error is None:
        error = common.tree_map(torch.zeros_like, grads)

    def one(g, e):
        g32 = g.float() + e.float()
        q, scale = _quantize(g32)
        deq = q.float() * scale
        return deq.to(g.dtype), (g32 - deq).to(e.dtype)

    flat_e = dict(common.tree_leaves(error))
    out = {path: one(g, flat_e[path]) for path, g in common.tree_leaves(grads)}
    return (common.place_leaves(grads, {p: t[0] for p, t in out.items()}),
            common.place_leaves(grads, {p: t[1] for p, t in out.items()}))
