"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Each gradient is quantized to int8 with one shared float32 scale
(``max|g| / 127``), rounding half to even as ``jnp.round`` does
(``torch.round`` does the same), and the quantization residual is carried
to the next step.  The train step applies it to the gradients after
they are summed over the data group, as the reference's step applies it
after the reduction its compiled program makes, so it shrinks no
collective; it still quantizes, so a run with ``compress_grads`` trains
as the reference's does.  A leaf held as an FSDP shard takes its scale's
``max|g|`` over the data group, so each shard quantizes as its whole leaf.
"""

from __future__ import annotations

from typing import Any, Collection, Optional, Tuple

import torch

from repro_torch.models import common
from repro_torch.parallel import sharding as shd


def _quantize(g: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_gradients(grads: Any, error: Optional[Any], sharded: Collection[str] = (),
                       group=None) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error-feedback state).  ``sharded``
    names the leaves (by path) that hold only this rank's shard: their
    ``max|g|`` is taken over ``group``."""
    if error is None:
        error = common.tree_map(torch.zeros_like, grads)
    flat_e = dict(common.tree_leaves(error))
    g32 = {path: g.float() + flat_e[path].float() for path, g in common.tree_leaves(grads)}
    amax = {path: torch.max(torch.abs(x)) for path, x in g32.items()}
    held = [path for path in g32 if path in sharded]
    if held:
        top = shd.all_reduce_max(torch.stack([amax[path] for path in held]), group)
        amax.update(zip(held, top.unbind()))

    def one(path, g):
        q, scale = _quantize(g32[path], amax[path])
        deq = q.float() * scale
        return deq.to(g.dtype), (g32[path] - deq).to(flat_e[path].dtype)

    out = {path: one(path, g) for path, g in common.tree_leaves(grads)}
    return (common.place_leaves(grads, {p: t[0] for p, t in out.items()}),
            common.place_leaves(grads, {p: t[1] for p, t in out.items()}))
