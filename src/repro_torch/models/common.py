"""Shared model machinery: parameter layouts, norms, RoPE, the loss.

Port of ``repro.models.common``.  A model is described by a *layout* — a
tree (dicts and lists) of :class:`ParamDef` leaves — from which the
parameter tree (``init_params``) derives mechanically.  The parameter
tree has the JAX package's nesting and leaf names, with tensors for
arrays, so a JAX parameter pytree carries over leaf for leaf
(``repro_torch.convert.model_params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones | constant
    scale: float = 0.02      # stddev for "normal", value for "constant"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def fan_in_def(shape, axes, n_in: Optional[int] = None) -> ParamDef:
    """Normal init with 1/sqrt(fan_in) stddev (fan_in = first dim by default)."""
    n_in = n_in if n_in is not None else shape[0]
    return ParamDef(tuple(shape), tuple(axes), "normal",
                    scale=float(1.0 / np.sqrt(max(n_in, 1))))


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in sorted-key order (JAX's flatten order);
    paths read like ``slots/0/attn/wq``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def stacked(layout: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dim to every leaf of a layer layout."""
    return tree_map(lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                                  axes=("layers",) + d.axes),
                    layout)


def init_params(generator: torch.Generator, layout: Any,
                dtype: torch.dtype = torch.float32) -> Any:
    """Materialize a parameter tree from a layout on ``generator``'s device.

    Leaves are drawn one after another, in sorted-key order, from the one
    seeded generator, so a seed gives the same weights on every run on
    the same kind of device.  A CUDA generator and a CPU one give
    different numbers from one seed, and neither gives ``jax.random``'s.
    """
    dev = generator.device

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "constant":
            return torch.full(d.shape, d.scale, dtype=dtype, device=dev)
        # scaled in place: a temporary the size of the largest leaf (a
        # stacked expert weight of tens of GB) would double the peak
        return torch.randn(d.shape, generator=generator, dtype=dtype, device=dev).mul_(d.scale)

    made = {path: make(d) for path, d in tree_leaves(layout)}
    return place_leaves(layout, made)


def place_leaves(layout: Any, made: dict, path: str = "") -> Any:
    """The layout's tree with each leaf replaced by ``made[its path]``."""
    if isinstance(layout, dict):
        return {k: place_leaves(v, made, f"{path}/{k}" if path else str(k))
                for k, v in layout.items()}
    if isinstance(layout, list):
        return [place_leaves(v, made, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(layout)]
    return made[path]


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to input dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., :h], x[..., h:]) by position-dependent angles.

    x: [..., seq, n_heads, head_dim] (head_dim even);
    positions: broadcastable to [..., seq].
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [half]
    angles = positions[..., None].float() * freqs                 # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token cross-entropy in fp32 with optional z-loss and padding mask.

    logits: [..., vocab]; labels: [...] int.  Returns (scalar, metrics)
    with the metric keys ``ce``, ``z_loss`` and ``accuracy``.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    zl = torch.square(lse)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    z = torch.sum(zl * mask) / denom
    total = loss + z_loss * z
    hit = (torch.argmax(logits, -1) == labels.long()).float()
    return total, {"ce": loss, "z_loss": z, "accuracy": torch.sum(hit * mask) / denom}
