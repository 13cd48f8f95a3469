"""Decode-cache utilities: allocation, size, prefill padding (port of
``repro.serving.kvcache``).

Cache layouts come from ``models.transformer.cache_layout``; this module
materializes them (zeros, position tags at -1) on an explicit device,
sizes them, and pads prefill-produced caches out to serving capacity.
An MLA layer's cache is its compressed latent ``c_kv`` and rope key
``k_rope``: no head axis, no position tags, padded with zeros.
``split_kv_needed`` says whether the kv_heads or the kv_seq axis would
carry a model-parallel split; the port runs on one card and keeps it only
for parity.  The JAX package's ``abstract_cache`` (shape specs for its
dry-run lowering) is JAX-only tooling and has no counterpart here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, transformer


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None) -> Any:
    """A zeroed decode cache on ``device`` (``None``: the card), every leaf
    in ``cache_dtype(cfg)`` as the JAX package makes it, the position
    tags included (filled with -1)."""
    layout = transformer.cache_layout(cfg, batch, capacity)
    gen = torch.Generator(device=resolve_device(device))
    return common.init_params(gen, layout, dtype=cache_dtype(cfg))


def cache_bytes(cfg: ModelConfig, batch: int, capacity: int) -> int:
    """Bytes of ``init_cache(cfg, batch, capacity)``: every leaf at the
    cache dtype's item size."""
    layout = transformer.cache_layout(cfg, batch, capacity)
    itemsize = torch.empty((), dtype=cache_dtype(cfg)).element_size()
    return int(sum(np.prod(d.shape) for _, d in common.tree_leaves(layout)) * itemsize)


def split_kv_needed(cfg: ModelConfig, model_axis: int) -> bool:
    """True when kv_heads can't shard the model axis ⇒ shard the cache's
    seq dim instead (split-KV decode)."""
    a = cfg.attention
    if a is None:
        return False
    if a.kind == "mla":
        return True  # compressed latent cache has no head dim
    return a.n_kv_heads % model_axis != 0


def pad_prefill_cache(cfg: ModelConfig, prefill_cache: Any, capacity: int) -> Any:
    """Pad a ``return_state`` prefill cache (built at prefill length) out to
    serving capacity along the kv_seq axis.

    Each leaf is padded on its ``kv_seq`` axis with the layout's init
    value (``pos`` with its -1 empty-slot marker, k/v with zeros); a new
    tree comes back, the input is not changed.  Raises ``ValueError`` when
    the cache does not have the layout's leaves or a leaf already exceeds
    the target capacity.
    """
    leaves = list(common.tree_leaves(prefill_cache))
    if not leaves:
        return prefill_cache
    batch = leaves[0][1].shape[0]
    layout = transformer.cache_layout(cfg, batch, capacity)
    defs = [d for _, d in common.tree_leaves(layout)]
    if len(defs) != len(leaves):
        raise ValueError(f"cache has {len(leaves)} leaves but the layout expects "
                         f"{len(defs)} — not a {cfg.name} decode cache")
    out = {}
    for (path, x), d in zip(leaves, defs):
        if "kv_seq" in d.axes:
            ax = d.axes.index("kv_seq")
            tgt, cur = d.shape[ax], x.shape[ax]
            if cur > tgt:
                raise ValueError(f"cache kv_seq length {cur} exceeds capacity {tgt}; "
                                 "cannot pad an oversized prefill cache")
            if cur < tgt:
                fill = d.scale if d.init == "constant" else 0.0
                width = [0, 0] * (x.dim() - 1 - ax) + [0, tgt - cur]
                x = F.pad(x, width, value=fill)
        out[path] = x
    return common.place_leaves(prefill_cache, out)
