"""Serving engine: prefill and decode steps + a small host loop.

Port of ``repro.serving.engine``.  ``prefill`` runs the full forward with
``return_state=True`` so the decode cache comes back ready; the decode
``lax.scan`` of the JAX package is a Python loop over tokens here, with
the cache on the device and updated in place (a CUDA graph of one step is
later work).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer

#: Parameter leaves the model reads in fp32 — the norm weights of
#: ``rms_norm`` (MLA's ``kv_norm`` and Mamba-2's ``gate_norm`` among them),
#: the MoE ``router`` (routing is computed in fp32 from the fp32 master, as
#: the JAX package does) and Mamba's ``A_log``, ``dt_bias`` and skip ``D`` —
#: kept out of the engine's activation-dtype copy of the weights.
FP32_LEAVES = ("ln1", "ln2", "ln", "final_norm", "q_norm", "k_norm", "kv_norm",
               "gate_norm", "router", "A_log", "dt_bias", "D")


def make_prefill(cfg: ModelConfig, capacity: int):
    """(params, batch) -> (last_logits, cache)."""

    def prefill(params, batch):
        logits, cache, _ = transformer.forward(
            params, cfg, batch, return_state=True, cache_capacity=capacity,
            last_only=True)
        return logits[:, -1], cache

    return prefill


def make_decode_step(cfg: ModelConfig):
    """(params, cache, tokens[B,1], pos[B]) -> (logits[B,V], cache), the
    cache updated in place."""

    def decode_step(params, cache, tokens, pos):
        logits, new_cache, _ = transformer.forward(
            params, cfg, {"tokens": tokens}, cache=cache, cache_pos=pos)
        return logits[:, 0], new_cache

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """First index of the maximum, as ``jnp.argmax``; int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _serving_copy(params: Any, dtype: torch.dtype, device: torch.device,
                  path: str = "") -> Any:
    """The weights on ``device``, matmul weights in ``dtype``, the
    ``FP32_LEAVES`` as they are."""
    if isinstance(params, dict):
        return {k: _serving_copy(v, dtype, device, k) for k, v in params.items()}
    if isinstance(params, list):
        return [_serving_copy(v, dtype, device, path) for v in params]
    if path in FP32_LEAVES:
        return params.to(device)
    return params.to(device=device, dtype=dtype)


@dataclasses.dataclass
class ServeEngine:
    """Host-side generation loop (single process).

    ``device`` follows the port's rule: ``None`` is the CUDA card (and
    raises without one), ``"cpu"`` the plain path.  The engine keeps one
    copy of the weights on its device with every matmul weight already in
    the activation dtype ``cfg.dtype``, where the JAX package casts the
    float32 weights at every einsum; the numbers are the same, since a
    cast of the whole tensor gives the same values as a cast at each use.
    The leaves the model reads in float32 (norm weights, Mamba-2's
    ``gate_norm`` among them, the MoE router, Mamba's ``A_log``,
    ``dt_bias`` and ``D``) stay float32.
    """

    cfg: ModelConfig
    params: Any
    capacity: int
    batch_size: int
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._params = _serving_copy(self.params, getattr(torch, self.cfg.dtype),
                                     self.device)
        self._prefill = make_prefill(self.cfg, self.capacity)
        self._decode_step = make_decode_step(self.cfg)

    @torch.inference_mode()
    def generate(self, prompt_tokens: torch.Tensor, n_new: int,
                 extra_inputs: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """Greedy-generate exactly ``n_new`` tokens after a shared-length
        prompt: ``[B, n_new]`` int32 on the engine's device (``n_new=0``
        yields an empty ``[B, 0]``).  Token 1 is the prefill's argmax; the
        loop decodes the other ``n_new − 1``, one forward per token."""
        b, s = prompt_tokens.shape
        if n_new <= 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=self.device)
        if s + n_new - 1 > self.capacity:
            raise ValueError(f"prompt {s} + {n_new} new tokens exceed the cache "
                             f"capacity {self.capacity}")
        batch = {"tokens": prompt_tokens.to(self.device)}
        if extra_inputs:
            batch.update({k: v.to(self.device) for k, v in extra_inputs.items()})
        last_logits, cache = self._prefill(self._params, batch)
        tok = greedy_sample(last_logits)
        pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        toks = [tok]
        for _ in range(n_new - 1):
            logits, cache = self._decode_step(self._params, cache, tok[:, None], pos)
            tok = greedy_sample(logits)
            toks.append(tok)
            pos = pos + 1
        return torch.stack(toks, dim=1)
