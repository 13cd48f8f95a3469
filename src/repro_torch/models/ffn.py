"""Gated feed-forward (SwiGLU / GeGLU) block (port of ``repro.models.ffn``)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, activation, fan_in_def


def ffn_layout(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        # gate and up fused: one [d, 2·d_ff] matmul
        "w_in": fan_in_def((d_model, 2, d_ff), ("embed", None, "mlp")),
        "w_down": fan_in_def((d_ff, d_model), ("mlp", "embed")),
    }


def ffn_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x·W_gate) ⊙ (x·W_up) · W_down`` in ``x``'s dtype."""
    act = activation(cfg.act)
    d, _, d_ff = params["w_in"].shape
    gu = (x @ params["w_in"].to(x.dtype).reshape(d, 2 * d_ff)) \
        .unflatten(-1, (2, d_ff))                                  # [B,S,2,F]
    h = act(gu[..., 0, :]) * gu[..., 1, :]
    return h @ params["w_down"].to(x.dtype)
