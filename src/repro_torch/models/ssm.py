"""Selective state-space blocks, the Mamba-1 half (port of ``repro.models.ssm``).

The prefill recurrence ``h_t = exp(δ_t·A) ⊙ h_{t-1} + (δ_t·x_t) ⊗ B_t``
runs through the ``selective_scan`` op, where the JAX package runs the XLA
``chunked_scan``: the same function, evaluated sequentially in the op and
associatively within chunks in XLA, so the two round differently.  Decode
is one step of the recurrence in plain torch.  The cache is the state
``h`` (fp32) plus a (d_conv-1)-deep conv tail in the activation dtype;
decode writes both in place, into the caller's cache.

The Mamba-2 layouts are kept (pure shape code); ``mamba_apply`` raises
``NotImplementedError`` for Mamba-2, which is not ported yet (ROADMAP A12).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models.common import ParamDef, fan_in_def


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def mamba_layout(cfg: ModelConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    n = s.d_state
    out = {
        "in_proj": fan_in_def((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamDef((s.d_conv, di), ("conv", "inner"), "normal",
                           scale=float(1.0 / np.sqrt(s.d_conv))),
        "conv_b": ParamDef((di,), ("inner",), "zeros"),
        "out_proj": fan_in_def((di, d), ("inner", "embed")),
        "D": ParamDef((di,), ("inner",), "ones"),
    }
    if s.kind == "mamba1":
        r = dt_rank(cfg)
        out.update({
            "x_proj": fan_in_def((di, r + 2 * n), ("inner", None)),
            "dt_proj": fan_in_def((r, di), (None, "inner")),
            "dt_bias": ParamDef((di,), ("inner",), "constant", scale=-4.6),
            # A_log init: A = -exp(A_log); log(arange(1..N)) standard init
            "A_log": ParamDef((di, n), ("inner", "state"), "constant",
                              scale=0.5),
        })
    else:  # mamba2 (SSD)
        h = s.n_heads(d)
        out.update({
            "w_bc": fan_in_def((d, 2 * n), ("embed", None)),
            "w_dt": fan_in_def((d, h), ("embed", "inner")),
            "dt_bias": ParamDef((h,), ("inner",), "constant", scale=-4.6),
            "A_log": ParamDef((h,), ("inner",), "constant", scale=0.5),
            "gate_norm": ParamDef((di,), ("inner",), "ones"),
        })
    return out


def mamba_cache_layout(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    n = s.d_state
    if s.kind == "mamba1":
        h_shape, h_axes = (batch, di, n), ("batch", "inner", "state")
    else:
        nh, p = s.n_heads(cfg.d_model), s.head_dim
        h_shape, h_axes = (batch, nh, p, n), ("batch", "inner", None, "state")
    return {
        "h": ParamDef(h_shape, h_axes, "zeros"),
        "conv": ParamDef((batch, s.d_conv - 1, di),
                         ("batch", None, "inner"), "zeros"),
    }


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def _conv_taps(ctx: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as K shifted multiply-adds in fp32, rounded
    once to ctx's dtype: ``ctx`` [B, S+K-1, D] holds K-1 steps of history
    before the S outputs; ``w[K-1]`` weights the current step (JAX's conv
    is a cross-correlation).  No cuDNN, so float32 stays float32 on the
    card."""
    k = w.shape[0]
    s = ctx.shape[1] - k + 1
    w32 = w.to(ctx.dtype).float()
    out = ctx[:, 0:s].float() * w32[0]
    for j in range(1, k):
        out = out + ctx[:, j:j + s].float() * w32[j]
    return out.to(ctx.dtype) + b.to(ctx.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` step for step, ``x · (1 / (1 + exp(−x)))``, each op
    rounded to x's dtype as XLA rounds it (``F.silu`` rounds once, which
    moves about 40 % of bf16 outputs by one ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq; x [B,S,D], w [K,D]."""
    return _conv_taps(F.pad(x, (0, 0, w.shape[0] - 1, 0)), w, b)


def mamba_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                return_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba block (norm/residual handled by the layer wrapper).

    Prefill: ``cache=None`` (pass ``return_state=True`` to get the final
    state for a subsequent decode).  Decode: S must be 1; the new state
    and conv tail are copied into ``cache``, which is returned.
    """
    s = cfg.ssm
    if s.kind != "mamba1":
        raise NotImplementedError(f"{cfg.name}: {s.kind} is not ported yet "
                                  "(ROADMAP A12); the port runs Mamba-1")
    S = x.shape[1]
    dt = x.dtype

    xz = x @ params["in_proj"].to(dt)
    x_in, z = torch.chunk(xz, 2, dim=-1)

    decode = cache is not None and S == 1
    if decode:
        ctx = torch.cat([cache["conv"].to(dt), x_in], dim=1)
        xc = _conv_taps(ctx, params["conv_w"], params["conv_b"])
        new_conv = ctx[:, 1:]
    else:
        xc = _causal_conv(x_in, params["conv_w"], params["conv_b"])
        # a copy, so the cache does not keep the whole xz alive
        new_conv = x_in[:, -(s.d_conv - 1):].clone() if return_state else None
    xc = _silu(xc)

    y, h_final = _mamba1_core(params, xc, cfg, cache, decode)
    y = y * _silu(z)
    out = y @ params["out_proj"].to(dt)

    if decode:
        cache["h"].copy_(h_final)
        cache["conv"].copy_(new_conv)
        return out, cache
    return out, ({"h": h_final, "conv": new_conv} if return_state else None)


def _mamba1_core(params, xc, cfg, cache, decode):
    s = cfg.ssm
    S = xc.shape[1]
    n = s.d_state
    r = dt_rank(cfg)
    dt_ = xc.dtype

    proj = xc @ params["x_proj"].to(dt_)
    dt_in, Bm, Cm = torch.split(proj, [r, n, n], dim=-1)
    delta = F.softplus((dt_in @ params["dt_proj"].to(dt_)).float()
                       + params["dt_bias"].float())
    Bm = Bm.float().contiguous()
    Cm = Cm.float().contiguous()
    xf = xc.float()

    if decode:
        A = -torch.exp(params["A_log"].float())                  # [di,n]
        h0 = cache["h"].float()                                  # [B,di,n]
        log_a = delta[:, 0, :, None] * A[None]                   # [B,di,n]
        u = (delta * xf)[:, 0, :, None] * Bm[:, 0, None, :]
        h = torch.exp(log_a) * h0 + u
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
        y = y + params["D"].float() * xf
        return y.to(dt_), h

    chunk = min(s.chunk, S)
    assert S % chunk == 0, (S, s.chunk)   # the JAX chunked scan's contract
    y, h_final = selective_scan(delta, Bm, Cm, xf, params["A_log"].float())
    y = y + params["D"].float() * xf
    return y.to(dt_), h_final
