"""Selective state-space blocks, Mamba-1 and Mamba-2 (port of
``repro.models.ssm``).

Mamba-1: the prefill recurrence ``h_t = exp(δ_t·A) ⊙ h_{t-1} + (δ_t·x_t) ⊗ B_t``
runs through the ``selective_scan`` op, where the JAX package runs the XLA
``chunked_scan``: the same function, evaluated sequentially in the op and
associatively within chunks in XLA, so the two round differently.

Mamba-2 (SSD, one scalar decay per head): the prefill is the JAX package's
matmul form, ``_ssd_matmul_scan``, in plain torch (no Pallas kernel covers
it): a loop over chunks carrying the state ``h [B, nh, p, n]``, each chunk
an attention-like product with the decay-weighted Gram matrix.  B, C and δ
are projected from the block's normed input, not from the conv output; the
output passes ``rms_norm(y · silu(z), gate_norm)``.

Decode is one step of the recurrence in plain torch for both.  The cache
is the state ``h`` (fp32) plus a (d_conv-1)-deep conv tail in the
activation dtype; decode writes both in place, into the caller's cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models.common import ParamDef, fan_in_def, rms_norm


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

    if s.kind == "mamba1":
        y, h_final = _mamba1_core(params, xc, cfg, cache, decode)
        y = y * _silu(z)
    else:
        y, h_final = _mamba2_core(params, xc, x, cfg, cache, decode)
        y = rms_norm(y * _silu(z), params["gate_norm"], cfg.norm_eps)
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


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def _mamba2_core(params, xc, x_raw, cfg, cache, decode):
    """B, C and δ from ``x_raw`` (the block's normed input); one decay
    ``A = −exp(A_log)`` a head.  The skip adds ``xh`` itself: the
    reference reads no ``D`` leaf for Mamba-2 (ROADMAP C), nor does this."""
    s = cfg.ssm
    b, S, di = xc.shape
    n, p = s.d_state, s.head_dim
    nh = di // p
    dt_ = xc.dtype

    bc = (x_raw @ params["w_bc"].to(dt_)).float()
    Bm, Cm = bc[..., :n], bc[..., n:]                              # [B,S,n]
    delta = F.softplus((x_raw @ params["w_dt"].to(dt_)).float()
                       + params["dt_bias"].float())                 # [B,S,nh]
    A = -torch.exp(params["A_log"].float())                         # [nh]
    xh = xc.float().reshape(b, S, nh, p)

    if decode:
        h0 = cache["h"].float()                                     # [B,nh,p,n]
        log_a = (delta[:, 0] * A[None])[:, :, None, None]
        u = (delta[:, 0, :, None] * xh[:, 0])[..., None] * Bm[:, 0, None, None, :]
        h = torch.exp(log_a) * h0 + u
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0])
        y = y + xh[:, 0] * 1.0
        return y.reshape(b, 1, di).to(dt_), h

    y, h_final = _ssd_matmul_scan(delta, Bm, Cm, xh, A, s.chunk)
    y = y + xh
    return y.reshape(b, S, di).to(dt_), h_final


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and back to fp32: a product of two such values
    is exact in fp32, so an fp32 product of them is the reference's bf16
    einsum with ``preferred_element_type=float32`` up to summation order."""
    return t.to(torch.bfloat16).float()


def _ssd_matmul_scan(delta: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     xh: torch.Tensor, A: torch.Tensor, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2's SSD block decomposition (arXiv:2405.21060 §6), the JAX
    package's ``_ssd_matmul_scan``: a loop over chunks carrying the state.

    Within a chunk of c steps and per head, ``y_intra = M·(δx)`` with
    ``M[t, τ] = (C_t·B_τ)·exp(A_t − A_τ)`` for τ ≤ t (A the inclusive
    prefix of the log-decay), ``y_inter = (C·h)·exp(A_t)``, and the state
    ``h' = exp(A_end)·h + Σ_τ exp(A_end − A_τ)·δx_τ ⊗ B_τ``.  The Gram
    matrix, M and δ·x are rounded to bf16 with fp32 sums, as the reference
    rounds them, also in a float32 model; the rest is fp32.  M is built
    ``[B, nh, t, τ]`` so that ``M·(δx)`` is one batched product.

    delta: [B,S,nh]; Bm, Cm: [B,S,n]; xh: [B,S,nh,p]; A: [nh].
    Returns (y [B,S,nh,p], h_final [B,nh,p,n]), fp32.
    """
    b, S, nh = delta.shape
    p, n = xh.shape[-1], Bm.shape[-1]
    c = min(chunk, S)
    assert S % c == 0, (S, chunk)   # the JAX scan's contract
    h = torch.zeros((b, nh, p, n), dtype=torch.float32, device=delta.device)
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32, device=delta.device))
    ys = []
    for c0 in range(0, S, c):
        d_c, B_c, C_c, x_c = (t[:, c0:c0 + c] for t in (delta, Bm, Cm, xh))
        cum = torch.cumsum(d_c * A, dim=1)                         # [B,c,nh], ≤ 0
        gram = _bf16(C_c) @ _bf16(B_c).transpose(1, 2)             # [B,t,τ]
        cum_h = cum.transpose(1, 2)                                # [B,nh,c]
        decay = cum_h[:, :, :, None] - cum_h[:, :, None, :]        # [B,nh,t,τ]
        M = _bf16(gram[:, None] * torch.exp(torch.clamp(decay, max=0.0)) * tri)
        dx = d_c[..., None] * x_c                                  # [B,c,nh,p]
        y_intra = (M @ _bf16(dx).transpose(1, 2)).transpose(1, 2)  # [B,c,nh,p]
        y_inter = torch.einsum("btn,bhpn->bthp", C_c, h) * torch.exp(cum)[..., None]
        a_end = cum[:, -1]                                         # [B,nh]
        w = torch.exp(a_end[:, None] - cum)                        # [B,c,nh]
        h = torch.exp(a_end)[..., None, None] * h \
            + torch.einsum("bshp,bsn->bhpn", w[..., None] * dx, B_c)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h
