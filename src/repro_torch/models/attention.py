"""Attention: GQA (RoPE, sliding-window, local:global patterns, softcap,
QK-norm, qkv bias) and MLA (DeepSeek-V2 latent attention with absorbed
decode); port of ``repro.models.attention``.

Two compute paths for each kind:

* prefill — ``kernels.flash_attention``, through ``_padded_flash``.  GQA
  passes the un-repeated k, v: GQA is folded into the kernel (query head
  ``h`` reads KV head ``h // G``), the causal / window band skips whole
  KV tiles, and the online softmax keeps p in fp32 as the Pallas kernel
  does.  MLA decompresses per-head k, v and sets ``[q_nope, q_rope]`` and
  ``[k_nope, k_rope]`` side by side, as the reference concatenates them.
  The op takes q, k and v at their own widths; on a card it runs the
  kernels at ``ops.kernel_widths`` (bfloat16 inference at a pair of the
  tensor-core forward unpadded — heads of 80, MLA's 192 / 128 —, every
  other call zero-padded to the least of ``ops.TC_HEAD_DIMS`` that holds
  the widest: 80 → 128; 192 and 128 → 256), with the scale of the
  unpadded width.  This is a route, not a fallback: a kernel that fails to
  build or launch raises.  On CPU tensors the op runs its plain version
  at the widths as they come.  (The JAX
  package's XLA twin ``full_attention`` rounds p to the activation dtype
  before p·v, so in bf16 the two agree to bf16 rounding, not bit for
  bit.)
* decode — plain PyTorch as in the JAX package: ``decode_attention``,
  single-token queries against a padded linear KV cache with position
  tags (a ring buffer for window layers); MLA's absorbed products over
  the compressed cache ``c_kv`` [B,T,r] + ``k_rope`` [B,T,rope], written
  in place at ``cache_pos`` (no ring, no position tags, as the reference).

``windowed_attention`` is the JAX package's banded form of a causal
sliding-window attention, plain PyTorch here; no GQA path of either
package calls it (the flash op skips the same band tile by tile).

Training differentiates the prefill path: the flash op runs as a
``torch.autograd.Function`` when an input requires grad, with the JAX
package's ``_fa_bwd`` as its backward over the config's ``q_chunk`` ×
``kv_chunk`` blocks; the op's zero columns and its cut are inside the
Function, which cuts each gradient back to the caller's widths.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.common import ParamDef, fan_in_def

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def gqa_layout(cfg: ModelConfig) -> Dict[str, ParamDef]:
    a = cfg.attention
    d = cfg.d_model
    out = {
        "wq": fan_in_def((d, a.n_heads, a.head_dim),
                         ("embed", "heads", "head_dim")),
        # K and V fused into one projection
        "wkv": fan_in_def((d, 2, a.n_kv_heads, a.head_dim),
                          ("embed", None, "kv_heads", "head_dim")),
        "wo": fan_in_def((a.n_heads, a.head_dim, d),
                         ("heads", "head_dim", "embed"),
                         n_in=a.n_heads * a.head_dim),
    }
    if a.attn_bias:
        out["bq"] = ParamDef((a.n_heads, a.head_dim), ("heads", "head_dim"), "zeros")
        out["bk"] = ParamDef((a.n_kv_heads, a.head_dim), ("kv_heads", "head_dim"), "zeros")
        out["bv"] = ParamDef((a.n_kv_heads, a.head_dim), ("kv_heads", "head_dim"), "zeros")
    if a.qk_norm:
        out["q_norm"] = ParamDef((a.head_dim,), (None,), "ones")
        out["k_norm"] = ParamDef((a.head_dim,), (None,), "ones")
    return out


def mla_layout(cfg: ModelConfig) -> Dict[str, ParamDef]:
    a = cfg.attention
    d = cfg.d_model
    qk = a.qk_nope_dim + a.qk_rope_dim
    return {
        "wq_a": fan_in_def((d, a.q_lora_rank), ("embed", None)),
        "q_norm": ParamDef((a.q_lora_rank,), (None,), "ones"),
        "wq_b": fan_in_def((a.q_lora_rank, a.n_heads, qk), (None, "heads", "head_dim")),
        "wkv_a": fan_in_def((d, a.kv_lora_rank + a.qk_rope_dim), ("embed", None)),
        "kv_norm": ParamDef((a.kv_lora_rank,), (None,), "ones"),
        "wk_b": fan_in_def((a.kv_lora_rank, a.n_heads, a.qk_nope_dim),
                           (None, "heads", "head_dim")),
        "wv_b": fan_in_def((a.kv_lora_rank, a.n_heads, a.v_head_dim),
                           (None, "heads", "head_dim")),
        "wo": fan_in_def((a.n_heads, a.v_head_dim, d), ("heads", "head_dim", "embed"),
                         n_in=a.n_heads * a.v_head_dim),
    }


def attention_layout(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return mla_layout(cfg) if cfg.attention.kind == "mla" else gqa_layout(cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid: torch.Tensor, *, scale: float,
                     cap: Optional[float] = None) -> torch.Tensor:
    """Single-step attention over a cache.

    q: [B,1,H,D]; caches: [B,T,KV,D] with ``H = KV·G`` (``KV = H`` is the
    JAX package's repeated form); valid: [B,T] bool.  Scores and softmax
    in fp32, p rounded to the cache dtype before p·v, which accumulates in
    fp32, as the JAX package's einsums with ``preferred_element_type``.
    GQA is folded (query head ``h`` reads KV head ``h // G``), which gives
    the same dot products as repeating the cache.
    """
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale
    s = common.softcap(s, cap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Banded attention
# ---------------------------------------------------------------------------


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, scale: float, cap: Optional[float] = None,
                       q_chunk: int = 1024) -> torch.Tensor:
    """Banded causal attention: each token sees the previous ``window``
    positions (itself included), O(S·window) work.

    q, k, v: [B,S,H,D] aligned (self-attention, heads already repeated).
    Query chunks of ``q_chunk`` rows (S must be a multiple) each attend
    to a band of ``min(window + q_chunk, S)`` keys whose start is clipped
    to ``[0, S − band]``, as the JAX package's; scores and softmax in
    fp32 (softcap and the ``-2e38`` fill included), p rounded to v's
    dtype before p·v, which accumulates in fp32.
    """
    b, s, h, d = q.shape
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"windowed_attention: S = {s} is not a multiple of "
                         f"q_chunk = {q_chunk}")
    band = min(window + q_chunk, s)
    out = []
    for q0 in range(0, s, q_chunk):
        start = min(max(q0 + q_chunk - band, 0), s - band)
        ki, vi = k[:, start:start + band], v[:, start:start + band]
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + q_chunk].float(),
                          ki.float()) * scale
        sc = common.softcap(sc, cap)
        qpos = torch.arange(q0, q0 + q_chunk, device=q.device)[:, None]
        kpos = torch.arange(start, start + band, device=q.device)[None, :]
        keep = (qpos >= kpos) & (qpos - kpos < window)
        p = torch.softmax(torch.where(keep, sc, NEG_INF), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(vi.dtype).float(), vi.float())
        out.append(o.to(q.dtype))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _prefill_gqa_cache(k: torch.Tensor, v: torch.Tensor, *, window: Optional[int],
                       capacity: int) -> Dict[str, torch.Tensor]:
    """Build a decode cache from prefill K/V.

    Global layers: K/V padded to ``capacity`` with position tags (-1 for
    empty slots).  Local layers: ring buffer of ``min(window, capacity)``
    — the last ``T`` keys scattered to slot ``pos % T`` so subsequent
    decode writes land consistently.  The cache is freshly allocated:
    decode writes into it in place.
    """
    b, s = k.shape[:2]
    dev = k.device
    if window is not None:
        t = min(window, capacity)
        n_tail = min(s, t)
        pos_tail = torch.arange(s - n_tail, s, dtype=torch.int32, device=dev)
        slots = (pos_tail % t).long()
        ck = k.new_zeros((b, t) + k.shape[2:])
        cv = v.new_zeros((b, t) + v.shape[2:])
        ck[:, slots] = k[:, s - n_tail:]
        cv[:, slots] = v[:, s - n_tail:]
        cpos = torch.full((t,), -1, dtype=torch.int32, device=dev)
        cpos[slots] = pos_tail
        return {"k": ck, "v": cv, "pos": cpos.repeat(b, 1)}
    assert s <= capacity, (s, capacity)
    ck = k.new_zeros((b, capacity) + k.shape[2:])
    cv = v.new_zeros((b, capacity) + v.shape[2:])
    ck[:, :s] = k
    cv[:, :s] = v
    idx = torch.arange(capacity, dtype=torch.int32, device=dev)
    cpos = torch.where(idx < s, idx, -1)
    return {"k": ck, "v": cv, "pos": cpos.repeat(b, 1)}


def _side_by_side(parts) -> torch.Tensor:
    """The column blocks ``parts`` ([..., d_i], broadcast to the first's
    shape) side by side.  One block comes back as it is: no copy, so a
    strided view (k, v as halves of one fused projection) reaches the op
    unchanged."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([t.expand(parts[0].shape[:-1] + t.shape[-1:]) for t in parts], dim=-1)


def _padded_flash(q_parts, k_parts, v: torch.Tensor, **kw) -> torch.Tensor:
    """The flash op on q and k (given as lists of column blocks, set side by
    side) and v.  The op pads the widths to a kernel's tile itself
    (``ops.kernel_widths``) and cuts its output back to v's width."""
    return flash_attention(_side_by_side(q_parts), _side_by_side(k_parts), v, **kw)


def gqa_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, is_local: bool,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              return_state: bool = False,
              cache_capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One GQA attention block (no residual/norm — the layer wraps those).

    Prefill: ``cache`` is None (``return_state=True`` additionally builds
    the decode cache).  Decode: ``cache`` holds k/v/pos (a ring buffer of
    size ``window`` for local layers); the step's k, v and position are
    written into it **in place** (the JAX package returns an updated
    copy) and the same dict comes back.
    """
    a = cfg.attention
    b, s, d = x.shape
    scale = 1.0 / math.sqrt(a.head_dim)
    theta = a.rope_local_theta if (is_local and a.rope_local_theta) else a.rope_theta

    q = (x @ params["wq"].to(x.dtype).reshape(d, -1)).unflatten(-1, (a.n_heads, a.head_dim))
    kv = (x @ params["wkv"].to(x.dtype).reshape(d, -1)) \
        .unflatten(-1, (2, a.n_kv_heads, a.head_dim))
    k, v = kv[:, :, 0], kv[:, :, 1]
    if a.attn_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if a.qk_norm:
        q = common.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = common.apply_rope(q, positions, theta)
    k = common.apply_rope(k, positions, theta)

    window = a.sliding_window if is_local else None
    new_cache = None
    if cache is None:
        eff_window = window if (window is not None and window < s) else None
        o = _padded_flash([q], [k], v, causal=cfg.causal, scale=scale,
                          softcap=a.attn_softcap, window=eff_window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        if return_state:
            new_cache = _prefill_gqa_cache(k, v, window=window,
                                           capacity=cache_capacity or s)
    else:
        # --- decode: write the new k/v in place, then attend over the cache
        assert s == 1 and cache_pos is not None
        t = cache["k"].shape[1]
        slot = (cache_pos % t).long()                      # ring for local
        bidx = torch.arange(b, device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][bidx, slot] = cache_pos.to(torch.int32)
        new_cache = cache
        cpos = cache["pos"]
        valid = (cpos >= 0) & (cpos <= cache_pos[:, None])
        if window is not None:
            valid &= (cache_pos[:, None] - cpos) < window
        o = decode_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), valid,
                             scale=scale, cap=a.attn_softcap)

    y = o.reshape(b, s, -1) @ params["wo"].to(x.dtype).reshape(-1, d)
    return y, new_cache


def gqa_cache_layout(cfg: ModelConfig, batch: int, seq_len: int,
                     is_local: bool) -> Dict[str, ParamDef]:
    """Per-layer decode cache (ring buffer of ``window`` for local layers)."""
    a = cfg.attention
    t = min(a.sliding_window, seq_len) if (is_local and a.sliding_window) else seq_len
    kv_axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamDef((batch, t, a.n_kv_heads, a.head_dim), kv_axes, "zeros"),
        "v": ParamDef((batch, t, a.n_kv_heads, a.head_dim), kv_axes, "zeros"),
        "pos": ParamDef((batch, t), ("batch", "kv_seq"), "constant", scale=-1.0),
    }


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, is_local: bool = False,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None,
              return_state: bool = False,
              cache_capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One MLA attention block (no residual/norm).

    Prefill: per-head k, v decompressed from the latent, through the
    flash op at q, k of 192 and v of 128 in bf16 inference, padded to 256
    in float32 and under grad (module docstring); ``return_state``
    builds the compressed cache ``{c_kv, k_rope}`` sized
    ``cache_capacity``.  Decode: the step's latent and rope key are
    written **in place** at ``cache_pos`` and the query attends over the
    whole compressed cache through the absorbed ``W_UK`` / ``W_UV``
    products, scores in fp32 (the reference's ``preferred_element_type``).
    """
    a = cfg.attention
    b, s, d = x.shape
    dt = x.dtype
    nope, rope, r = a.qk_nope_dim, a.qk_rope_dim, a.kv_lora_rank
    qk_dim = nope + rope
    scale = 1.0 / math.sqrt(qk_dim)

    cq = common.rms_norm(x @ params["wq_a"].to(dt), params["q_norm"], cfg.norm_eps)
    q = (cq @ params["wq_b"].to(dt).reshape(a.q_lora_rank, -1)).unflatten(-1, (a.n_heads, qk_dim))
    q_nope = q[..., :nope]
    q_rope = common.apply_rope(q[..., nope:], positions, a.rope_theta)

    ckv_full = x @ params["wkv_a"].to(dt)
    c_kv = common.rms_norm(ckv_full[..., :r], params["kv_norm"], cfg.norm_eps)
    k_rope = common.apply_rope(ckv_full[..., None, r:], positions, a.rope_theta)  # [B,S,1,rope]

    new_cache = None
    if cache is None:
        k_nope = (c_kv @ params["wk_b"].to(dt).reshape(r, -1)).unflatten(-1, (a.n_heads, nope))
        v = (c_kv @ params["wv_b"].to(dt).reshape(r, -1)).unflatten(-1, (a.n_heads, a.v_head_dim))
        o = _padded_flash([q_nope, q_rope], [k_nope, k_rope], v, causal=cfg.causal,
                          scale=scale, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        if return_state:
            cap_len = cache_capacity or s
            new_cache = {"c_kv": c_kv.new_zeros((b, cap_len, r)),
                         "k_rope": k_rope.new_zeros((b, cap_len, rope))}
            new_cache["c_kv"][:, :s] = c_kv
            new_cache["k_rope"][:, :s] = k_rope[:, :, 0]
    else:
        # absorbed decode over the compressed latent cache, written in place
        assert s == 1 and cache_pos is not None
        t = cache["c_kv"].shape[1]
        bidx = torch.arange(b, device=x.device)
        pos = cache_pos.long()
        cache["c_kv"][bidx, pos] = c_kv[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][bidx, pos] = k_rope[:, 0, 0].to(cache["k_rope"].dtype)
        new_cache = cache
        ckv_c, kr_c = cache["c_kv"].to(dt), cache["k_rope"].to(dt)
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"].to(dt))   # absorb W_UK
        sc = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv_c.float())
              + torch.einsum("bshp,btp->bhst", q_rope.float(), kr_c.float())) * scale
        valid = torch.arange(t, device=x.device)[None, :] <= cache_pos[:, None]
        p = torch.softmax(torch.where(valid[:, None, None, :], sc, NEG_INF), dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p.to(dt), ckv_c)
        o = torch.einsum("bshr,rhv->bshv", ctx, params["wv_b"].to(dt))

    y = o.reshape(b, s, -1) @ params["wo"].to(dt).reshape(-1, d)
    return y, new_cache


def mla_cache_layout(cfg: ModelConfig, batch: int, seq_len: int,
                     is_local: bool = False) -> Dict[str, ParamDef]:
    """The compressed decode cache: the latent and the shared rope key, no
    head axis and no position tags."""
    a = cfg.attention
    return {
        "c_kv": ParamDef((batch, seq_len, a.kv_lora_rank), ("batch", "kv_seq", None), "zeros"),
        "k_rope": ParamDef((batch, seq_len, a.qk_rope_dim), ("batch", "kv_seq", None), "zeros"),
    }


def attention_apply(params, x, cfg, **kw):
    if cfg.attention.kind == "mla":
        return mla_apply(params, x, cfg, **kw)
    return gqa_apply(params, x, cfg, **kw)


def attention_cache_layout(cfg, batch, seq_len, is_local):
    if cfg.attention.kind == "mla":
        return mla_cache_layout(cfg, batch, seq_len, is_local)
    return gqa_cache_layout(cfg, batch, seq_len, is_local)
