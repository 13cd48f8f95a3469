"""Top-level model of every family: dense, MoE, Mamba-1, the Mamba-2
hybrid, and the VLM and audio frontends (port of
``repro.models.transformer``).

Layers are grouped into *periods* (the local:global pattern length, the
hybrid's shared-attention interval, 1 otherwise); each period slot's
parameters are stacked ``[n_per, ...]``, and the remainder layers keep
their own, so the parameter tree has the JAX package's ``prefix`` /
``slots`` / ``rem`` structure leaf for leaf.  The JAX ``lax.scan`` over
periods is a Python loop over the stacked axis here; a layer's locality
(``_is_local``) follows its global index, so the remainder layers of a
local:global config (gemma3-27b: 62 = 10 × 6 + 2) keep the pattern.  An
MoE config's leading ``first_dense_layers`` are the unrolled ``prefix``
(FFN width ``d_ff_dense`` where it is set), every later layer an MoE
layer.  A hybrid config (zamba2-2.7b) has one ``shared`` dense block,
applied after the slot layers of every period with that period's own
full-length KV cache (``cache["shared"]``, stacked ``n_per`` deep); its
remainder layers, as the reference's, get none.  The frontends replace
the token embedding: the audio family projects ``features``, the VLM
family maps ``patches`` through a two-layer projector onto the first
positions.

Training (grad enabled, neither decoding nor building a cache) with
``cfg.remat`` wraps each period layer and the shared block in
``torch.utils.checkpoint`` where the reference applies ``jax.checkpoint``:
their activations are recomputed in the backward, so the attention
forward runs twice a layer a step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamDef, fan_in_def, stacked
from repro_torch.parallel import sharding as shd

# the parameter tree's per-layer entries; every other entry is gathered
# once at the start of a sharded forward
_LAYER_KEYS = ("prefix", "slots", "rem", "shared")


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


def period_of(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        return cfg.shared_attn_every
    a = cfg.attention
    if a is not None and a.pattern_period:
        return a.pattern_period
    return 1


def scanned_layers(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(prefix_layers, n_periods, remainder_layers)."""
    prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    rest = cfg.n_layers - prefix
    p = period_of(cfg)
    return prefix, rest // p, rest % p


def _layer_kind(cfg: ModelConfig, global_idx: int) -> str:
    if cfg.family in ("ssm", "hybrid"):
        return "mamba"
    if cfg.moe is not None and global_idx >= cfg.moe.first_dense_layers:
        return "moe"
    return "dense"


def _is_local(cfg: ModelConfig, global_idx: int) -> bool:
    a = cfg.attention
    return a.is_local(global_idx) if a is not None else False


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def _dense_layer_layout(cfg: ModelConfig, d_ff: int) -> Dict[str, Any]:
    return {
        "ln1": ParamDef((cfg.d_model,), (None,), "ones"),
        "attn": attn_mod.attention_layout(cfg),
        "ln2": ParamDef((cfg.d_model,), (None,), "ones"),
        "ffn": ffn_mod.ffn_layout(cfg.d_model, d_ff),
    }


def _moe_layer_layout(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": ParamDef((cfg.d_model,), (None,), "ones"),
        "attn": attn_mod.attention_layout(cfg),
        "ln2": ParamDef((cfg.d_model,), (None,), "ones"),
        "moe": moe_mod.moe_layout(cfg),
    }


def _mamba_layer_layout(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln": ParamDef((cfg.d_model,), (None,), "ones"),
        "mamba": ssm_mod.mamba_layout(cfg),
    }


def _layer_layout(cfg: ModelConfig, global_idx: int) -> Dict[str, Any]:
    kind = _layer_kind(cfg, global_idx)
    if kind == "mamba":
        return _mamba_layer_layout(cfg)
    if kind == "moe":
        return _moe_layer_layout(cfg)
    d_ff = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense) else cfg.d_ff
    return _dense_layer_layout(cfg, d_ff)


def _has_shared(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid" and bool(cfg.shared_attn_every)


def model_layout(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    prefix, n_per, rem = scanned_layers(cfg)
    p = period_of(cfg)
    out: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"), "normal",
                          scale=0.02),
        "final_norm": ParamDef((d,), (None,), "ones"),
    }
    # the audio family's head is untied whatever tie_embeddings says
    if not cfg.tie_embeddings or cfg.family == "audio":
        out["lm_head"] = fan_in_def((d, cfg.padded_vocab), ("embed", "vocab"))
    if cfg.family == "audio":
        out["frontend"] = {
            "proj": fan_in_def((cfg.frontend_dim, d), ("frontend", "embed")),
            "bias": ParamDef((d,), (None,), "zeros"),
        }
    if cfg.family == "vlm":
        out["frontend"] = {
            "w1": fan_in_def((cfg.frontend_dim, d), ("frontend", "embed")),
            "b1": ParamDef((d,), (None,), "zeros"),
            "w2": fan_in_def((d, d), ("embed", None)),
            "b2": ParamDef((d,), (None,), "zeros"),
        }
    out["prefix"] = [_layer_layout(cfg, i) for i in range(prefix)]
    out["slots"] = [stacked(_layer_layout(cfg, prefix + s), n_per)
                    for s in range(p)] if n_per else []
    out["rem"] = [_layer_layout(cfg, prefix + n_per * p + i)
                  for i in range(rem)]
    if _has_shared(cfg):
        out["shared"] = _dense_layer_layout(cfg, cfg.d_ff)
    return out


def cache_layout(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    """Decode-cache layout mirroring the layer structure; a hybrid model's
    shared block has one full-length cache per period."""
    prefix, n_per, rem = scanned_layers(cfg)
    p = period_of(cfg)

    def layer_cache(global_idx: int):
        if _layer_kind(cfg, global_idx) == "mamba":
            return ssm_mod.mamba_cache_layout(cfg, batch)
        return attn_mod.attention_cache_layout(cfg, batch, seq_len,
                                               _is_local(cfg, global_idx))

    out: Dict[str, Any] = {
        "prefix": [layer_cache(i) for i in range(prefix)],
        "slots": [stacked(layer_cache(prefix + s), n_per)
                  for s in range(p)] if n_per else [],
        "rem": [layer_cache(prefix + n_per * p + i) for i in range(rem)],
    }
    if _has_shared(cfg):
        out["shared"] = stacked(
            attn_mod.attention_cache_layout(cfg, batch, seq_len, False), n_per)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_dense_or_moe(lp, x, cfg, *, kind, is_local, positions, cache, cache_pos,
                        return_state, cache_capacity):
    h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, new_cache = attn_mod.attention_apply(
        lp["attn"], h, cfg, positions=positions, is_local=is_local,
        cache=cache, cache_pos=cache_pos, return_state=return_state,
        cache_capacity=cache_capacity)
    x = x + h
    h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
    aux: Dict[str, torch.Tensor] = {}
    if kind == "moe":
        h, aux = moe_mod.moe_apply(lp["moe"], h, cfg)
    else:
        h = ffn_mod.ffn_apply(lp["ffn"], h, cfg)
    return x + h, new_cache, aux


def _apply_mamba(lp, x, cfg, *, cache, return_state):
    h = common.rms_norm(x, lp["ln"], cfg.norm_eps)
    h, new_cache = ssm_mod.mamba_apply(lp["mamba"], h, cfg, cache=cache,
                                       return_state=return_state)
    return x + h, new_cache, {}


def _zero_aux(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    if cfg.moe is None:
        return {}
    return {k: torch.zeros((), device=device)
            for k in ("moe_load_balance", "moe_router_z", "moe_dropped")}


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings, or the frontend's: the audio family projects
    ``features`` [B, S, frontend_dim] (no token embedding); the VLM family,
    when ``patches`` [B, P, frontend_dim] is in the batch, puts
    ``gelu_tanh(patches·w1 + b1)·w2 + b2`` in the first P positions."""
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        f = params["frontend"]
        return batch["features"].to(dt) @ f["proj"].to(dt) + f["bias"].to(dt)
    x = params["embed"][batch["tokens"].long()].to(dt)
    if cfg.family == "vlm" and "patches" in batch:
        f = params["frontend"]
        ph = common.activation("gelu")(batch["patches"].to(dt) @ f["w1"].to(dt)
                                       + f["b1"].to(dt))
        ph = ph @ f["w2"].to(dt) + f["b2"].to(dt)
        x = torch.cat([ph, x[:, ph.shape[1]:]], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, Any]] = None,
            cache_pos: Optional[torch.Tensor] = None,
            return_state: bool = False,
            cache_capacity: Optional[int] = None,
            last_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Returns (logits, new_cache_or_None, aux_losses).

    ``cache`` drives decode mode (tokens are [B, 1]; the cache is updated
    in place and returned).  ``return_state`` makes a prefill pass
    additionally build the decode cache sized ``cache_capacity`` (default:
    prefill length).  ``last_only`` computes logits for the final position
    only (serving prefill — skips the O(S·V) head over the prompt).
    ``aux_losses`` sums each MoE layer's ``moe_load_balance``,
    ``moe_router_z`` and ``moe_dropped`` (float32 scalars); the other
    families have none: ``{}``.  The batch holds ``tokens`` [B, S], and
    ``features`` (audio, in place of tokens) or ``patches`` (VLM, optional).

    Under sharding rules that hold leaves as a rank's FSDP shards
    (``parallel.sharding.fsdp_specs``), each layer's leaves are gathered
    whole inside that layer's call, so under remat the recompute gathers
    them again and no whole copy of the layers is kept; the embedding,
    head and norms are gathered once.
    """
    specs = shd.fsdp_specs(model_layout(cfg)) if shd.data_group() is not None else None
    if specs is not None:
        top = [k for k in params if k not in _LAYER_KEYS]
        params = {**params, **shd.gather_params({k: params[k] for k in top},
                                                {k: specs[k] for k in top})}
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    decoding = cache is not None
    if decoding:
        positions = cache_pos[:, None]
    else:
        positions = torch.arange(s, device=x.device)[None, :]
    prefix, n_per, rem = scanned_layers(cfg)
    p = period_of(cfg)
    collect = decoding or return_state
    remat = cfg.remat and torch.is_grad_enabled() and not collect
    new_cache: Dict[str, Any] = {"prefix": [], "rem": []}
    aux_acc = _zero_aux(cfg, x.device)

    def apply_layer(lp, x, gidx, layer_cache, spec=None):
        lp = shd.gather_params(lp, spec)
        kind = _layer_kind(cfg, gidx)
        if kind == "mamba":
            return _apply_mamba(lp, x, cfg, cache=layer_cache, return_state=return_state)
        return _apply_dense_or_moe(
            lp, x, cfg, kind=kind, is_local=_is_local(cfg, gidx), positions=positions,
            cache=layer_cache, cache_pos=cache_pos, return_state=return_state,
            cache_capacity=cache_capacity)

    def run_layer(lp, x, gidx, layer_cache, spec, rematted=False):
        if rematted:
            x, nc, aux = checkpoint(apply_layer, lp, x, gidx, None, spec, use_reentrant=False)
        else:
            x, nc, aux = apply_layer(lp, x, gidx, layer_cache, spec)
        for k, v in aux.items():
            aux_acc[k] = aux_acc[k] + v
        return x, nc

    def apply_shared(lp, x, layer_cache):
        lp = shd.gather_params(lp, specs and specs["shared"])
        return _apply_dense_or_moe(
            lp, x, cfg, kind="dense", is_local=False, positions=positions,
            cache=layer_cache, cache_pos=cache_pos, return_state=return_state,
            cache_capacity=cache_capacity)

    for i in range(prefix):
        x, nc = run_layer(params["prefix"][i], x, i,
                          cache["prefix"][i] if decoding else None,
                          specs and specs["prefix"][i])
        new_cache["prefix"].append(nc)

    def stack(per):
        return {k: torch.stack([c[k] for c in per]) for k in per[0]}

    if n_per:
        shared = params.get("shared")
        slot_caches, shared_caches = [[] for _ in range(p)], []
        # a stacked leaf's spec without its "layers" entry fits one layer
        slot_specs = [specs and common.tree_map(lambda sp: sp[1:], specs["slots"][si])
                      for si in range(p)]
        for i in range(n_per):                 # the scan over periods
            for si in range(p):
                lp = common.tree_map(lambda t: t[i], params["slots"][si])
                lc = (common.tree_map(lambda t: t[i], cache["slots"][si])
                      if decoding else None)   # views: decode writes through
                x, nc = run_layer(lp, x, prefix + si, lc, slot_specs[si], rematted=remat)
                slot_caches[si].append(nc)
            if shared is not None:
                lc = (common.tree_map(lambda t: t[i], cache["shared"])
                      if decoding else None)
                if remat:
                    x, nc, _ = checkpoint(apply_shared, shared, x, None, use_reentrant=False)
                else:
                    x, nc, _ = apply_shared(shared, x, lc)
                shared_caches.append(nc)
        if decoding:
            new_cache["slots"] = cache["slots"]
            if shared is not None:
                new_cache["shared"] = cache["shared"]
        elif return_state:
            new_cache["slots"] = [stack(per) for per in slot_caches]
            if shared is not None:
                new_cache["shared"] = stack(shared_caches)

    for i in range(rem):
        gidx = prefix + n_per * p + i
        x, nc = run_layer(params["rem"][i], x, gidx,
                          cache["rem"][i] if decoding else None,
                          specs and specs["rem"][i])
        new_cache["rem"].append(nc)

    if last_only:
        x = x[:, -1:]
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and "lm_head" not in params:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    logits = common.softcap(logits, cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # padding columns exist only so the JAX vocab dim shards; mask them
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.tensor(-1e9, dtype=logits.dtype, device=x.device))
    return logits, (new_cache if collect else None), aux_acc
