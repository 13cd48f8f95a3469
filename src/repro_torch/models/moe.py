"""Mixture-of-Experts FFN with GShard-style capacity, dispatched by index
(port of ``repro.models.moe``).

Tokens are reshaped into groups of ``group_size``; a top-k softmax router
assigns each token to experts with a fixed per-expert capacity
``C = ceil(group_size · top_k · capacity_factor / n_experts)`` (rounded
up to a multiple of 4, at least 4).  A (token, k) pair takes the next
slot of its expert's queue, the queue ordered k-major and then by
position in the group (GShard); pairs past ``C`` are dropped (the
residual path carries them) and unused slots stay zero.

The JAX package dispatches and combines with one-hot einsums, ``[g, s,
e, C]`` tensors that cost two more matmuls than the experts themselves at
full width.  Here the same function is computed by index:

* dispatch — each kept pair's row of ``x`` is copied to its (expert,
  slot) row of a zeroed ``[e, g·C, d]`` buffer.  A one-hot row times x
  with fp32 accumulation is x, so the buffer is bit-equal to the
  reference's ``xe``;
* combine — each kept pair's expert output row is gathered and scaled by
  its gate rounded to the activation dtype (the reference's
  ``comb.astype(dt)``); the k terms are summed in fp32 and cast once.
  Only the order of those k terms can differ from the reference's.

The expert FFN is one batched matmul over experts.  Aux losses:
Switch-style load balance, router z-loss and the dropped share.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import ParamDef, activation


def moe_layout(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert
    scale = float(1.0 / np.sqrt(d))
    out = {
        "router": ParamDef((d, m.n_experts), ("embed", None), "normal", scale=scale),
        # gate and up fused: one batched [d, 2·f] matmul per expert
        "w_in": ParamDef((m.n_experts, d, 2, f), ("expert", "embed", None, "expert_mlp"),
                         "normal", scale=scale),
        "w_down": ParamDef((m.n_experts, f, d), ("expert", "expert_mlp", "embed"),
                           "normal", scale=float(1.0 / np.sqrt(f))),
    }
    if m.n_shared:
        out["shared"] = ffn_mod.ffn_layout(d, m.n_shared * f)
    return out


def _capacity(group_size: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(np.ceil(group_size * m.top_k * m.capacity_factor / m.n_experts))
    return max(4, ((c + 3) // 4) * 4)


class Routing(NamedTuple):
    """A group's routing: ``[g, s, e]`` float32 router logits and
    probabilities, and per (token, k) ``[g, s, k]`` the expert (JAX's
    ``top_k`` order), its normalised float32 gate, whether the pair is
    kept, and its slot in the expert's queue (0 where dropped, as the
    reference's ``sum(pos · keep)``)."""
    logits: torch.Tensor
    probs: torch.Tensor
    expert_idx: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def route(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """Router logits in float32 from the float32 router, softmax, top-k,
    gates normalised by ``max(sum, 1e-9)``; capacity by the exclusive
    count of earlier pairs in the k-major queue of each expert."""
    m = cfg.moe
    g, s, _ = xg.shape
    logits = xg.float() @ router.float()                          # [g,s,e]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k's order: descending, ties to the lower expert index
    # (torch.topk promises neither), so a stable descending sort cut to k
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[..., :m.top_k], expert_idx[..., :m.top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, k) in its expert's queue, k-major then by
    # token: an exclusive count along the queue, the queue innermost (scanned
    # over an outer axis, it took 89.6 of qwen3's 226.5 ms prefill on an H100)
    flat = expert_idx.transpose(1, 2).reshape(g, 1, m.top_k * s)   # [g, 1, k·s]
    onehot = torch.zeros((g, m.n_experts, m.top_k * s), dtype=torch.int32, device=xg.device)
    onehot.scatter_(1, flat, 1)
    before = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = before.gather(1, flat)[:, 0].reshape(g, m.top_k, s).transpose(1, 2)
    keep = pos < cap
    slot = torch.where(keep, pos, 0).long()
    return Routing(logits, probs, expert_idx, gate, keep, slot)


def dispatch(xg: torch.Tensor, r: Routing, n_experts: int, cap: int) -> torch.Tensor:
    """``[e, g, C, d]``: each kept pair's row of ``xg`` at its (expert,
    slot), zeros elsewhere.  Dropped pairs are written to one spare row
    past the end, which is cut off."""
    g, s, d = xg.shape
    rows = n_experts * g * cap
    dest = (r.expert_idx * g + torch.arange(g, device=xg.device)[:, None, None]) * cap + r.slot
    dest = torch.where(r.keep, dest, rows)                        # [g,s,k]
    buf = xg.new_zeros((rows + 1, d))
    src = xg.reshape(g * s, d)
    for j in range(dest.shape[-1]):
        buf.index_copy_(0, dest[..., j].reshape(-1), src)
    return buf[:rows].view(n_experts, g, cap, d)


def experts(params: Dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated expert FFN on ``xe`` ``[e, g, C, d]``, one batched matmul
    over experts per projection, in ``xe``'s dtype."""
    e, g, cap, d = xe.shape
    f = params["w_in"].shape[-1]
    gu = torch.bmm(xe.view(e, g * cap, d),
                   params["w_in"].to(xe.dtype).reshape(e, d, 2 * f)).view(e, g * cap, 2, f)
    h = activation(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    return torch.bmm(h, params["w_down"].to(xe.dtype)).view(e, g, cap, d)


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """``[g, s, d]``: per token the sum over its kept pairs of the gate
    (rounded to ``ye``'s dtype) times the expert's output row, in fp32,
    cast once."""
    e, g, cap, d = ye.shape
    s = r.gate.shape[1]
    rows = ye.reshape(e * g * cap, d)
    src = (r.expert_idx * g + torch.arange(g, device=ye.device)[:, None, None]) * cap + r.slot
    gate = torch.where(r.keep, r.gate.to(ye.dtype).float(), 0.0)
    y = torch.zeros((g, s, d), dtype=torch.float32, device=ye.device)
    for j in range(src.shape[-1]):
        y += gate[..., j, None] * rows[src[..., j].reshape(-1)].view(g, s, d).float()
    return y.to(ye.dtype)


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,S,d] → (y, aux losses), y in x's dtype."""
    m = cfg.moe
    b, s, d = x.shape
    n_tokens = b * s
    gs = min(m.group_size, n_tokens)
    n_groups = n_tokens // gs
    if n_groups * gs != n_tokens:
        raise ValueError(f"moe_apply: {n_tokens} tokens are not a whole number of "
                         f"groups of {gs}")
    cap = _capacity(gs, cfg)
    xg = x.reshape(n_groups, gs, d)
    r = route(params["router"], xg, cfg, cap)
    ye = experts(params, dispatch(xg, r, m.n_experts, cap), cfg)
    y = combine(ye, r).reshape(b, s, d)
    if m.n_shared:
        y = y + ffn_mod.ffn_apply(params["shared"], x, cfg)

    # load balance: E · mean_g(sum_e(frac_tokens_e · mean_router_prob_e))
    chosen = torch.zeros_like(r.probs).scatter_(2, r.expert_idx, 1.0)
    frac = chosen.mean(dim=1)                                      # [g,e]
    mean_prob = r.probs.mean(dim=1)
    lb = m.n_experts * (frac * mean_prob).sum(-1).mean()
    z = torch.square(torch.logsumexp(r.logits, dim=-1)).mean()
    dropped = 1.0 - r.keep.sum(-1, dtype=torch.float32).mean() / m.top_k
    return y, {"moe_load_balance": lb, "moe_router_z": z, "moe_dropped": dropped}


def moe_aux_loss(cfg: ModelConfig, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    m = cfg.moe
    return m.aux_loss_weight * aux["moe_load_balance"] + m.router_z_weight * aux["moe_router_z"]
