"""Plain PyTorch version of the flash-attention forward (fp32 math).

The same function as ``repro.kernels.flash_attention.ref``: full scores,
right-aligned causal mask, ``-2e38`` fill, one softmax, in fp32, the
result cast once to q's dtype.  As the kernels and the JAX model's
``full_attention`` do, the unnormalised probabilities are rounded to v's
dtype before ``p·v`` (which sums in fp32) and the rows are divided by
their fp32 sums after it; in float32 that rounding is the identity.  It is
what the op runs for CPU tensors and what the CUDA kernel is held against
on the card.  With ``return_stats`` it also returns each row's softmax
stats, m (the row max of the scaled, capped, masked scores) and l (the
row sum of ``exp(s − m)``), float32 ``[B, H, Sq]``: what the kernels store
for the attention backward.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -2.0e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, return_stats: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """q: [B,Sq,H,D]; k,v: [B,Sk,H,D] (kv already GQA-expanded).

    Returns [B,Sq,H,Dv] in q's dtype; math in fp32, p rounded to v's dtype.
    With ``return_stats``, returns ``(out, m, l)``, m and l float32 [B,H,Sq].
    """
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)  # right-aligned
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = (s - m[..., None]).exp_()
    del s
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l = p.sum(-1)
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return (out, m, l) if return_stats else out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, return_stats: bool = False
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The GQA signature of the op: k, v ``[B,Sk,KV,D]`` with ``H = KV·G``;
    query head ``h`` reads KV head ``h // G``."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale, return_stats=return_stats)
