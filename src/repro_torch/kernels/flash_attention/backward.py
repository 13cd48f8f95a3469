"""The attention backward: a port of the JAX package's ``_fa_bwd``
(``src/repro/models/attention.py:244``, with ``_kv_extent`` at ``:153``).

The JAX package has no backward kernel: it differentiates its flash
attention through this custom VJP, XLA einsums over query × KV chunks that
recompute each score block from the forward's row stats (m, l) instead of
keeping the probabilities.  This is the same computation in plain PyTorch,
on whatever device its inputs are on.  It is the plain version of the
backward kernels (``csrc/flash_attention_bwd*.cu``): ``FlashAttention``
runs it for CPU tensors, and the tests and ``chip_smoke.py`` hold the
kernels to it; a CUDA call of the op trains through the kernels, never
through this.

  delta = rowsum(dout·out)                  (fp32)
  per query chunk and each KV chunk of its band (``_kv_extent``):
    s  = softcap(q·kᵀ·scale), masked to −2e38
    p  = exp(s − m) / max(l, 1e-30)
    ds = p·(dout·vᵀ − delta) · (1 − tanh²) with a softcap, 0 where masked, · scale
    dq += ds·k;   dk += dsᵀ·q;   dv += pᵀ·dout

The products take the inputs' values (bf16 or float32) as operands and sum
in fp32, and ds and p are rounded to the operand dtype first, as the JAX
package's ``preferred_element_type=f32`` einsums do; dq, dk and dv are cast
back to the input dtypes.  GQA is folded in the op (query head ``h`` reads
KV head ``h // G``), where the JAX package repeats k and v before the call;
so k and v are repeated here, and the dk and dv of a KV head are the sums
over the G query heads that read it, as the repeat's gradient is in JAX.
Masks align the query positions on the right (the plain forward's rule),
which is the JAX package's when Sq = Sk, the only case the kernels take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -2.0e38


def kv_extent(q0: int, q_chunk: int, t: int, causal: bool, window: Optional[int],
              kv_chunk: int) -> Tuple[int, int]:
    """The [t_start, t_end) KV range a query chunk starting at position
    ``q0`` can see, in whole KV chunks (``_kv_extent``), clipped to ``t``."""
    if causal:
        t_end = min(t, q0 + q_chunk)
        t_end = min(t, -(-t_end // kv_chunk) * kv_chunk)
    else:
        t_end = t
    t_start = (max(0, q0 - window + 1) // kv_chunk) * kv_chunk if window is not None else 0
    return t_start, t_end


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool, window: Optional[int],
                        softcap: Optional[float], scale: float, q_chunk: int,
                        kv_chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, out, dout: [B,Sq,H,D]; k, v: [B,Sk,KV,D]; m, l: float32 [B,H,Sq],
    the forward's row stats.  Returns (dq, dk, dv) in q's, k's and v's
    dtypes.  Chunks of ``min(q_chunk, Sq)`` query rows and
    ``min(kv_chunk, Sk)`` keys; a last chunk may be short."""
    b, sq, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    off = t - sq
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, t)
    dev = q.device
    delta = torch.sum(dout.float() * out.float(), dim=-1)            # [B,Sq,H]
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, t, h, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, t, h, v.shape[-1]), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        qc = min(q_chunk, sq - q0)
        t0, t1 = kv_extent(q0 + off, qc, t, causal, window, kv_chunk)
        qi = q[:, q0:q0 + qc].float()
        doi = dout[:, q0:q0 + qc].float()
        mi = m[:, :, q0:q0 + qc, None]
        li = torch.clamp(l[:, :, q0:q0 + qc], min=1e-30)[..., None]
        di = delta[:, q0:q0 + qc].transpose(1, 2)[..., None]           # [B,H,qc,1]
        qpos = torch.arange(q0 + off, q0 + off + qc, device=dev)[:, None]
        dq_i = dq[:, q0:q0 + qc]
        for k0 in range(t0, t1, kv_chunk):
            kc = min(kv_chunk, t1 - k0)
            kj, vj = kr[:, k0:k0 + kc].float(), vr[:, k0:k0 + kc].float()
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj) * scale
            if softcap is not None:
                th = torch.tanh(s / softcap)
                s = softcap * th
            kpos = torch.arange(k0, k0 + kc, device=dev)[None, :]
            keep = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                keep &= qpos >= kpos
            if window is not None:
                keep &= (qpos - kpos) < window
            s = torch.where(keep, s, NEG_INF)
            p = torch.exp(s - mi) / li
            del s
            dp = torch.einsum("bqhd,bkhd->bhqk", doi, vj)
            ds = p * (dp - di)
            del dp
            if softcap is not None:
                ds = ds * (1.0 - torch.square(th))
                del th
            ds = torch.where(keep, ds, 0.0) * scale
            dq_i += torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kj)
            dk[:, k0:k0 + kc] += torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qi)
            dv[:, k0:k0 + kc] += torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), doi)
    if g > 1:
        dk = dk.view(b, t, kvh, g, d).sum(3)
        dv = dv.view(b, t, kvh, g, dv.shape[-1]).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
