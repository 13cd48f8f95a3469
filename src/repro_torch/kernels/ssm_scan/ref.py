"""Plain PyTorch version of the Mamba-1 selective scan (fp32 math).

The same function as ``repro.kernels.ssm_scan.ref.selective_scan_ref``: a
sequential loop over time, state from ``h0`` (zero by default), y cast
once to x's dtype.  It is what the op runs for CPU tensors and what the
CUDA kernel is held against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       x: torch.Tensor, A_log: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference.

    delta, x: [batch, S, D]; B, C: [batch, S, N]; A_log: [D, N].
    h_t = exp(delta_t · A) ⊙ h_{t-1} + (delta_t · x_t) ⊗ B_t
    y_t = ⟨h_t, C_t⟩_N
    Returns (y [batch,S,D] in x's dtype, h_final [batch,D,N] fp32).
    """
    bsz, S, D = x.shape
    N = B.shape[-1]
    A = -torch.exp(A_log.float())
    d32, x32, B32, C32 = delta.float(), x.float(), B.float(), C.float()
    h = (torch.zeros((bsz, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(d32[:, t, :, None] * A[None])                  # [b,D,N]
        u = (d32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        h = a * h + u
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h
