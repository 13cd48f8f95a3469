"""Plain PyTorch backward of the Mamba-1 selective scan (fp32 math).

The gradient of ``selective_scan_ref`` (y, h_final) with respect to
delta, B, C, x and A_log, computed as ``csrc/selective_scan_bwd.cu``
computes it: time in chunks of ``BOUNDARY_STEPS`` steps, last first, each
chunk's states recomputed from the state stored at its start, then walked
back.  With a_t = exp(δ_t·A), A = −exp(A_log) and g_t = ∂L/∂h_t:

  g_S = dy_S·C_S + dh_final;   g_t = dy_t·C_t + a_{t+1}·g_{t+1}
  dx_t = δ_t·Σ_n g_t·B_t;      dδ_t = Σ_n g_t·(A·a_t·h_{t−1} + x_t·B_t)
  dB_t = Σ_d g_t·δ_t·x_t;      dC_t = Σ_d dy_t·h_t
  dA_log = A·Σ_{b,t} g_t·δ_t·a_t·h_{t−1}

The boundary states are the CUDA forward's store, or, on the CPU, a plain
re-scan (:func:`scan_boundaries`).  The CPU's autograd Function runs this,
and the card's kernel is held against it; nothing on the card's main
path calls it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Steps between two stored states: the kernels' ``kChunk``.
BOUNDARY_STEPS = 32


def scan_boundaries(delta: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                    A_log: torch.Tensor) -> torch.Tensor:
    """h at the end of every ``BOUNDARY_STEPS``-step chunk, fp32
    ``[b, ⌈S/BOUNDARY_STEPS⌉, D, N]``, from a zero state: what the CUDA
    forward stores for the backward."""
    b, S, D = delta.shape
    A = -torch.exp(A_log.float())
    h = torch.zeros((b, D, B.shape[-1]), dtype=torch.float32, device=delta.device)
    out = []
    for t in range(S):
        h = _step(h, delta[:, t].float(), x[:, t].float(), B[:, t].float(), A)
        if (t + 1) % BOUNDARY_STEPS == 0 or t == S - 1:
            out.append(h)
    return torch.stack(out, dim=1)


def _step(h, dt, xt, Bt, A):
    """One step of the recurrence: dt, xt [b, D], Bt [b, N]."""
    return torch.exp(dt[..., None] * A) * h + (dt * xt)[..., None] * Bt[:, None, :]


@torch.no_grad()
def selective_scan_bwd_ref(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           x: torch.Tensor, A_log: torch.Tensor, dy: torch.Tensor,
                           dh: Optional[torch.Tensor] = None,
                           boundary: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """(dδ, dB, dC, dx, dA_log), fp32, for cotangents ``dy`` [b, S, D] of y
    and ``dh`` [b, D, N] of h_final (None: zero).  ``boundary`` is the
    forward's store ``[b, ⌈S/BOUNDARY_STEPS⌉, D, N]``, or None to re-scan."""
    b, S, D = delta.shape
    N = B.shape[-1]
    if boundary is None:
        boundary = scan_boundaries(delta, B, x, A_log)
    A = -torch.exp(A_log.float())
    d32, x32, B32, C32, dy32 = (t.float() for t in (delta, x, B, C, dy))
    G = (torch.zeros((b, D, N), dtype=torch.float32, device=delta.device)
         if dh is None else dh.float().clone())              # a_{t+1}·g_{t+1}
    ddelta, dx = torch.empty_like(d32), torch.empty_like(x32)
    dB, dC = torch.empty_like(B32), torch.empty_like(C32)
    dA = torch.zeros((D, N), dtype=torch.float32, device=delta.device)
    for k in reversed(range(-(-S // BOUNDARY_STEPS))):
        t0, t1 = k * BOUNDARY_STEPS, min(S, (k + 1) * BOUNDARY_STEPS)
        h = boundary[:, k - 1] if k > 0 else torch.zeros_like(G)
        states = [h]                                          # h_{t0−1}, h_{t0}, ...
        for t in range(t0, t1):
            states.append(_step(states[-1], d32[:, t], x32[:, t], B32[:, t], A))
        for t in reversed(range(t0, t1)):
            h_t, h_prev = states[t - t0 + 1], states[t - t0]
            dt, xt, Bt = d32[:, t], x32[:, t], B32[:, t]
            a = torch.exp(dt[..., None] * A)
            g = G + dy32[:, t, :, None] * C32[:, t, None, :]
            ah = a * h_prev
            dx[:, t] = dt * torch.einsum("bdn,bn->bd", g, Bt)
            ddelta[:, t] = (g * (A * ah + xt[..., None] * Bt[:, None, :])).sum(-1)
            dA += (g * dt[..., None] * ah).sum(0)
            dB[:, t] = torch.einsum("bdn,bd->bn", g, dt * xt)
            dC[:, t] = torch.einsum("bdn,bd->bn", h_t, dy32[:, t])
            G = a * g
    return ddelta, dB, dC, dx, dA * A
