"""The ``selective_scan`` op: the Mamba-1 prefill recurrence's entry point.

The op follows its inputs' device.  CUDA tensors launch the kernel in
``csrc/selective_scan.cu`` (built on first use by ``kernels._build``) on
the current stream, without synchronizing; CPU tensors run the plain
PyTorch version in ``ref.py``, which is how a caller asks for the CPU.
There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``selective_scan.launches`` counts kernel launches.

The kernel splits each channel's N <= 16 states across two lanes of a
warp, takes each decay as one ``ex2.approx`` of delta·A·log2(e), and
streams delta and x through a two-stage ring of 32-step chunks in shared
memory with ``cp.async``; its header comment has the design.  Beyond the
shapes, it needs contiguous tensors and a batch that fits its grid.  The
Pallas op's ``chunk`` / ``block_d`` are TPU tile sizes and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

#: Largest state size N the kernel takes (its per-channel state registers).
MAX_STATE = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
           A_log: torch.Tensor) -> torch.device:
    """Validate device, dtype, shape and layout; return the common device."""
    ins = (delta, B, C, x, A_log)
    devices = {t.device for t in ins}
    if len(devices) != 1:
        raise ValueError(f"selective_scan inputs span devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan runs on 'cuda' or 'cpu', not {dev}")
    if delta.dtype not in _DTYPES or any(t.dtype != delta.dtype for t in (B, C, x)):
        raise TypeError(f"selective_scan takes float32 or bfloat16 delta, B, C, x of one "
                        f"dtype, got {delta.dtype}, {B.dtype}, {C.dtype}, {x.dtype}")
    if A_log.dtype != torch.float32:
        raise TypeError(f"selective_scan takes float32 A_log, got {A_log.dtype}")
    if delta.dim() != 3 or B.dim() != 3 or A_log.dim() != 2:
        raise ValueError(f"selective_scan wants delta, x [b,S,D], B, C [b,S,N] and A_log "
                         f"[D,N], got {[tuple(t.shape) for t in ins]}")
    b, s, d = delta.shape
    n = B.shape[-1]
    if (tuple(x.shape) != (b, s, d) or tuple(B.shape) != (b, s, n)
            or tuple(C.shape) != (b, s, n) or tuple(A_log.shape) != (d, n)
            or min(b, s, d, n) < 1):
        raise ValueError(f"selective_scan: shapes {[tuple(t.shape) for t in ins]} do not "
                         "make non-empty delta, x [b,S,D], B, C [b,S,N], A_log [D,N]")
    if n > MAX_STATE:
        raise ValueError(f"selective_scan kernel takes a state size N <= {MAX_STATE}, "
                         f"got {n}")
    if dev.type == "cuda":
        _check_kernel_layout(ins)
    return dev


def _check_kernel_layout(ins: Sequence[torch.Tensor]) -> None:
    """What the kernel needs of delta, B, C, x, A_log beyond their shapes:
    a batch that fits its grid (grid.y) and contiguous tensors."""
    if ins[0].shape[0] > 65535:
        raise ValueError(f"selective_scan kernel grid too large for batch {ins[0].shape[0]}")
    for name, t in zip(("delta", "B", "C", "x", "A_log"), ins):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")


def selective_scan(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   x: torch.Tensor, A_log: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta, x: [b,S,D]; B, C: [b,S,N]; A_log: [D,N] → (y, h_final).

    The state starts at zero; y ``[b,S,D]`` comes back in x's dtype and
    h_final ``[b,D,N]`` in float32.  delta, B, C, x are float32 or
    bfloat16, A_log float32, and N <= 16.
    """
    dev = _check(delta, B, C, x, A_log)
    if dev.type == "cpu":
        return selective_scan_ref(delta, B, C, x, A_log)

    b, s, d = delta.shape
    n = B.shape[-1]
    fn = _build.load("ssm_scan").selective_scan_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    y = torch.empty((b, s, d), dtype=x.dtype, device=dev)
    h = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(),
                A_log.data_ptr(), y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype],
                b, s, d, n, stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {rc}")
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
