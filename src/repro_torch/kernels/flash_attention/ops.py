"""The ``flash_attention`` op: prefill attention's entry point.

The op follows its inputs' device.  CUDA tensors launch the kernel in
``csrc/flash_attention.cu`` (built on first use by ``kernels._build``) on
the current stream, without synchronizing; CPU tensors run the plain
PyTorch version in ``ref.py``, which is how a caller asks for the CPU.
There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: Largest head_dim the kernel takes (its per-thread output columns).
MAX_HEAD_DIM = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float]) -> torch.device:
    """Validate device, dtype, shape and layout; return the common device."""
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs span devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on 'cuda' or 'cpu', not {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention wants q [B,Sq,H,D] and k, v [B,Sk,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[-1] != d or min(b, sq, sk, kv) < 1 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k, v {tuple(k.shape)} "
                         "need the same batch and head_dim, non-empty axes and "
                         "H a multiple of KV")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {d}")
    if causal and sq != sk:
        raise ValueError(f"causal flash_attention needs Sq == Sk (got {sq}, {sk}): the "
                         "kernel aligns the causal mask at 0, the plain version on the right")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if dev.type == "cuda":
        if b > 65535 or -(-sq // 64) > 65535:
            raise ValueError(f"flash_attention kernel grid too large for B={b}, Sq={sq}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1:
                raise ValueError(f"flash_attention: {name}'s head_dim axis must be "
                                 "contiguous (stride 1)")
    return dev


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (GQA: H = KV·G, query head ``h`` reads
    KV head ``h // G``).  Returns [B,Sq,H,D] in q's dtype.

    ``causal`` needs ``Sq == Sk``; ``window`` keeps keys with
    ``qpos − kpos < window``; ``softcap`` caps scores at ``c·tanh(s/c)``;
    ``scale`` defaults to ``1/sqrt(D)``.  On a CUDA tensor only the
    head_dim axis must be contiguous: the kernel reads the other axes
    through their strides.
    """
    dev = _check(q, k, v, causal, window, softcap)
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)

    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, sq, k.shape[1], h, k.shape[2], d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
                int(causal), -1 if window is None else int(window),
                int(softcap is not None), float(softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
