"""The ``flash_attention`` op: prefill attention's entry point.

The op follows its inputs' device.  CPU tensors run the plain PyTorch
version in ``ref.py``, which is how a caller asks for the CPU.  CUDA
tensors launch one of two kernels (built on first use by
``kernels._build``) on the current stream, without synchronizing, by a
fixed rule on dtype and head_dim (``route``):

* bfloat16 with head_dim in ``TC_HEAD_DIMS`` → ``flash_attention_wgmma``
  (``csrc/flash_attention_wgmma.cu``): wgmma on the tensor cores, fed by
  TMA.  ``tma_map_args`` computes each input's tensor-map arguments and
  raises ``ValueError`` where TMA cannot take the view (base address not
  16-byte aligned, a stride not a multiple of 16 bytes);
* float32 with head_dim up to ``MAX_HEAD_DIM`` → ``flash_attention``
  (``csrc/flash_attention.cu``): fp32 FMAs on the CUDA cores, so float32
  stays float32 (TF32 would miss 2e-5).

A bfloat16 head_dim outside ``TC_HEAD_DIMS`` or a float32 one above
``MAX_HEAD_DIM`` raises on a CUDA tensor; the plain version takes any
head_dim.  There is no fallback between the kernels or to the plain
version.
``flash_attention.launches`` counts all kernel launches and
``flash_attention.kernel_launches`` the launches of each kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: Largest head_dim the kernels take (the CUDA-core kernel's 16 output
#: columns a thread; the tensor-core kernel's four 64-column TMA boxes).
MAX_HEAD_DIM = 256
#: bfloat16 head_dims of the tensor-core kernel: a multiple of wgmma's
#: depth of 16 whose swizzled TMA box row (D·2 bytes, at most 128) tiles D.
TC_HEAD_DIMS = (16, 32, 64, 128, 256)
#: The two kernels, by their ``_build.SOURCES`` names.
TENSOR_CORE, CUDA_CORE = "flash_attention_wgmma", "flash_attention"
#: Query rows per TMA box of q in the tensor-core kernel (a consumer
#: warpgroup's rows).
Q_BOX_ROWS = 64

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])
_MapArg = ctypes.c_ulonglong * 12
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [_MapArg] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
#: Error codes the tensor-core launch adds to CUDA's.
_NO_ENCODER, _ENCODE_FAILED = 9999, 10000


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves CUDA inputs of ``dtype`` and ``head_dim``:
    ``TENSOR_CORE`` for bfloat16, ``CUDA_CORE`` for float32.  A fixed rule,
    not a fallback: a head_dim the dtype's kernel cannot take raises
    ``ValueError``."""
    if dtype == torch.float32:
        if not 1 <= head_dim <= MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: the float32 CUDA-core kernel takes "
                             f"head_dim <= {MAX_HEAD_DIM}, got {head_dim}")
        return CUDA_CORE
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {dtype}")
    if head_dim not in TC_HEAD_DIMS:
        raise ValueError(f"flash_attention: the bfloat16 tensor-core kernel takes head_dim "
                         f"in {TC_HEAD_DIMS}, got {head_dim}")
    return TENSOR_CORE


def kv_box_rows(head_dim: int) -> int:
    """Keys per TMA box of k, v (one KV tile of the tensor-core kernel):
    128, or 64 at head_dim 128 and 256, where the fragments of 128 keys
    would not fit in registers (``Tile::kBK`` in the kernel)."""
    return 64 if head_dim >= 128 else 128


class TmaMap(NamedTuple):
    """Arguments of ``cuTensorMapEncodeTiled`` for one [B, S, heads, D] input."""
    dims: Tuple[int, int, int, int]      # {D, S, heads, B}, innermost first
    strides: Tuple[int, int, int]        # bytes between rows, heads, batches
    box: Tuple[int, int, int, int]       # {columns, rows, 1, 1}
    swizzle: int                         # bytes: 32, 64 or 128 (one box row)

    def as_c(self) -> ctypes.Array:
        return _MapArg(*self.dims, *self.strides, *self.box, self.swizzle)


def tma_map_args(t: torch.Tensor, rows: int) -> TmaMap:
    """The tensor map of a bfloat16 [B, S, heads, D] view ``t`` (any
    strides, head_dim contiguous) with boxes of ``rows`` rows by
    ``min(D, 64)`` columns (D / 64 boxes a row at D = 128 and 256),
    swizzled by the box row's bytes.  Raises
    ``ValueError`` naming the condition TMA needs that ``t`` breaks."""
    b, s, n, d = t.shape
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"flash_attention: TMA boxes take head_dim in {TC_HEAD_DIMS}, got {d}")
    if t.stride(-1) != 1:
        raise ValueError("flash_attention: TMA needs the head_dim axis contiguous (stride 1)")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: TMA needs a 16-byte aligned base address, got "
                         f"one {t.data_ptr() % 16} bytes past a multiple of 16")
    size = t.element_size()
    strides = tuple(t.stride(i) * size for i in (1, 2, 0))
    for name, st in zip(("sequence", "head", "batch"), strides):
        if st % 16:
            raise ValueError(f"flash_attention: TMA needs strides in multiples of 16 bytes, "
                             f"the {name} stride is {st} bytes")
    cols = min(d, 64)
    return TmaMap((d, s, n, b), strides, (cols, rows, 1, 1), cols * size)


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
    if k.shape[0] != b or k.shape[-1] != d or min(b, sq, sk, kv, d) < 1 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k, v {tuple(k.shape)} "
                         "need the same batch and head_dim, non-empty axes and "
                         "H a multiple of KV")
    if causal and sq != sk:
        raise ValueError(f"causal flash_attention needs Sq == Sk (got {sq}, {sk}): the "
                         "kernel aligns the causal mask at 0, the plain version on the right")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if dev.type == "cuda":
        route(q.dtype, d)
        if window is not None and sq != sk:
            raise ValueError(f"a windowed flash_attention kernel needs Sq == Sk (got {sq}, "
                             f"{sk}): it aligns the window at 0, the plain version on the "
                             "right")
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

    ``causal`` needs ``Sq == Sk``, and so does ``window`` on a CUDA tensor
    (the kernels align masks at 0, the plain version on the right);
    ``window`` keeps keys with
    ``qpos − kpos < window``; ``softcap`` caps scores at ``c·tanh(s/c)``;
    ``scale`` defaults to ``1/sqrt(D)``.  On a CUDA tensor the head_dim
    axis must be contiguous and the kernels read the other axes through
    their strides; a bfloat16 view must also be one TMA can take
    (``tma_map_args``).
    """
    dev = _check(q, k, v, causal, window, softcap)
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)

    kernel = route(q.dtype, d)
    options = (float(scale), int(causal), -1 if window is None else int(window),
             int(softcap is not None), float(softcap or 0.0))
    if kernel == TENSOR_CORE:
        maps = [tma_map_args(q, Q_BOX_ROWS).as_c(), tma_map_args(k, kv_box_rows(d)).as_c(),
                tma_map_args(v, kv_box_rows(d)).as_c()]
        fn = _build.load(TENSOR_CORE).flash_attention_wgmma_launch
        fn.argtypes, fn.restype = _WGMMA_ARGTYPES, ctypes.c_int
    else:
        fn = _build.load(CUDA_CORE).flash_attention_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if kernel == TENSOR_CORE:
            rc = fn(*ptrs, *maps, b, sq, k.shape[1], h, k.shape[2], d, *options, stream)
        else:
            rc = fn(*ptrs, b, sq, k.shape[1], h, k.shape[2], d,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *options, stream)
    if rc == _NO_ENCODER:
        raise RuntimeError("flash_attention: libcuda has no cuTensorMapEncodeTiled")
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused a map: "
                           f"CUresult {rc - _ENCODE_FAILED}")
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.kernel_launches[kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.kernel_launches = {TENSOR_CORE: 0, CUDA_CORE: 0}
