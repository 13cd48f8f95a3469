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

Training: when grad is enabled and q, k or v requires grad, the op runs
as :class:`FlashAttention`, a ``torch.autograd.Function`` on every device.
Its forward is the same kernel (or plain version) asked also for the row
stats m and l, and saves (q, k, v, out, m, l).  Its backward follows the
device in the same way: CUDA tensors launch the backward kernel that
``bwd_route`` names (``flash_attention_bwd_kernel``), by the same rule as
the forward's:

* bfloat16 → ``flash_attention_bwd_wgmma``
  (``csrc/flash_attention_bwd_wgmma.cu``): dK/dV and dQ in two passes on
  wgmma, fed by TMA, no atomics;
* float32 → ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``): the
  same two passes as fp32 FMAs on the CUDA cores.

CPU tensors run ``backward.flash_attention_bwd``, the JAX package's
``_fa_bwd`` in plain PyTorch over ``q_chunk`` × ``kv_chunk`` blocks.
``flash_attention.bwd_launches`` counts backward kernel launches (one a
call, which runs the kernel's three parts) and
``flash_attention.bwd_kernel_launches`` those of each backward kernel.
``flash_attention_fwd`` is the forward with the stats, for callers that
check them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
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
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])
_MapArg = ctypes.c_ulonglong * 12
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 6 + [_MapArg] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
#: Error codes the tensor-core launch adds to CUDA's.
_NO_ENCODER, _ENCODE_FAILED = 9999, 10000
#: The backward kernels, by their ``_build.SOURCES`` names, and the forward
#: kernel whose calls each differentiates.
TENSOR_CORE_BWD, CUDA_CORE_BWD = "flash_attention_bwd_wgmma", "flash_attention_bwd"
_BWD = {TENSOR_CORE: TENSOR_CORE_BWD, CUDA_CORE: CUDA_CORE_BWD}
#: Rows of the TMA boxes of q, dO, k and v in the tensor-core backward (its
#: dK/dV kernel's 64-key and 64-query tiles, its dQ kernel's 64 query rows
#: a warpgroup); the dQ kernel's k, v boxes are ``bwd_kv_box_rows``.
BWD_TILE_ROWS = 64
#: The tensor-core backward's row-stats scratch is padded to a multiple of
#: its query tile (``kStatsPad`` in the kernel), one bulk copy a tile.
BWD_STATS_PAD = 64
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_void_p])
_BWD_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 12 + [_MapArg] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])


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


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel that serves CUDA inputs of ``dtype`` and
    ``head_dim``: the one beside the forward kernel ``route`` names
    (``TENSOR_CORE_BWD`` for bfloat16, ``CUDA_CORE_BWD`` for float32); raises
    as ``route`` does."""
    return _BWD[route(dtype, head_dim)]


def bwd_kv_box_rows(head_dim: int) -> int:
    """Keys per TMA box of k, v in the tensor-core backward's dQ kernel (one
    K/V ring stage, ``Tile::kBK``): 64, or 32 at head_dim 256, where the
    score fragments of 64 keys beside the dQ accumulator would not fit in
    registers.  Its dK/dV kernel reads q, dO, k and v in 64-row boxes."""
    return 32 if head_dim == 256 else 64


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
                    scale: Optional[float] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (GQA: H = KV·G, query head ``h`` reads
    KV head ``h // G``).  Returns [B,Sq,H,D] in q's dtype.

    ``causal`` needs ``Sq == Sk``, and so does ``window`` on a CUDA tensor
    (the kernels align masks at 0, the plain version on the right);
    ``window`` keeps keys with
    ``qpos − kpos < window``; ``softcap`` caps scores at ``c·tanh(s/c)``;
    ``scale`` defaults to ``1/sqrt(D)``.  On a CUDA tensor the head_dim
    axis must be contiguous and the kernels read the other axes through
    their strides; a bfloat16 view must also be one TMA can take
    (``tma_map_args``).  When grad is enabled and an input requires grad,
    the call is differentiable (:class:`FlashAttention`), and its backward
    works in blocks of ``q_chunk`` query rows by ``kv_chunk`` keys (the
    model config's).
    """
    _check(q, k, v, causal, window, softcap)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale, q_chunk,
                                    kv_chunk)
    return _forward(q, k, v, causal, window, softcap, scale, stats=False)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's forward with the row stats: ``(out, m, l)``, m and l
    float32 [B,H,Sq] in the natural-log domain of the scaled scores (the
    kernels store them; the plain version computes them).  Not
    differentiable."""
    _check(q, k, v, causal, window, softcap)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _forward(q, k, v, causal, window, softcap, scale, stats=True)


class FlashAttention(torch.autograd.Function):
    """The op under autograd: forward by the kernel (CUDA) or the plain
    version (CPU) with the row stats, backward by the backward kernel
    (CUDA, ``flash_attention_bwd_kernel``) or ``flash_attention_bwd``
    (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk, kv_chunk):
        out, m, l = _forward(q, k, v, causal, window, softcap, scale, stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l, dout, **ctx.opts)
        else:
            opts = {n: ctx.opts[n] for n in ("causal", "window", "softcap", "scale")}
            dq, dk, dv = flash_attention_bwd_kernel(q, k, v, out, m, l, dout, **opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                               dout: torch.Tensor, *, causal: bool, window: Optional[int],
                               softcap: Optional[float], scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel that ``bwd_route`` names, on CUDA tensors: (dq,
    dk, dv) in q's, k's and v's shapes and dtype, contiguous, from the
    forward's inputs, its output ``out`` and row stats ``m``, ``l``
    (float32 [B,H,Sq]) and the cotangent ``dout``.  The kernels read q, k and
    v through their strides, as the forward does; ``out`` and ``dout`` are
    copied contiguous first where they are not (autograd may hand in a
    non-contiguous ``dout``).  Launches on the current stream without
    synchronizing.  Raises on CPU tensors (their backward is
    ``flash_attention_bwd``) and on what the kernels do not take."""
    dev = _check(q, k, v, causal, window, softcap)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd_kernel takes CUDA tensors, got {dev}; the "
                         "CPU's backward is backward.flash_attention_bwd")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kernel = bwd_route(q.dtype, d)
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("m", m, (b, h, sq), torch.float32),
                                  ("l", l, (b, h, sq), torch.float32)):
        if t.device != dev or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"flash_attention_bwd_kernel: {name} must be {dtype} "
                             f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if -(-sk // 64) > 65535:
        raise ValueError(f"flash_attention backward kernel grid too large for Sk={sk}")
    out, dout, m, l = (t.contiguous() for t in (out, dout, m, l))
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, kvh, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, sk, kvh, d), dtype=v.dtype, device=dev)
    # the row scratch: Δ, and for the tensor-core kernel the log-sum-exp, padded
    pad = -(-sq // BWD_STATS_PAD) * BWD_STATS_PAD if kernel == TENSOR_CORE_BWD else sq
    scratch = [torch.empty((b, h, pad), dtype=torch.float32, device=dev)
               for _ in range(2 if kernel == TENSOR_CORE_BWD else 1)]
    options = (float(scale), int(causal), -1 if window is None else int(window),
               int(softcap is not None), float(softcap or 0.0))
    if kernel == TENSOR_CORE_BWD:
        rows = bwd_kv_box_rows(d)
        maps = [tma_map_args(t, BWD_TILE_ROWS) for t in (q, dout, k, v)]
        maps += [tma_map_args(k, rows), tma_map_args(v, rows)]
        fn = _build.load(kernel).flash_attention_bwd_wgmma_launch
        fn.argtypes, fn.restype = _BWD_WGMMA_ARGTYPES, ctypes.c_int
    else:
        fn = _build.load(kernel).flash_attention_bwd_launch
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, out, dout, m, l, dq, dk, dv, *scratch)]
        if kernel == TENSOR_CORE_BWD:
            rc = fn(*ptrs, *(mp.as_c() for mp in maps), b, sq, sk, h, kvh, d, pad,
                    *options, stream)
        else:
            rc = fn(*ptrs, b, sq, sk, h, kvh, d, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *options, stream)
    if rc == _NO_ENCODER:
        raise RuntimeError("flash_attention: libcuda has no cuTensorMapEncodeTiled")
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused a map: "
                           f"CUresult {rc - _ENCODE_FAILED}")
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    flash_attention.bwd_launches += 1
    flash_attention.bwd_kernel_launches[kernel] += 1
    return dq, dk, dv


def _forward(q, k, v, causal, window, softcap, scale, stats: bool):
    """``(out, m, l)`` (m, l None without ``stats``) of checked inputs: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    b, sq, h, d = q.shape
    if q.device.type == "cpu":
        with torch.no_grad():
            res = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                      scale=scale, return_stats=stats)
        return res if stats else (res, None, None)

    dev = q.device
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
    m = l = None
    if stats:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        l = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if m is None else m.data_ptr(), None if l is None else l.data_ptr())
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
    return out, m, l


flash_attention.launches = 0
flash_attention.kernel_launches = {TENSOR_CORE: 0, CUDA_CORE: 0}
flash_attention.bwd_launches = 0
flash_attention.bwd_kernel_launches = {TENSOR_CORE_BWD: 0, CUDA_CORE_BWD: 0}
