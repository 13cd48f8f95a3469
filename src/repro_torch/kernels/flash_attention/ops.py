"""The ``flash_attention`` op: prefill attention's entry point.

The op follows its inputs' device.  CPU tensors run the plain PyTorch
version in ``ref.py``, which is how a caller asks for the CPU.  CUDA
tensors launch one of three kernels (built on first use by
``kernels._build``) on the current stream, without synchronizing, by a
fixed rule on dtype and head_dim (``route``):

* bfloat16 with (q, k head_dim, v head_dim) in ``TC_HEAD_DIM_PAIRS`` →
  ``flash_attention_wgmma`` (``csrc/flash_attention_wgmma.cu``): wgmma on
  the tensor cores, fed by TMA, one tile a pair (``Tile<D, Dv, kCap>``), v as
  narrow as the Pallas kernel takes it (MLA's 192 / 128).
  ``tma_map_args`` computes each input's tensor-map arguments and raises
  ``ValueError`` where TMA cannot take the view (base address not 16-byte
  aligned, a stride not a multiple of 16 bytes);
* float32 with one head_dim up to ``MAX_HEAD_DIM`` for q, k and v →
  ``flash_attention``
  (``csrc/flash_attention.cu``): float32, split TF32 on the tensor cores
  (each operand hi + lo, three TF32 products a product, float32's
  accuracy; one TF32 pass would miss 2e-5) up to head_dim 128, fp32 FMAs
  on the CUDA cores above (the source picks by head_dim; ``CUDA_CORE``
  keeps its name);
* either dtype with max(D, Dv) above ``MAX_HEAD_DIM`` (the widest tile of
  those two) → ``flash_attention_wide`` (``csrc/flash_attention_wide.cu``):
  fp32 FMAs on the CUDA cores at the widths as they come, q·kᵀ streamed
  over D in 64-column chunks and the output in ``WIDE_V_SLAB``-column slabs
  of v, each slab's block recomputing its rows' scores, so its shared
  memory does not grow with the widths.

The op takes any widths D, Dv >= 1 on every device, as the Pallas kernel
does.  On a CUDA (or fake) tensor it runs the kernels at the widths
``kernel_widths`` names: a bfloat16 call that needs no grad, at a pair of
``TC_HEAD_DIM_PAIRS``, at its own widths; a call with max(D, Dv) above
``MAX_HEAD_DIM`` at its own widths too (the wide kernels); every other call
at one width, the least of ``TC_HEAD_DIMS`` that holds max(D, Dv).  q, k
and v are padded with zero columns to those widths inside the op (zero
columns add exactly 0 to every score and leave the row stats as they are),
with the scale of the unpadded D, and the output and each gradient are cut
back.  The plain version takes the widths as they come, unpadded.
``route`` and ``bwd_route`` are the fixed tables of the tiles that exist
and raise for a pair without one.  There is no fallback between the
kernels or to the plain version.
``flash_attention.launches`` counts all kernel launches,
``flash_attention.kernel_launches`` the launches of each kernel and
``flash_attention.tile_launches`` the tensor-core kernel's by its
(D, Dv) pair.

Training: when grad is enabled and q, k or v requires grad, the op runs
as :class:`FlashAttention`, a ``torch.autograd.Function`` on every device.
Its forward is the same kernel (or plain version) asked also for the row
stats m and l, and saves (q, k, v, out, m, l).  Its backward follows the
device in the same way: CUDA tensors launch the backward kernel that
``bwd_route`` names (``flash_attention_bwd_kernel``), by the same rule as
the forward's, at one head_dim for q, k and v (``TC_HEAD_DIMS``: a
grad-requiring call pads to one of them, ``kernel_widths(..., grad=True)``):

* bfloat16 → ``flash_attention_bwd_wgmma``
  (``csrc/flash_attention_bwd_wgmma.cu``): dK/dV and dQ in two passes on
  wgmma, fed by TMA, no atomics;
* float32 → ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``): the
  same two passes, float32, split TF32 on the tensor cores up to head_dim
  64, fp32 FMAs on the CUDA cores above;
* either dtype above ``MAX_HEAD_DIM`` → ``flash_attention_wide_bwd``
  (``csrc/flash_attention_wide_bwd.cu``): the same two passes on the CUDA
  cores at the widths as they come, s and dP streamed over D and Dv, dK /
  dV in ``WIDE_KV_SLAB``-column slabs and dQ in ``WIDE_Q_SLAB``-column
  ones, each slab's block recomputing s and dP.

CPU tensors run ``backward.flash_attention_bwd``, the JAX package's
``_fa_bwd`` in plain PyTorch over ``q_chunk`` × ``kv_chunk`` blocks.
``flash_attention.bwd_launches`` counts backward kernel launches (one a
call, which runs the kernel's three parts) and
``flash_attention.bwd_kernel_launches`` those of each backward kernel.
``flash_attention_fwd`` is the forward with the stats, for callers that
check them.

Both entries (``_forward``, reached from ``flash_attention``,
``flash_attention_fwd`` and ``FlashAttention.forward``, and
``FlashAttention.backward``) report their work to a running
``analysis.op_cost`` counter on every route: 2·B·H·(D + Dv) FLOPs a kept
score forward and 2.5× that backward (``kept_scores``), each input read
once and each output written once; the wide kernels report their own
products (``wide_flops_per_score``: the scores recomputed in each slab).
On a fake tensor (the dry run's) they
return empty outputs and run nothing; a fake tensor stands for a card
tensor, so it is checked as one.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import op_cost
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: The widest tile of the tiled kernels (the float32 kernel's 16 output
#: columns a thread on the CUDA cores above head_dim 128; the tensor-core
#: kernel's four 64-column TMA boxes).  A call with a wider q, k or v takes
#: the wide kernels (``CUDA_CORE_WIDE``, ``CUDA_CORE_WIDE_BWD``).
MAX_HEAD_DIM = 256
#: bfloat16 head_dims of both tensor-core kernels, forward and backward, at
#: one width for q, k and v: a multiple of wgmma's depth of 16 whose
#: swizzled TMA box row (D·2 bytes, at most 128) tiles D.  The op pads
#: other widths to the least of these (``kernel_widths``).
TC_HEAD_DIMS = (16, 32, 64, 128, 256)
#: (q, k head_dim, v head_dim) pairs of the tensor-core forward, one tile
#: each: ``TC_HEAD_DIMS`` at one width, heads of 80 (zamba2's shared block,
#: hubert) and MLA's 192 / 128 (deepseek-v2).
TC_HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (192, 128),
                     (256, 256))
#: Widths of a q, k or v that the tensor-core forward's TMA boxes take.
TMA_WIDTHS = tuple(sorted({w for pair in TC_HEAD_DIM_PAIRS for w in pair}))
#: The two kernels, by their ``_build.SOURCES`` names.
TENSOR_CORE, CUDA_CORE = "flash_attention_wgmma", "flash_attention"
#: The kernels of widths above ``MAX_HEAD_DIM``, forward and backward, in
#: both dtypes, by their ``_build.SOURCES`` names.
CUDA_CORE_WIDE, CUDA_CORE_WIDE_BWD = "flash_attention_wide", "flash_attention_wide_bwd"
#: Output columns a block of the wide forward owns (``kSlab``), and of each
#: of dK and dV (``kKvSlab``) and of dQ (``kQSlab``) in the wide backward;
#: every slab's block recomputes its scores.
WIDE_V_SLAB, WIDE_KV_SLAB, WIDE_Q_SLAB = 256, 128, 256
#: Query rows per TMA box of q in the tensor-core kernel (a consumer
#: warpgroup's rows).
Q_BOX_ROWS = 64

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])
_MapArg = ctypes.c_ulonglong * 12
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 6 + [_MapArg] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p])
#: Error codes the tensor-core launch adds to CUDA's.
_NO_ENCODER, _ENCODE_FAILED = 9999, 10000
#: The backward kernels, by their ``_build.SOURCES`` names, and the forward
#: kernel whose calls each differentiates.
TENSOR_CORE_BWD, CUDA_CORE_BWD = "flash_attention_bwd_wgmma", "flash_attention_bwd"
_BWD = {TENSOR_CORE: TENSOR_CORE_BWD, CUDA_CORE: CUDA_CORE_BWD,
        CUDA_CORE_WIDE: CUDA_CORE_WIDE_BWD}
#: Rows of the TMA boxes of q and dO in the tensor-core backward (its dK/dV
#: kernel's 64-query tiles, its dQ kernel's 64 query rows a warpgroup); its
#: k, v boxes are ``bwd_key_block_rows`` (dK/dV) and ``bwd_kv_box_rows`` (dQ).
BWD_TILE_ROWS = 64
#: The largest head_dim at which each of the two consumer warpgroups of the
#: tensor-core backward's dK/dV kernel owns 64 of its block's keys
#: (``kOwnKeysMaxD``); above it the two split the steps of a 64-key block.
BWD_OWN_KEYS_MAX_D = 128
#: The tensor-core backward's row-stats scratch is padded to a multiple of
#: its query tile (``kStatsPad`` in the kernel), one bulk copy a tile.
BWD_STATS_PAD = 64
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_void_p])
_BWD_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 12 + [_MapArg] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
# the wide kernels: D and Dv, and a last int that says bfloat16
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_WIDE_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def route(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """The kernel that serves CUDA inputs of ``dtype`` with q, k of
    ``head_dim`` and v of ``v_head_dim`` (``head_dim`` when None):
    ``CUDA_CORE_WIDE`` for either dtype where the wider is above
    ``MAX_HEAD_DIM``, else ``TENSOR_CORE`` for bfloat16 at a pair of
    ``TC_HEAD_DIM_PAIRS``, ``CUDA_CORE`` for float32 at one head_dim (the
    float32 kernel: split TF32 on the tensor cores up to head_dim 128, fp32
    FMAs on the CUDA cores above, by its source's fixed rule).  A fixed
    table, not a fallback: a pair the dtype's kernel has no tile for raises
    ``ValueError``."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if dtype in _DTYPES and min(head_dim, dv) >= 1 and max(head_dim, dv) > MAX_HEAD_DIM:
        return CUDA_CORE_WIDE
    if dtype == torch.float32:
        if not 1 <= head_dim <= MAX_HEAD_DIM or dv != head_dim:
            raise ValueError(f"flash_attention: the float32 kernel takes one "
                             f"head_dim <= {MAX_HEAD_DIM} for q, k and v, got "
                             f"{head_dim} and v {dv}")
        return CUDA_CORE
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {dtype}")
    if (head_dim, dv) not in TC_HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention: the bfloat16 tensor-core kernel takes head_dim "
                         f"(q, k) and v head_dim in the pairs {TC_HEAD_DIM_PAIRS}, got "
                         f"({head_dim}, {dv})")
    return TENSOR_CORE


def bwd_route(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """The backward kernel that serves CUDA inputs of ``dtype`` with q, k of
    ``head_dim`` and v of ``v_head_dim`` (``head_dim`` when None): the one
    beside the forward kernel ``route`` names (``TENSOR_CORE_BWD`` for
    bfloat16, ``CUDA_CORE_BWD`` for float32), at one head_dim for q, k and
    v, in bfloat16 one of ``TC_HEAD_DIMS``; ``CUDA_CORE_WIDE_BWD`` above
    ``MAX_HEAD_DIM``, at any pair.  Raises ``ValueError`` for a pair it has
    no tile for (the forward's (80, 80) and (192, 128) among them), and as
    ``route`` does."""
    dv = head_dim if v_head_dim is None else v_head_dim
    kernel = route(dtype, head_dim, dv)
    if kernel == TENSOR_CORE and (dv != head_dim or head_dim not in TC_HEAD_DIMS):
        raise ValueError(f"flash_attention: the bfloat16 backward kernel takes one "
                         f"head_dim in {TC_HEAD_DIMS} for q, k and v, got ({head_dim}, {dv})")
    return _BWD[kernel]


def kernel_widths(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None,
                  grad: bool = False) -> Tuple[int, int]:
    """The (q·k, v) widths at which the kernels run a CUDA call of ``dtype``
    with q, k of ``head_dim`` and v of ``v_head_dim`` (``head_dim`` when
    None); ``grad`` says whether the call is differentiated.  A bfloat16
    call without grad at a pair of ``TC_HEAD_DIM_PAIRS`` runs at its own
    widths, and so does every call whose wider is above ``MAX_HEAD_DIM``
    (the wide kernels: padding would only add work); every other call at
    one width, the least of ``TC_HEAD_DIMS`` that holds the wider (80 →
    128; 192 and 128 → 256).  Raises ``ValueError`` for a width below 1."""
    dv = head_dim if v_head_dim is None else v_head_dim
    if dtype == torch.bfloat16 and not grad and (head_dim, dv) in TC_HEAD_DIM_PAIRS:
        return head_dim, dv
    width = max(head_dim, dv)
    if not 1 <= min(head_dim, dv):
        raise ValueError(f"flash_attention: the kernels take head_dims >= 1 for q, k and "
                         f"v, got ({head_dim}, {dv})")
    if width > MAX_HEAD_DIM:
        return head_dim, dv
    hd = next(t for t in TC_HEAD_DIMS if t >= width)
    return hd, hd


def _at_kernel_widths(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` runs at ``kernel_widths``: a CUDA tensor, or
    the dry run's fake one (the plain version takes CPU tensors' widths as
    they come)."""
    return t.device.type == "cuda" or op_cost.is_fake(t)


def _pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns up to ``width`` (``t`` itself at that width:
    a strided view reaches the kernel unchanged)."""
    return t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def bwd_kv_box_rows(head_dim: int) -> int:
    """Keys per TMA box of k, v in the tensor-core backward's dQ kernel (one
    K/V ring stage, ``Tile::kBK``): 128 up to head_dim 64, 64 at 128 and 32
    at 256, as many keys as the score fragments beside the dQ accumulator
    leave registers for.  Its dK/dV kernel reads k, v in
    ``bwd_key_block_rows`` boxes, q and dO in ``BWD_TILE_ROWS``."""
    return {128: 64, 256: 32}.get(head_dim, 128)


def bwd_key_block_rows(head_dim: int) -> int:
    """Keys per block, and per TMA box of k, v, in the tensor-core backward's
    dK/dV kernel (``Tile::kBlockKeys``): 128, two warpgroups of 64 that each
    do every product for their own keys, or 64 above ``BWD_OWN_KEYS_MAX_D``
    (head_dim 256), where the dK and dV accumulators of one warpgroup would
    not fit in its registers and the two warpgroups split the work.  A fixed
    rule by head_dim."""
    return 128 if head_dim <= BWD_OWN_KEYS_MAX_D else 64


def kv_box_rows(head_dim: int, v_head_dim: Optional[int] = None) -> int:
    """Keys per TMA box of k and v (one KV tile of the tensor-core kernel)
    for q, k of ``head_dim`` (v's width does not change it): 128, or 64 at
    head_dim 128 and above, where the fragments of 128 keys would not fit
    in registers, and at the widths that are no power of two (80, 192),
    whose tiles run three warpgroups (``Tile::kBK`` in the kernel)."""
    return 64 if head_dim >= 128 or head_dim & (head_dim - 1) else 128


def box_columns(width: int) -> int:
    """Columns of a TMA box of a ``width``-wide bfloat16 operand: one
    swizzle span, the widest of 128, 64 and 32 bytes that tiles a row's
    2·width bytes (``box_row_bytes`` in the kernel): 64 at 64, 128, 192
    and 256, the whole row at 16 and 32, 16 at 80 (five boxes a row)."""
    row = 2 * width
    return (128 if row % 128 == 0 else 64 if row % 64 == 0 else 32) // 2


class TmaMap(NamedTuple):
    """Arguments of ``cuTensorMapEncodeTiled`` for one [B, S, heads, D] input."""
    dims: Tuple[int, int, int, int]      # {D, S, heads, B}, innermost first
    strides: Tuple[int, int, int]        # bytes between rows, heads, batches
    box: Tuple[int, int, int, int]       # {columns, rows, 1, 1}
    swizzle: int                         # bytes: 32, 64 or 128 (one box row)

    def as_c(self) -> ctypes.Array:
        return _MapArg(*self.dims, *self.strides, *self.box, self.swizzle)


def tma_map_args(t: torch.Tensor, rows: int) -> TmaMap:
    """The tensor map of a bfloat16 [B, S, heads, width] view ``t`` (any
    strides, the last axis contiguous) with boxes of ``rows`` rows by
    ``box_columns(width)`` columns (several boxes a row past 64 columns and
    at 80), swizzled by the box row's bytes.  ``width`` is one of
    ``TMA_WIDTHS``: q's and k's of a pair, or v's.  Raises ``ValueError``
    naming the condition TMA needs that ``t`` breaks."""
    b, s, n, d = t.shape
    if d not in TMA_WIDTHS:
        raise ValueError(f"flash_attention: TMA boxes take head_dim in {TMA_WIDTHS}, got {d}")
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
    cols = box_columns(d)
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention wants q [B,Sq,H,D], k [B,Sk,KV,D] and v "
                         f"[B,Sk,KV,Dv], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]
    if k.shape[0] != b or k.shape[-1] != d or min(b, sq, sk, kv, d, dv) < 1 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} need the same batch, q and k the same "
                         "head_dim, non-empty axes and H a multiple of KV")
    if causal and sq != sk:
        raise ValueError(f"causal flash_attention needs Sq == Sk (got {sq}, {sk}): the "
                         "kernel aligns the causal mask at 0, the plain version on the right")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if dev.type == "cuda" or op_cost.is_fake(q):
        route(q.dtype, *kernel_widths(q.dtype, d, dv))
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
    """q: [B,Sq,H,D]; k: [B,Sk,KV,D]; v: [B,Sk,KV,Dv] (GQA: H = KV·G, query
    head ``h`` reads KV head ``h // G``).  Returns [B,Sq,H,Dv] in q's dtype,
    as the Pallas kernel does.

    ``causal`` needs ``Sq == Sk``, and so does ``window`` on a CUDA tensor
    (the kernels align masks at 0, the plain version on the right);
    ``window`` keeps keys with
    ``qpos − kpos < window``; ``softcap`` caps scores at ``c·tanh(s/c)``;
    ``scale`` defaults to ``1/sqrt(D)``.  On a CUDA tensor the op runs the
    kernels at ``kernel_widths``
    (q, k, v padded with zero columns, the output cut back), the head_dim
    axes must be contiguous and the kernels read the other axes through
    their strides; a bfloat16 view the kernel takes at its own widths must
    also be one TMA can take (``tma_map_args``).  When grad is enabled and
    an input requires grad, the call is differentiable
    (:class:`FlashAttention`), and its backward works in blocks of
    ``q_chunk`` query rows by ``kv_chunk`` keys (the model config's).
    """
    _check(q, k, v, causal, window, softcap)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale, q_chunk,
                                    kv_chunk)
    return _padded_forward(q, k, v, causal, window, softcap, scale, stats=False)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's forward with the row stats: ``(out, m, l)``, out
    [B,Sq,H,Dv] as ``flash_attention``'s, m and l
    float32 [B,H,Sq] in the natural-log domain of the scaled scores (the
    kernels store them; the plain version computes them; zero columns
    padded to ``kernel_widths`` leave them as they are).  Not
    differentiable."""
    _check(q, k, v, causal, window, softcap)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _padded_forward(q, k, v, causal, window, softcap, scale, stats=True)


def _padded_forward(q, k, v, causal, window, softcap, scale, stats: bool):
    """``_forward`` at ``kernel_widths`` on a CUDA or fake tensor (q, k, v
    padded with zero columns, the output cut back to v's width), at the
    widths as they come on the CPU."""
    dv = v.shape[-1]
    if not _at_kernel_widths(q):
        return _forward(q, k, v, causal, window, softcap, scale, stats)
    kd, kdv = kernel_widths(q.dtype, q.shape[-1], dv)
    out, m, l = _forward(_pad_columns(q, kd), _pad_columns(k, kd), _pad_columns(v, kdv),
                         causal, window, softcap, scale, stats)
    return (out if kdv == dv else out[..., :dv]), m, l


def kept_scores(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """Scores a (batch, head) keeps: query ``i`` sits at ``i + sk − sq``
    (right-aligned, as the plain version; the kernels take Sq == Sk where
    a mask is on) and keeps key ``j`` where ``j <= qpos`` (causal) and
    ``qpos − j < window``."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk, dtype=np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def wide_flops_per_score(d: int, dv: int, backward: bool) -> int:
    """FLOPs a kept score of the wide kernels, as they do the work: the
    forward sums q·kᵀ (2·D) in each of its ceil(Dv / ``WIDE_V_SLAB``) slabs
    and p·v (2·Dv) once, 2·(D·ceil(Dv / 256) + Dv); the backward recomputes
    s and dP (2·(D + Dv)) in each of its ceil(max(D, Dv) / ``WIDE_KV_SLAB``)
    dK/dV slabs and ceil(D / ``WIDE_Q_SLAB``) dQ slabs, and sums dV (2·Dv),
    dK (2·D) and dQ (2·D) once, 2·(D + Dv)·(ceil(max(D, Dv) / 128) +
    ceil(D / 256)) + 2·Dv + 4·D."""
    if not backward:
        return 2 * (d * -(-dv // WIDE_V_SLAB) + dv)
    slabs = -(-max(d, dv) // WIDE_KV_SLAB) + -(-d // WIDE_Q_SLAB)
    return 2 * (d + dv) * slabs + 2 * dv + 4 * d


def _work(q, k, v, causal, window, tensors, backward: bool, stats: bool = False):
    """``op_cost.kernel``'s work of a forward (or backward) call: products,
    the bytes of ``tensors`` (each read or written once; a forward's
    ``[B,Sq,H,Dv]`` output besides, and with ``stats`` its m and l),
    exponentials.  Products: 2·(D + Dv) a kept score forward and 2.5× that
    backward, or on a card's wide route (max(D, Dv) above ``MAX_HEAD_DIM``)
    ``wide_flops_per_score``."""
    def work():
        b, sq, h, d = q.shape
        dv = v.shape[-1]
        kept = b * h * kept_scores(sq, k.shape[1], causal, window)
        if _at_kernel_widths(q) and max(d, dv) > MAX_HEAD_DIM:
            flops = float(wide_flops_per_score(d, dv, backward) * kept)
        else:
            flops = 2.0 * (d + dv) * kept * (2.5 if backward else 1.0)
        n_bytes = op_cost.tensor_bytes(*tensors) + (2 * 4 * b * h * sq if stats else 0)
        if not backward:
            n_bytes += b * sq * h * dv * q.element_size()
        return flops, n_bytes, float(kept)
    return work


class FlashAttention(torch.autograd.Function):
    """The op under autograd: forward by the kernel (CUDA) or the plain
    version (CPU) with the row stats, backward by the backward kernel
    (CUDA, ``flash_attention_bwd_kernel``) or ``flash_attention_bwd``
    (CPU).  On a CUDA or fake tensor q, k and v are padded to
    ``kernel_widths(..., grad=True)`` inside, and the output and the
    gradients are cut back to the caller's widths."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk, kv_chunk):
        d, dv = q.shape[-1], v.shape[-1]
        if _at_kernel_widths(q):
            kd, kdv = kernel_widths(q.dtype, d, dv, grad=True)
            bwd_route(q.dtype, kd, kdv)          # raises before the forward runs
            q, k, v = _pad_columns(q, kd), _pad_columns(k, kd), _pad_columns(v, kdv)
        out, m, l = _forward(q, k, v, causal, window, softcap, scale, stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.widths = (d, dv)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out if out.shape[-1] == dv else out[..., :dv].contiguous()

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        o = ctx.opts
        d, dv = ctx.widths
        dout = _pad_columns(dout, v.shape[-1])
        # dq, dk, dv are written in q's, k's and v's sizes
        work = _work(q, k, v, o["causal"], o["window"], (q, k, v, out, m, l, dout, q, k, v),
                     backward=True)
        with op_cost.kernel("flash_attention_bwd", work):
            if q.device.type == "cpu" and not op_cost.is_fake(q):
                dq, dk, dv_ = flash_attention_bwd(q, k, v, out, m, l, dout, **o)
            else:
                opts = {n: o[n] for n in ("causal", "window", "softcap", "scale")}
                dq, dk, dv_ = flash_attention_bwd_kernel(q, k, v, out, m, l, dout, **opts)
        if q.shape[-1] != d or v.shape[-1] != dv:        # cut the padding's columns off
            dq, dk, dv_ = dq[..., :d], dk[..., :d], dv_[..., :dv]
        return dq, dk, dv_, None, None, None, None, None, None


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
    fake = op_cost.is_fake(q)
    if dev.type != "cuda" and not fake:
        raise ValueError(f"flash_attention_bwd_kernel takes CUDA tensors, got {dev}; the "
                         "CPU's backward is backward.flash_attention_bwd")
    b, sq, h, d = q.shape
    sk, kvh, dv_w = k.shape[1], k.shape[2], v.shape[-1]
    kernel = bwd_route(q.dtype, d, dv_w)
    if fake:   # the dry run: the gradients' shapes, nothing launched
        return (torch.empty_like(q, memory_format=torch.contiguous_format),
                torch.empty_like(k, memory_format=torch.contiguous_format),
                torch.empty_like(v, memory_format=torch.contiguous_format))
    for name, t, shape, dtype in (("out", out, (b, sq, h, dv_w), q.dtype),
                                  ("dout", dout, (b, sq, h, dv_w), q.dtype),
                                  ("m", m, (b, h, sq), torch.float32),
                                  ("l", l, (b, h, sq), torch.float32)):
        if t.device != dev or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"flash_attention_bwd_kernel: {name} must be {dtype} "
                             f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if -(-sk // 64) > 65535:
        raise ValueError(f"flash_attention backward kernel grid too large for Sk={sk}")
    out, dout, m, l = (t.contiguous() for t in (out, dout, m, l))
    if kernel == TENSOR_CORE_BWD:
        # the prologue reads out and dout 16 bytes a lane
        out, dout = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (out, dout))
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, kvh, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, sk, kvh, dv_w), dtype=v.dtype, device=dev)
    # the row scratch: Δ, and for the tensor-core kernel the log-sum-exp, padded
    pad = -(-sq // BWD_STATS_PAD) * BWD_STATS_PAD if kernel == TENSOR_CORE_BWD else sq
    scratch = [torch.empty((b, h, pad), dtype=torch.float32, device=dev)
               for _ in range(2 if kernel == TENSOR_CORE_BWD else 1)]
    options = (float(scale), int(causal), -1 if window is None else int(window),
               int(softcap is not None), float(softcap or 0.0))
    if kernel == TENSOR_CORE_BWD:
        maps = [tma_map_args(t, rows) for t, rows in
                ((q, BWD_TILE_ROWS), (dout, BWD_TILE_ROWS), (k, bwd_key_block_rows(d)),
                 (v, bwd_key_block_rows(d)), (k, bwd_kv_box_rows(d)), (v, bwd_kv_box_rows(d)))]
        fn = _build.load(kernel).flash_attention_bwd_wgmma_launch
        fn.argtypes, fn.restype = _BWD_WGMMA_ARGTYPES, ctypes.c_int
    elif kernel == CUDA_CORE_WIDE_BWD:
        fn = _build.load(kernel).flash_attention_wide_bwd_launch
        fn.argtypes, fn.restype = _WIDE_BWD_ARGTYPES, ctypes.c_int
    else:
        fn = _build.load(kernel).flash_attention_bwd_launch
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, out, dout, m, l, dq, dk, dv, *scratch)]
        if kernel == TENSOR_CORE_BWD:
            rc = fn(*ptrs, *(mp.as_c() for mp in maps), b, sq, sk, h, kvh, d, pad,
                    *options, stream)
        elif kernel == CUDA_CORE_WIDE_BWD:
            rc = fn(*ptrs, b, sq, sk, h, kvh, d, dv_w, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *options, int(q.dtype == torch.bfloat16), stream)
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
    kernel for CUDA tensors, the plain version for CPU tensors, empty
    outputs for fake tensors; the work reported to ``op_cost``."""
    b, sq, h, _ = q.shape
    dv = v.shape[-1]
    with op_cost.kernel("flash_attention_fwd",
                        _work(q, k, v, causal, window, (q, k, v), False, stats)):
        if op_cost.is_fake(q):
            out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
            m, l = ((torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
                     for _ in range(2)) if stats else (None, None))
            return out, m, l
        return _launch(q, k, v, causal, window, softcap, scale, stats)


def _launch(q, k, v, causal, window, softcap, scale, stats: bool):
    b, sq, h, d = q.shape
    if q.device.type == "cpu":
        with torch.no_grad():
            res = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                      scale=scale, return_stats=stats)
        return res if stats else (res, None, None)

    dev = q.device
    dv = v.shape[-1]
    kernel = route(q.dtype, d, dv)
    options = (float(scale), int(causal), -1 if window is None else int(window),
             int(softcap is not None), float(softcap or 0.0))
    if kernel == TENSOR_CORE:
        maps = [tma_map_args(q, Q_BOX_ROWS).as_c(), tma_map_args(k, kv_box_rows(d, dv)).as_c(),
                tma_map_args(v, kv_box_rows(d, dv)).as_c()]
        fn = _build.load(TENSOR_CORE).flash_attention_wgmma_launch
        fn.argtypes, fn.restype = _WGMMA_ARGTYPES, ctypes.c_int
    elif kernel == CUDA_CORE_WIDE:
        fn = _build.load(CUDA_CORE_WIDE).flash_attention_wide_launch
        fn.argtypes, fn.restype = _WIDE_ARGTYPES, ctypes.c_int
    else:
        fn = _build.load(CUDA_CORE).flash_attention_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    m = l = None
    if stats:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        l = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if m is None else m.data_ptr(), None if l is None else l.data_ptr())
        if kernel == TENSOR_CORE:
            rc = fn(*ptrs, *maps, b, sq, k.shape[1], h, k.shape[2], d, dv, *options, stream)
        elif kernel == CUDA_CORE_WIDE:
            rc = fn(*ptrs, b, sq, k.shape[1], h, k.shape[2], d, dv, *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], *options,
                    int(q.dtype == torch.bfloat16), stream)
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
    if kernel == TENSOR_CORE:
        flash_attention.tile_launches[(d, dv)] += 1
    return out, m, l


flash_attention.launches = 0
flash_attention.kernel_launches = {TENSOR_CORE: 0, CUDA_CORE: 0, CUDA_CORE_WIDE: 0}
flash_attention.tile_launches = dict.fromkeys(TC_HEAD_DIM_PAIRS, 0)
flash_attention.bwd_launches = 0
flash_attention.bwd_kernel_launches = {TENSOR_CORE_BWD: 0, CUDA_CORE_BWD: 0,
                                       CUDA_CORE_WIDE_BWD: 0}
