"""The ``selective_scan`` op: the Mamba-1 prefill recurrence's entry point.

The op follows its inputs' device.  CUDA tensors launch the kernel in
``csrc/selective_scan.cu`` (built on first use by ``kernels._build``) on
the current stream, without synchronizing; CPU tensors run the plain
PyTorch version in ``ref.py``, which is how a caller asks for the CPU.
There is no fallback between the two: a CUDA input that the kernel
cannot take raises.  ``selective_scan.launches`` counts forward kernel
launches and ``selective_scan.bwd_launches`` backward ones.

Training: when grad is enabled and an input requires grad, the op runs as
:class:`SelectiveScan`, a ``torch.autograd.Function`` on every device.  On
CUDA its forward is the kernel asked also to store the state at every
``BOUNDARY_STEPS``-step chunk boundary, and its backward is the kernel in
``csrc/selective_scan_bwd.cu``, which recomputes each chunk's states from
those; on the CPU the forward is ``selective_scan_ref`` and the backward
``backward.selective_scan_bwd_ref``.  Only float32 trains on the card: a
grad-requiring bfloat16 CUDA call raises.

The kernel splits each channel's N <= 16 states across two lanes of a
warp, takes each decay as one ``ex2.approx`` of delta·A·log2(e), and
streams delta and x through a two-stage ring of 32-step chunks in shared
memory with ``cp.async``; its header comment has the design.  Beyond the
shapes, it needs contiguous tensors and a batch that fits its grid.  The
Pallas op's ``chunk`` / ``block_d`` are TPU tile sizes and have no
counterpart here.

The backward kernel keeps 8 states of 2 channels a thread in blocks of
``BWD_CHANNELS`` channels, all 256 of the serving shape's blocks
resident at once; it stages delta, x, dy, B and C through a ring of
4-step units with ``cp.async``, recomputes each chunk's states in 4-step
sub-chunks whose decays it keeps (1.875 exponentials a state element),
and sums dB and dC in a fixed order: two channels in registers, a warp
reduce-scatter, warps in order, then a second kernel over the blocks'
partials.  Its bound at the serving shape is the bytes it must move,
1481.6 MB in 0.4423 ms at 3.35 TB/s (the least work, one exponential a
state element, takes 0.2568 ms); its header comment has the design.

Both entries (``_run`` forward, ``SelectiveScan.backward``) report their
work to a running ``analysis.op_cost`` counter on every route: no
products, each input read once and each output written once, one
exponential a state element.  On a fake tensor (the dry run's) they
return empty outputs and run nothing; a fake tensor stands for a card
tensor, so it is checked as one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analysis import op_cost
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.backward import BOUNDARY_STEPS, selective_scan_bwd_ref
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

#: Largest state size N the kernel takes (its per-channel state registers).
MAX_STATE = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: Channels per block of the backward kernel, its ``kChannels`` (the first axis of
#: its dB, dC partials).
BWD_CHANNELS = 128


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
    if dev.type == "cuda" or op_cost.is_fake(delta):
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
    bfloat16, A_log float32, and N <= 16.  When grad is enabled and an
    input requires grad, the call is differentiable (:class:`SelectiveScan`).
    """
    dev = _check(delta, B, C, x, A_log)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (delta, B, C, x, A_log)):
        if (dev.type == "cuda" or op_cost.is_fake(x)) and x.dtype != torch.float32:
            raise TypeError(f"selective_scan: only float32 trains on the card (the backward "
                            f"kernel reads fp32 inputs), got a grad-requiring {x.dtype} call")
        return SelectiveScan.apply(delta, B, C, x, A_log)
    y, h, _ = _run(delta, B, C, x, A_log, store=False)
    return y, h


def _store_bytes(delta, B) -> int:
    """Bytes of the forward's fp32 boundary store ``[b, ⌈S/BOUNDARY_STEPS⌉,
    D, N]``."""
    b, s, d = delta.shape
    return 4 * b * -(-s // BOUNDARY_STEPS) * d * B.shape[-1]


def _work(ins, out_bytes: int):
    """``op_cost.kernel``'s work: no products, the bytes of ``ins`` read
    once and ``out_bytes`` written, one exponential a state element.  The
    boundary store counts on every route, as the card's kernels move it."""
    def work():
        b, s, d = ins[0].shape
        return 0.0, op_cost.tensor_bytes(*ins) + out_bytes, float(b * s * d * ins[1].shape[-1])
    return work


def _run(delta, B, C, x, A_log, store: bool):
    """``(y, h_final, boundary)`` of checked inputs (``boundary`` None without
    ``store`` or on real CPU tensors): the kernel for CUDA tensors, the plain
    version for CPU tensors, empty outputs for fake tensors; the work
    reported."""
    b, s, d = delta.shape
    n = B.shape[-1]
    # y in x's dtype, h_final fp32 [b, D, N], and the store
    out_bytes = (b * s * d * x.element_size() + 4 * b * d * n
                 + (_store_bytes(delta, B) if store else 0))
    with op_cost.kernel("selective_scan", _work((delta, B, C, x, A_log), out_bytes)):
        if op_cost.is_fake(delta):
            dev = delta.device
            bnd = (torch.empty((b, -(-s // BOUNDARY_STEPS), d, n), dtype=torch.float32,
                               device=dev) if store else None)
            return (torch.empty((b, s, d), dtype=x.dtype, device=dev),
                    torch.empty((b, d, n), dtype=torch.float32, device=dev), bnd)
        if delta.device.type == "cpu":
            y, h = selective_scan_ref(delta, B, C, x, A_log)
            return y, h, None
        return _forward(delta, B, C, x, A_log, store=store)


class SelectiveScan(torch.autograd.Function):
    """The op under autograd: forward by the kernel with its boundary store
    (CUDA) or the plain version (CPU), backward by the backward kernel
    (CUDA) or ``selective_scan_bwd_ref`` (CPU)."""

    @staticmethod
    def forward(ctx, delta, B, C, x, A_log):
        y, h, boundary = _run(delta, B, C, x, A_log, store=True)
        ctx.save_for_backward(delta, B, C, x, A_log, boundary)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        delta, B, C, x, A_log, boundary = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        # reads the inputs, the store, dy and dh; writes a gradient per input
        work = _work((delta, B, C, x, A_log, dy, dh), _store_bytes(delta, B)
                     + op_cost.tensor_bytes(delta, B, C, x, A_log))
        with op_cost.kernel("selective_scan_bwd", work):
            if delta.device.type == "cpu" and not op_cost.is_fake(delta):
                grads = selective_scan_bwd_ref(delta, B, C, x, A_log, dy, dh)
            else:
                grads = selective_scan_bwd(delta, B, C, x, A_log, boundary, dy.contiguous(),
                                           None if dh is None else dh.contiguous())
        return tuple(g.to(t.dtype) if need else None for g, t, need in
                     zip(grads, (delta, B, C, x, A_log), ctx.needs_input_grad))


def _forward(delta, B, C, x, A_log, store: bool):
    """``(y, h_final, boundary)`` of checked CUDA inputs; ``boundary`` is the
    fp32 ``[b, ⌈S/BOUNDARY_STEPS⌉, D, N]`` store when ``store``, else None."""
    b, s, d = delta.shape
    n = B.shape[-1]
    dev = delta.device
    fn = _build.load("ssm_scan").selective_scan_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    y = torch.empty((b, s, d), dtype=x.dtype, device=dev)
    h = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    boundary = None
    if store:   # the kernel's kChunk (tests/test_torch_ssm_backward.py reads it)
        boundary = torch.empty((b, -(-s // BOUNDARY_STEPS), d, n), dtype=torch.float32,
                               device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(),
                A_log.data_ptr(), y.data_ptr(), h.data_ptr(),
                None if boundary is None else boundary.data_ptr(), _DTYPES[x.dtype],
                b, s, d, n, stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {rc}")
    selective_scan.launches += 1
    return y, h, boundary


def selective_scan_bwd(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       x: torch.Tensor, A_log: torch.Tensor, boundary: torch.Tensor,
                       dy: torch.Tensor, dh: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel: (dδ, dB, dC, dx, dA_log), fp32, from float32
    CUDA inputs, the forward's ``boundary`` store and the cotangents ``dy``
    [b,S,D] and ``dh`` [b,D,N] (None: zero)."""
    dev = _check(delta, B, C, x, A_log)
    b, s, d = delta.shape
    n = B.shape[-1]
    if op_cost.is_fake(delta):   # the dry run: the gradients' shapes, nothing launched
        return tuple(torch.empty_like(t) for t in (delta, B, C, x, A_log))
    if dev.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"selective_scan_bwd takes float32 CUDA tensors, got {x.dtype} on "
                         f"{dev}")
    want = {"boundary": ((b, -(-s // BOUNDARY_STEPS), d, n), boundary),
            "dy": ((b, s, d), dy), "dh": ((b, d, n), dh)}
    for name, (shape, t) in want.items():
        if t is None and name == "dh":
            continue
        if (t is None or tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"selective_scan_bwd: {name} must be a contiguous float32 "
                             f"{shape} on {dev}, got "
                             f"{None if t is None else (tuple(t.shape), t.dtype, t.device)}")
    fn = _build.load("ssm_scan_bwd").selective_scan_bwd_launch
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    # outputs, and the kernel's scratch: dB, dC partials per block, dA per batch row
    ddelta, dx = torch.empty_like(delta), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA_log = torch.empty_like(A_log)
    blocks = -(-d // BWD_CHANNELS)
    dB_part = torch.empty((blocks, b, s, n), dtype=torch.float32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(),
                A_log.data_ptr(), boundary.data_ptr(), dy.data_ptr(),
                None if dh is None else dh.data_ptr(), ddelta.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), dx.data_ptr(), dA_log.data_ptr(), dB_part.data_ptr(),
                dC_part.data_ptr(), dA_part.data_ptr(), b, s, d, n, stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: CUDA error {rc}")
    selective_scan.bwd_launches += 1
    return ddelta, dB, dC, dx, dA_log


selective_scan.launches = 0
selective_scan.bwd_launches = 0
