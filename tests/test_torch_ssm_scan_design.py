"""The selective-scan kernel's design, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/ssm_scan/csrc/selective_scan.cu``)
runs only on the card, where ``chip_smoke.py`` phase 7 holds it against
the plain version.  Here:

(a) the kernel's launch and index arithmetic, written out with numpy from
    the design constants read out of its source, gives every
    (batch row, d, n) of h and every (batch row, t, d) of y to exactly one
    lane, over ragged D, every N in 1..16 and S = 1 and 77; each row's
    16-byte copy window fits its ring row from any start address; the
    inputs the kernel cannot take raise;
(b) a plain-torch model of the kernel's arithmetic (decays as exp2 of
    delta·(A·log2 e), each lane's partial dot over its states in order,
    the G lanes summed in the butterfly's order) agrees with the port's
    ``selective_scan_ref`` and JAX's ``selective_scan_ref`` within the
    scan's tolerances (1e-4 in fp32, 3e-2 with bf16 inputs), for G = 2, 4
    and 8: this is the tolerance argument for the redesign.  The model's
    lane sum is the kernel's reduce-scatter, simulated lane by lane.
"""

import contextlib
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import selective_scan_ref as jax_scan_ref
from repro_torch.kernels.ssm_scan import ops, selective_scan_ref

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SMEM_PER_SM = 227 * 1024        # an H100 SM's shared memory for blocks
STATIC_SMEM_LIMIT = 48 * 1024   # static shared memory a block may declare
SOURCE = (pathlib.Path(ops.__file__).parent / "csrc" / "selective_scan.cu").read_text()


def _constant(name):
    """A design constant (``constexpr int name = value;``) of the kernel's source."""
    match = re.search(rf"^constexpr int {name} = (\d+);", SOURCE, re.M)
    assert match, f"{name} not found in selective_scan.cu"
    return int(match.group(1))


MAX_N, LANES, CHANNELS, CHUNK, STAGES = (
    _constant(k) for k in ("kMaxN", "kLanes", "kChannels", "kChunk", "kStages"))
STATES_PER_LANE = MAX_N // LANES
THREADS = CHANNELS * LANES


def _ring_bytes(size):
    """The kernel's ``Ring<T>``: per stage, CHUNK rows of delta and of x (the
    block's channels of ``size`` bytes plus 16 bytes of shift) and CHUNK
    rows of B and of C as float32 [MAX_N]."""
    return STAGES * 2 * CHUNK * ((CHANNELS * size + 16) + MAX_N * 4)


def _inputs(b, S, D, N, seed=0):
    """delta, B, C, x, A_log as numpy float32, drawn as the JAX tests draw
    them (softplus(normal)·0.1 steps, A_log ~ 0.5·normal)."""
    rng = np.random.default_rng(seed)
    delta = np.logaddexp(rng.standard_normal((b, S, D)), 0.0) * 0.1
    B = rng.standard_normal((b, S, N))
    C = rng.standard_normal((b, S, N))
    x = rng.standard_normal((b, S, D))
    A_log = rng.standard_normal((D, N)) * 0.5
    return [a.astype(np.float32) for a in (delta, B, C, x, A_log)]


def _tensors(b, S, D, N, dtype="float32"):
    arrays = _inputs(b, S, D, N)
    return [torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays[:4]] + [
        torch.from_numpy(arrays[4])]


# ---------------------------------------------------------------- (a) launch arithmetic

def _lanes(grid_x, D):
    """Every (block x, thread, state slot) of one batch row, as numpy arrays:
    the lane's channel d, whether it stores, its lane-in-channel g and the
    state n of the slot, as the kernel computes them."""
    bx, tid, i = np.meshgrid(np.arange(grid_x), np.arange(THREADS),
                             np.arange(STATES_PER_LANE), indexing="ij")
    c, g = tid // LANES, tid % LANES
    d0 = bx * CHANNELS
    live = np.minimum(CHANNELS, D - d0)
    return d0 + c, c < live, g, g * STATES_PER_LANE + i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 77])
@pytest.mark.parametrize("D", [200, 8200])
def test_launch_covers_every_state_and_step_once(D, S, dtype):
    b = 2
    size = torch.empty((), dtype=DTYPES[dtype]).element_size()
    grid_x, chunks = math.ceil(D / CHANNELS), math.ceil(S / CHUNK)
    assert (grid_x - 1) * CHANNELS < D <= grid_x * CHANNELS     # no empty block
    assert THREADS <= 1024
    assert LANES * STATES_PER_LANE == MAX_N == ops.MAX_STATE
    assert CHUNK % LANES == 0                                   # whole groups
    assert _ring_bytes(size) <= STATIC_SMEM_LIMIT
    assert 4 * _ring_bytes(size) <= SMEM_PER_SM     # 4 blocks per SM, as launch_bounds asks
    for N in range(1, MAX_N + 1):
        # h: each (row, d, n) has one lane that holds and stores it
        d, stores, g, n = _lanes(grid_x, D)
        held = stores & (n < N)
        for row in range(b):
            keys = (row * D + d[held]) * N + n[held]
            assert np.array_equal(np.sort(keys), np.arange(row * D * N, (row + 1) * D * N))

        # y: each (t, d) is stored by one lane: in the chunk holding t, the
        # lane g = (t − t0) mod G of d's channel, at its group's store
        d_all, stores_all, g_all = d[..., 0], stores[..., 0], g[..., 0]
        writes = []
        for k in range(chunks):
            t0 = k * CHUNK
            length = min(CHUNK, S - t0)
            for j0 in range(0, length, LANES):
                step = t0 + j0 + g_all
                ok = stores_all & (j0 + g_all < length)
                writes.append(step[ok] * D + d_all[ok])
        writes = np.sort(np.concatenate(writes))
        assert np.array_equal(writes, np.arange(S * D)), (D, S, N)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 77, 200, 201, 203, 8200])
def test_copy_windows_fit_their_ring_rows(D, dtype):
    """A row's data starts `shift` = its address mod 16 into its ring row;
    shift plus the block's channels fit the row's 16-byte copies, for a
    tensor that starts at any element-aligned address."""
    size = torch.empty((), dtype=DTYPES[dtype]).element_size()
    row_bytes = CHANNELS * size + 16
    b, S = 3, 77
    t = np.arange(b * S)[:, None]
    d0 = np.arange(0, D, CHANNELS)[None, :]
    live = np.minimum(CHANNELS, D - d0)
    for base in range(0, 16, size):
        addr = base + (t * D + d0) * size
        shift = addr % 16
        assert np.all(shift % size == 0)                 # elements stay aligned
        copies = -(-(shift + live * size) // 16)
        assert np.all(copies * 16 <= row_bytes)
        # the window starts on the boundary at or below the row's data, never
        # below the one at or below the tensor's start (inside its storage,
        # which starts on a boundary), and the last copy is cut at the data's
        # end: no byte past the tensor is read
        assert np.all(addr - shift >= base - base % 16)
        assert np.all(addr + live * size <= base + b * S * D * size)


def test_kernel_layout_check_raises_for_what_the_kernel_cannot_take():
    delta, B, C, x, A_log = _tensors(2, 16, 24, 4)
    ops._check_kernel_layout((delta, B, C, x, A_log))
    with pytest.raises(ValueError, match="x must be contiguous"):
        ops._check_kernel_layout(
            (delta, B, C, x.transpose(1, 2).contiguous().transpose(1, 2), A_log))
    with pytest.raises(ValueError, match="B must be contiguous"):
        ops._check_kernel_layout(
            (delta, B.transpose(1, 2).contiguous().transpose(1, 2), C, x, A_log))
    with pytest.raises(ValueError, match="A_log must be contiguous"):
        ops._check_kernel_layout((delta, B, C, x, A_log.t().contiguous().t()))
    # a contiguous view one float past a 16-byte boundary is taken
    base = torch.zeros(delta.numel() + 4)
    off = next(k for k in range(1, 4) if (base.data_ptr() + 4 * k) % 16)
    shifted = base[off:off + delta.numel()].view(delta.shape)
    ops._check_kernel_layout((shifted, B, C, shifted, A_log))
    wide = [torch.zeros(65536, 1, 1) for _ in range(4)]
    with pytest.raises(ValueError, match="grid too large"):
        ops._check_kernel_layout((*wide, torch.zeros(1, 1)))
    # N outside 1..16 is refused on every device
    with pytest.raises(ValueError, match="N <= 16"):
        wide_n = torch.zeros(2, 16, ops.MAX_STATE + 1)
        ops.selective_scan(delta, wide_n, wide_n, x, torch.zeros(24, ops.MAX_STATE + 1))


# ------------------------------------------------------- (b) the kernel's arithmetic

LOG2E = 1.4426950408889634


def _reduce_scatter(p):
    """The kernel's lane sum, simulated: p[lane, j] is lane ``lane``'s
    partial dot for step j of a group (float32 numpy, G lanes × G steps).
    Each round at distance o = G/2, …, 1 keeps half the steps; returns what
    each lane holds at the end (lane g: y of step g)."""
    lanes = p.shape[0]
    vals = [list(p[g]) for g in range(lanes)]
    o = lanes // 2
    while o >= 1:
        sent = [[(v[i] if g & o else v[i + o]) for i in range(o)]
                for g, v in enumerate(vals)]
        vals = [[np.float32((v[i + o] if g & o else v[i]) + sent[g ^ o][i])
                 for i in range(o)] for g, v in enumerate(vals)]
        o //= 2
    return np.array([v[0] for v in vals], np.float32)


def _butterfly(p):
    """The order the model sums lanes in: lanes G/2 apart first."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_reduce_scatter_is_the_butterfly_sum(lanes):
    rng = np.random.default_rng(lanes)
    for _ in range(20):
        p = rng.standard_normal((lanes, lanes)).astype(np.float32)   # [lane, step]
        got = _reduce_scatter(p)
        want = _butterfly(torch.from_numpy(p.T.copy())).numpy()        # per step
        np.testing.assert_array_equal(got, want)


def _model_scan(delta, B, C, x, A_log, lanes):
    """The kernel's arithmetic in plain torch: states padded to 16 with
    zero rates, B and C; decays exp2(delta·A′) with A′ = −exp(A_log)·log2 e;
    each lane's partial dot over its 16/G states in order; the lanes summed
    in the butterfly's order; y rounded once to x's dtype."""
    b, S, D = x.shape
    N = B.shape[-1]
    k = MAX_N // lanes
    pad = (0, MAX_N - N)
    A2 = torch.nn.functional.pad(-torch.exp(A_log.float()) * LOG2E, pad)
    Bp = torch.nn.functional.pad(B.float(), pad)
    Cp = torch.nn.functional.pad(C.float(), pad)
    d32, x32 = delta.float(), x.float()
    h = torch.zeros(b, D, MAX_N)
    ys = []
    for t in range(S):
        a = torch.exp2(d32[:, t, :, None] * A2[None])
        h = a * h + (d32[:, t] * x32[:, t])[..., None] * Bp[:, t, None, :]
        prod = (h * Cp[:, t, None, :]).view(b, D, lanes, k)
        part = prod[..., 0]
        for i in range(1, k):
            part = part + prod[..., i]
        ys.append(_butterfly(part))
    return torch.stack(ys, dim=1).to(x.dtype), h[..., :N]


MODEL_CASES = [
    # b, S, D, N, dtype
    (2, 77, 200, 16, "float32"),
    (1, 45, 201, 12, "float32"),
    (2, 50, 64, 1, "float32"),
    (3, 1, 130, 16, "float32"),
    (1, 64, 128, 8, "bfloat16"),
]


@contextlib.contextmanager
def _one_intra_op_thread():
    """Run torch's CPU ops on the calling thread alone.  torch.exp on the
    CPU calls MKL's vsExp, and on an OpenMP worker thread's first call in
    a process MKL has now and then run its AVX2 enhanced-performance
    (about 11-bit) kernel: exp(A_log) off by up to 1.5e-4 relative on the
    worker's half of the rows, and the model's y by up to 2.3e-4 against
    the reference.  On one thread the call stays on the calling thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_model_of_kernel_arithmetic_matches_refs(case, lanes):
    b, S, D, N, dtype = case
    t = _tensors(b, S, D, N, dtype)
    with _one_intra_op_thread():
        y, h = _model_scan(*t, lanes=lanes)
        yr, hr = selective_scan_ref(*t)
    assert y.dtype == DTYPES[dtype] and h.shape == (b, D, N)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), yr.float().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=tol, atol=tol)
    j = [jnp.asarray(a.float().numpy()).astype(dtype) for a in t[:4]] + [
        jnp.asarray(t[4].numpy())]
    yj, hj = jax_scan_ref(*j)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yj, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj, np.float32), rtol=tol, atol=tol)
