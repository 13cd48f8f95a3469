"""The selective scan's backward in the port, on the CPU.

* ``backward.selective_scan_bwd_ref`` against ``jax.vjp`` of JAX's
  ``selective_scan_ref``, with and without a cotangent of h_final;
* ``SelectiveScan`` (the op under ``torch.autograd``) against the same, and
  the port's ``_mamba1_core`` prefill against ``jax.vjp`` of the JAX
  package's ``_mamba1_core`` (its XLA chunked scan) with the same weights:
  gradients of x_proj, dt_proj, dt_bias, A_log, D and the block input;
* a plain-torch model of ``csrc/selective_scan_bwd.cu`` (8 states of 2
  channels a thread, chunks walked forward to their last 4-step
  sub-chunk and each sub-chunk recomputed with its decays kept, decays as
  exp2 of delta·A·log2(e), the ragged chunk and sub-chunk ends, dx and dδ
  reduce-scattered over a lane pair, dB and dC summed over a thread's two
  channels and then by the warp's reduce-scatter simulated lane by lane,
  warps, blocks and batch rows added in order) against the plain
  backward: the kernel's index arithmetic and its tolerance argument,
  since the kernel itself runs only on the card;
* the ring's unit order (every step walked back once, in reverse);
* the kernel's design constants read out of both sources, its shared
  memory and the launch arithmetic of the serving shape (one wave on 132
  SMs, 255 registers a thread, 1.875 exponentials a state element), and
  the wrapper's checks.

Shapes have S not a multiple of the 32-step chunk, D not a multiple of
the 128-channel block and N in {4, 16} (and 1, 12 for the model).  fp32
throughout: every gradient within 1e-5 of its largest magnitude.  A
repeated backward is bit-equal.
"""

import dataclasses
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssm_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import (SelectiveScan, ops, selective_scan,
                                          selective_scan_bwd, selective_scan_bwd_ref)
from repro_torch.kernels.ssm_scan.backward import BOUNDARY_STEPS, scan_boundaries
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = 1e-5
NAMES = ("delta", "B", "C", "x", "A_log")
SHAPES = [(2, 77, 70, 16), (1, 40, 33, 4), (2, 64, 128, 16), (1, 1, 5, 16)]
CSRC = pathlib.Path(ops.__file__).parent / "csrc"


def _inputs(b, S, D, N, seed=0):
    """delta, B, C, x, A_log and cotangents dy, dh as numpy float32."""
    rng = np.random.default_rng(seed)
    arrays = (np.logaddexp(rng.standard_normal((b, S, D)), 0.0) * 0.1,
              rng.standard_normal((b, S, N)), rng.standard_normal((b, S, N)),
              rng.standard_normal((b, S, D)), rng.standard_normal((D, N)) * 0.5,
              rng.standard_normal((b, S, D)), rng.standard_normal((b, D, N)))
    return [a.astype(np.float32) for a in arrays]


def _jax_grads(arrays, with_dh):
    (_, h), vjp = jax.vjp(jax_scan_ref, *(jnp.asarray(a) for a in arrays[:5]))
    dh = jnp.asarray(arrays[6]) if with_dh else jnp.zeros_like(h)
    return [np.asarray(g) for g in vjp((jnp.asarray(arrays[5]), dh))]


def _hold(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= TOL * scale, f"{what} d{name}: max|Δ| {err} > {TOL} x {scale}"


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, with_dh):
    arrays = _inputs(*shape)
    t = [torch.from_numpy(a) for a in arrays]
    got = selective_scan_bwd_ref(*t[:6], t[6] if with_dh else None)
    _hold(got, _jax_grads(arrays, with_dh), f"{shape}")


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_backward_from_given_boundaries(shape):
    """The boundaries the CUDA forward stores (h at each chunk's end) give
    the same gradients as the re-scan."""
    t = [torch.from_numpy(a) for a in _inputs(*shape)]
    bnd = scan_boundaries(t[0], t[1], t[3], t[4])
    b, S, D, N = shape
    assert bnd.shape == (b, math.ceil(S / BOUNDARY_STEPS), D, N)
    _, h = ops.selective_scan_ref(*t[:5])
    torch.testing.assert_close(bnd[:, -1], h, rtol=0, atol=0)
    for a, c in zip(selective_scan_bwd_ref(*t[:7], boundary=bnd), selective_scan_bwd_ref(*t[:7])):
        assert torch.equal(a, c)


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_function_matches_jax_vjp_and_repeats_bit_equal(shape, with_dh):
    arrays = _inputs(*shape)
    dy, dh = torch.from_numpy(arrays[5]), torch.from_numpy(arrays[6])
    runs = []
    for _ in range(2):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
        y, h = selective_scan(*ins)
        assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SelectiveScanBackward"
        loss = (y * dy).sum() + ((h * dh).sum() if with_dh else 0.0)
        loss.backward()
        runs.append([t.grad for t in ins])
    _hold(runs[0], _jax_grads(arrays, with_dh), f"{shape}")
    assert all(torch.equal(a, c) for a, c in zip(*runs))


def test_function_handles_an_unused_output_and_partial_grads():
    arrays = _inputs(1, 20, 9, 4)
    ins = [torch.from_numpy(a) for a in arrays[:5]]
    x = ins[3].clone().requires_grad_()
    _, h = selective_scan(ins[0], ins[1], ins[2], x, ins[4])   # y unused
    h.sum().backward()
    (_, jh), vjp = jax.vjp(jax_scan_ref, *(jnp.asarray(a) for a in arrays[:5]))
    want = vjp((jnp.zeros((1, 20, 9)), jnp.ones_like(jh)))[3]
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * np.abs(np.asarray(want)).max())
    with torch.no_grad():
        y, _ = selective_scan(*[t.requires_grad_() for t in ins])
    assert y.grad_fn is None


# ------------------------------------------------------ the Mamba-1 block's scan


@pytest.mark.parametrize("d_model,d_state,seq", [(64, 4, 32), (48, 16, 48)])
def test_mamba1_core_grads_match_jax(d_model, d_state, seq):
    """``_mamba1_core`` prefill in both packages, the same weights and block
    input; the vjp of y for a seeded cotangent, with respect to the
    block's scan weights and its input.  d_inner 128 / 96 (not a multiple
    of 64 at 96), chunk 16."""
    over = dict(d_model=d_model)
    jcfg = dataclasses.replace(jax_config("falcon-mamba-7b", True), dtype="float32", **over,
                               ssm=dataclasses.replace(jax_config("falcon-mamba-7b", True).ssm,
                                                       d_state=d_state))
    tcfg = dataclasses.replace(get_config("falcon-mamba-7b", True), dtype="float32", **over,
                               ssm=dataclasses.replace(get_config("falcon-mamba-7b", True).ssm,
                                                       d_state=d_state))
    jp = jcommon.init_params(jax.random.PRNGKey(1), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    keys = ("x_proj", "dt_proj", "dt_bias", "A_log", "D")
    jl = jax.tree.map(lambda t: t[0], jp["slots"][0]["mamba"])
    tl = {k: v[0] for k, v in tp["slots"][0]["mamba"].items()}
    rng = np.random.default_rng(2)
    di = tcfg.ssm.d_inner(d_model)
    xc = (rng.standard_normal((2, seq, di)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((2, seq, di)).astype(np.float32)

    def jfun(w, x):
        return jssm._mamba1_core(dict(jl, **w), x, jcfg, None, False)[0]
    _, vjp = jax.vjp(jfun, {k: jl[k] for k in keys}, jnp.asarray(xc))
    jw, jx = vjp(jnp.asarray(ct))

    leaves = {k: tl[k].clone().requires_grad_() for k in keys}
    tx = torch.from_numpy(xc).requires_grad_()
    y, _ = tssm._mamba1_core(dict(tl, **leaves), tx, tcfg, None, False)
    (y * torch.from_numpy(ct)).sum().backward()
    for name, got, want in [*((k, leaves[k].grad, jw[k]) for k in keys), ("xc", tx.grad, jx)]:
        want = np.asarray(want)
        scale = np.abs(want).max()
        err = np.abs(got.numpy() - want).max()
        assert err <= TOL * scale, f"d{name}: max|Δ| {err} > {TOL} x {scale}"


# ---------------------------------------------------- a model of the CUDA kernel


def _constant(path, name):
    match = re.search(rf"^constexpr int {name} = (\d+);", path.read_text(), re.M)
    assert match, f"{name} not found in {path.name}"
    return int(match.group(1))


BWD = CSRC / "selective_scan_bwd.cu"
MAX_N, LANES, PAIR, CHANNELS, MIN_BLOCKS, CHUNK, SUB, STAGES = (
    _constant(BWD, k) for k in ("kMaxN", "kLanes", "kPair", "kChannels", "kMinBlocks",
                                "kChunk", "kSub", "kStages"))
SPL = MAX_N // LANES                      # states a lane keeps
THREADS = CHANNELS * LANES // PAIR
HALF = CHANNELS // PAIR                   # channel c's partner is c + HALF
PAIRS_PER_WARP = 32 // LANES
WARPS = THREADS // 32
SUBS = CHUNK // SUB


def _smem_bytes():
    """``sizeof(Smem)``: the ring (δ, x, dy rows of CHANNELS floats plus 16 bytes of
    shift, B and C [SUB][16] a stage), the sub-chunk starts, the recomputed states and
    the warps' dB, dC sums, as the kernel lays them out."""
    ring = STAGES * (3 * SUB * (4 * CHANNELS + 16) + 2 * SUB * MAX_N * 4)
    states = 16 * (PAIR * SPL // 4) * THREADS        # one float4 array a step
    return ring + (SUBS - 1) * states + (SUB - 1) * states + 2 * SUB * WARPS * 2 * MAX_N * 4


def test_design_constants_agree_with_the_forward_and_the_wrapper():
    fwd = CSRC / "selective_scan.cu"
    assert CHUNK == _constant(fwd, "kChunk") == BOUNDARY_STEPS
    assert LANES == _constant(fwd, "kLanes") and MAX_N == _constant(fwd, "kMaxN") == ops.MAX_STATE
    assert CHANNELS == ops.BWD_CHANNELS
    assert _smem_bytes() == 106560                         # the header's figure
    assert PAIRS_PER_WARP == 2 * SPL                       # one of 16 values a lane


def test_launch_arithmetic_of_the_serving_shape():
    """b = 4, D = 8192: every block resident at once (one wave on 132 SMs), the
    shared memory of MIN_BLOCKS blocks within an SM's 228 KB, 255 registers a
    thread, and at most two exponentials a state element (1.875)."""
    b, S, D = 4, 2048, 8192
    blocks = -(-D // CHANNELS) * b
    assert blocks <= 132 * MIN_BLOCKS and -(-blocks // (132 * MIN_BLOCKS)) == 1
    assert MIN_BLOCKS * (_smem_bytes() + 1024) <= 233472
    assert _smem_bytes() <= 227 * 1024
    assert min(255, 65536 // (MIN_BLOCKS * THREADS)) == 255
    full = S // CHUNK
    exps = full * ((SUBS - 1) * SUB + CHUNK)               # the first walk and the recompute
    assert exps / S == 1.875 <= 2


def _butterfly(pv):
    """The kernel's dB, dC reduce-scatter on one warp, lane by lane: ``pv``
    [..., 16 lane pairs, 2 lanes, 16 values]; returns [..., 16, 2], the value
    of lane (p, g): value p summed over the 16 pairs."""
    pl = torch.arange(PAIRS_PER_WARP)
    for o in (8, 4, 2, 1):
        upper = ((pl & o) != 0)[:, None]
        new = pv.clone()
        for i in range(o):
            keep = torch.where(upper, pv[..., i + o], pv[..., i])
            send = torch.where(upper, pv[..., i], pv[..., i + o])
            new[..., i] = keep + send[..., pl ^ o, :]           # the pair 2·o lanes apart
        pv = new
    return pv[..., 0]


def _pair_scatter(sums):
    """The dx, dδ reduce-scatter over a lane pair: ``sums`` [..., 2 lanes, 4]
    (Σ g·B and Σ g·A′·a·h of channel c, then of c + HALF); returns
    [..., 2 lanes, 2], lane g's sums of its channel g over both lanes."""
    upper = torch.tensor([False, True])[:, None]
    keep = torch.where(upper, sums[..., 2:], sums[..., :2])
    send = torch.where(upper, sums[..., :2], sums[..., 2:])
    return keep + send.flip(-2)                              # the lane 1 apart


def test_channel_sum_gives_every_state_its_channel_sum():
    """dB, dC: lane (p, g) ends with state 8g + (p & 7) of dB (p < 8) or dC,
    summed over the warp's 16 lane pairs."""
    p = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 16, 2, 16))
                         .astype(np.float32))
    got = _butterfly(p)
    want = p.sum(1)                                          # [3, 2 lanes, 16 values]
    for pl in range(16):
        for g in range(2):
            torch.testing.assert_close(got[:, pl, g], want[:, g, pl], rtol=1e-6, atol=1e-6)


def test_pair_scatter_gives_each_lane_its_channel():
    s = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 2, 4)).astype(np.float32))
    got = _pair_scatter(s)
    total = s.sum(-2)                                        # [5, 4]
    for g in range(2):
        torch.testing.assert_close(got[:, g], total[:, 2 * g:2 * g + 2], rtol=1e-6, atol=1e-6)


def _unit_at(u, chunks, last_subs):
    """The kernel's ``unit_at``: (chunk, sub-chunk, walked back) of unit u."""
    first = 2 * last_subs - 1
    if u < first:
        return ((chunks - 1, u, False) if u < last_subs - 1
                else (chunks - 1, 2 * last_subs - 2 - u, True))
    per = 2 * SUBS - 1
    v = u - first
    k, r = chunks - 2 - v // per, v % per
    return (k, r, False) if r < SUBS - 1 else (k, 2 * SUBS - 2 - r, True)


@pytest.mark.parametrize("S", [1, 3, 4, 5, 32, 33, 77, 2048])
def test_unit_order_walks_every_step_back_once(S):
    """The ring's units, in the kernel's order: each chunk, last first, walks
    forward through full units to its last sub-chunk, then back through every
    sub-chunk, last first; every step is walked back once, in reverse."""
    chunks = -(-S // CHUNK)
    last_subs = -(-(S - (chunks - 1) * CHUNK) // SUB)
    units = 2 * last_subs - 1 + (chunks - 1) * (2 * SUBS - 1)
    seq = [_unit_at(u, chunks, last_subs) for u in range(units)]
    back = []
    for k in reversed(range(chunks)):
        subs = -(-(min(CHUNK, S - k * CHUNK)) // SUB)
        mine = [un for un in seq if un[0] == k]
        assert mine == ([(k, j, False) for j in range(subs - 1)]
                        + [(k, j, True) for j in reversed(range(subs))])
        for _, j, _ in mine[:subs - 1]:
            assert k * CHUNK + (j + 1) * SUB <= S                 # forward units are full
        back += [t for _, j, _ in mine[subs - 1:]
                 for t in reversed(range(k * CHUNK + j * SUB, min(S, k * CHUNK + (j + 1) * SUB)))]
    assert [un[0] for un in seq] == sorted((un[0] for un in seq), reverse=True)
    assert back == list(reversed(range(S)))


def _kernel_model(delta, B, C, x, A_log, dy, dh):
    """``selective_scan_bwd.cu``'s arithmetic, vectorized over batch rows and
    blocks: [b, blocks, PAIR channels, HALF lane pairs, 2 lanes, 8 states];
    channel j·HALF + p of a block is kept by lane pair p."""
    b, S, D = delta.shape
    N = B.shape[-1]
    blocks = -(-D // CHANNELS)
    cidx = (torch.arange(blocks)[:, None, None] * CHANNELS
            + torch.arange(PAIR)[None, :, None] * HALF + torch.arange(HALF)[None, None, :])
    dsel = cidx.clamp(max=D - 1)                       # past D: channel D − 1, nothing stored
    valid = cidx < D                                   # [blocks, PAIR, HALF]
    n_of = torch.arange(MAX_N).view(LANES, SPL)
    on = n_of < N
    A = torch.where(on, -torch.exp(A_log[dsel][..., n_of.clamp(max=N - 1)]), 0.0)
    A2 = A * np.float32(math.log2(math.e))
    lane = lambda t: torch.where(on, t[..., n_of.clamp(max=N - 1)], 0.0)  # noqa: E731
    Bl, Cl = lane(B)[:, :, None, None, None], lane(C)[:, :, None, None, None]
    dt, xs, dys = (t[:, :, dsel] for t in (delta, x, dy))         # [b, S, blocks, PAIR, HALF]
    ex = lambda v: v[..., None, None]                             # noqa: E731
    G = (lane(dh[:, dsel]) if dh is not None
         else torch.zeros(b, blocks, PAIR, HALF, LANES, SPL))
    dA = torch.zeros_like(G)
    vmask = valid[..., None, None]

    def step(h, t):
        a = torch.exp2(ex(dt[:, t]) * A2)
        return a, a * h + ex(dt[:, t] * xs[:, t]) * Bl[:, t]

    bnd, h = [], torch.zeros_like(G)                  # the forward's boundary store
    for t in range(S):
        h = step(h, t)[1]
        if (t + 1) % CHUNK == 0 or t == S - 1:
            bnd.append(h)
    parts = torch.zeros(2, blocks, b, S, MAX_N)
    ddelta, dx = torch.zeros(b, S, D), torch.zeros(b, S, D)
    ln2 = np.float32(math.log(2.0))
    for k in reversed(range(len(bnd))):
        t0, length = k * CHUNK, min(CHUNK, S - k * CHUNK)
        subs = -(-length // SUB)
        h = bnd[k - 1] if k > 0 else torch.zeros_like(G)
        starts = [h]                                   # the state before each sub-chunk
        for j in range(subs - 1):
            for s in range(SUB):
                h = step(h, t0 + j * SUB + s)[1]
            starts.append(h)
        for j in reversed(range(subs)):
            r = min(SUB, length - j * SUB)
            h, avs, hs = starts[j], [], []
            for s in range(r):
                a, h = step(h, t0 + j * SUB + s)
                avs.append(a)
                hs.append(h)
            for s in reversed(range(r)):
                t = t0 + j * SUB + s
                ht, hp = hs[s], (hs[s - 1] if s > 0 else starts[j])
                d_, x_, dy_ = (ex(v[:, t]) for v in (dt, xs, dys))
                gi = G + dy_ * Cl[:, t]
                sx, s1 = torch.zeros(gi.shape[:-1]), torch.zeros(gi.shape[:-1])
                w = gi * (avs[s] * hp)
                for i in range(SPL):                   # a lane's states in order
                    sx = sx + gi[..., i] * Bl[:, t, ..., i]
                    s1 = s1 + w[..., i] * A2[..., i]
                dA = dA + w * d_
                vb = torch.where(vmask, gi * (d_ * x_), 0.0)
                vc = torch.where(vmask, dy_ * ht, 0.0)
                G = avs[s] * gi
                # dx, dδ: the lane pair's sums, lane g keeping channel g
                sums = torch.stack([sx[:, :, 0], s1[:, :, 0], sx[:, :, 1], s1[:, :, 1]], -1)
                per = _pair_scatter(sums)                  # [b, blocks, HALF, 2 g, 2]
                sxc, s1c = per[..., 0].permute(0, 1, 3, 2), per[..., 1].permute(0, 1, 3, 2)
                flat = lambda v: v.reshape(b, blocks * CHANNELS)[:, :D]  # noqa: E731
                dx[:, t] = flat(dt[:, t] * sxc)
                ddelta[:, t] = flat(xs[:, t] * sxc + ln2 * s1c)
                # dB, dC: pair sums in registers, the warp's butterfly, warps in order
                pv = torch.cat([vb[:, :, 0] + vb[:, :, 1], vc[:, :, 0] + vc[:, :, 1]], -1)
                lanes = _butterfly(pv.reshape(b, blocks, WARPS, PAIRS_PER_WARP, LANES, 2 * SPL))
                pl = torch.arange(PAIRS_PER_WARP)
                red = torch.zeros(b, blocks, WARPS, 2, MAX_N)
                for g in range(LANES):
                    red[:, :, :, pl // SPL, g * SPL + pl % SPL] = lanes[..., g]
                acc = red[:, :, 0]
                for wi in range(1, WARPS):
                    acc = acc + red[:, :, wi]
                parts[:, :, :, t] = acc.permute(2, 1, 0, 3)
    dBC = []
    for q in range(2):
        acc = parts[q, 0]
        for blk in range(1, blocks):
            acc = acc + parts[q, blk]
        dBC.append(acc[..., :N])
    dA_sum = dA[0]
    for r in range(1, b):
        dA_sum = dA_sum + dA[r]
    dA_log = (A * dA_sum).reshape(blocks * CHANNELS, MAX_N)[:D, :N]
    return ddelta, dBC[0], dBC[1], dx, dA_log


@pytest.mark.parametrize("shape", [(2, 77, 70, 16), (1, 40, 33, 4), (2, 45, 130, 12),
                                   (1, 9, 64, 1)])
def test_kernel_model_matches_the_plain_backward(shape):
    t = [torch.from_numpy(a) for a in _inputs(*shape, seed=3)]
    got = _kernel_model(*t)
    want = selective_scan_bwd_ref(*t)
    for name, g, w in zip(NAMES, got, want):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= TOL * scale, f"{shape} d{name}: max|Δ| {err} > {TOL} x {scale}"


def test_backward_wrapper_refuses_cpu_tensors_and_counts_nothing():
    t = [torch.from_numpy(a) for a in _inputs(1, 8, 4, 4)]
    with pytest.raises(ValueError, match="float32 CUDA"):
        selective_scan_bwd(*t[:5], torch.zeros(1, 1, 4, 4), t[5], t[6])
    before = (selective_scan.launches, selective_scan.bwd_launches)
    ins = [a.clone().requires_grad_() for a in t[:5]]
    sum(o.sum() for o in SelectiveScan.apply(*ins)).backward()
    assert (selective_scan.launches, selective_scan.bwd_launches) == before
