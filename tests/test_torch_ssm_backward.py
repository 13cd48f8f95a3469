"""The selective scan's backward in the port, on the CPU.

* ``backward.selective_scan_bwd_ref`` against ``jax.vjp`` of JAX's
  ``selective_scan_ref``, with and without a cotangent of h_final;
* ``SelectiveScan`` (the op under ``torch.autograd``) against the same, and
  the port's ``_mamba1_core`` prefill against ``jax.vjp`` of the JAX
  package's ``_mamba1_core`` (its XLA chunked scan) with the same weights:
  gradients of x_proj, dt_proj, dt_bias, A_log, D and the block input;
* a plain-torch model of ``csrc/selective_scan_bwd.cu`` (its lane split,
  chunks walked back from the stored boundaries in sub-chunks, decays as
  exp2 of delta·A·log2(e), the channel sums as the kernel's warp
  reduce-scatter simulated lane by lane, partials added in block and batch
  order) against the plain backward: the kernel's index arithmetic and
  its tolerance argument, since the kernel itself runs only on the card;
* the kernel's design constants read out of both sources, and the
  wrapper's checks.

Shapes have S not a multiple of the 32-step chunk, D not a multiple of
the 64-channel block and N in {4, 16} (and 1, 12 for the model).  fp32
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
MAX_N, LANES, CHANNELS, CHUNK, SUB, MIN_BLOCKS = (
    _constant(BWD, k) for k in ("kMaxN", "kLanes", "kChannels", "kChunk", "kSub", "kMinBlocks"))
SPL = MAX_N // LANES
CH_PER_WARP = 32 // LANES
WARPS = CHANNELS * LANES // 32


def test_design_constants_agree_with_the_forward_and_the_wrapper():
    fwd = CSRC / "selective_scan.cu"
    assert CHUNK == _constant(fwd, "kChunk") == BOUNDARY_STEPS
    assert LANES == _constant(fwd, "kLanes") and MAX_N == _constant(fwd, "kMaxN") == ops.MAX_STATE
    assert CHANNELS == ops.BWD_CHANNELS
    threads = CHANNELS * LANES
    smem = 4 * (CHUNK // SUB * SPL * threads + SUB * SPL * threads + 2 * CHUNK * MAX_N
                + 2 * CHUNK * WARPS * MAX_N)
    assert smem == 69632                                   # the header's 68 KB
    assert MIN_BLOCKS * (smem + 1024) <= 227 * 1024        # three blocks an SM
    assert 65536 // (MIN_BLOCKS * threads) >= 128          # registers a thread allowed


def _channel_sum(p):
    """The kernel's ``channel_sum`` on one warp, lane by lane: ``p``
    [..., 16 channels, 2 lanes, 8 states]; returns [..., 16, 2], the value
    of lane (c, g): state 8g + (c & 7) summed over the 16 channels."""
    c = torch.arange(CH_PER_WARP)
    for o in (4, 2, 1):
        upper = ((c & o) != 0)[:, None]
        new = p.clone()
        for i in range(o):
            keep = torch.where(upper, p[..., i + o], p[..., i])
            send = torch.where(upper, p[..., i], p[..., i + o])
            new[..., i] = keep + send[..., c ^ o, :]        # __shfl_xor_sync(send, 2·o)
        p = new
    s = p[..., 0]
    return s + s[..., c ^ SPL, :]                           # lanes 16 apart


def test_channel_sum_gives_every_state_its_channel_sum():
    p = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 16, 2, 8))
                         .astype(np.float32))
    got = _channel_sum(p)
    want = p.sum(1)                                          # [3, 2 lanes, 8 states]
    for c in range(16):
        for g in range(2):
            torch.testing.assert_close(got[:, c, g], want[:, g, c & 7], rtol=1e-6, atol=1e-6)


def _kernel_model(delta, B, C, x, A_log, dy, dh):
    """``selective_scan_bwd.cu``'s arithmetic, vectorized over batch rows
    and blocks: [b, blocks·64 channels, 2 lanes, 8 states]."""
    b, S, D = delta.shape
    N = B.shape[-1]
    blocks = -(-D // CHANNELS)
    dsel = torch.arange(blocks * CHANNELS).clamp(max=D - 1)
    valid = (torch.arange(blocks * CHANNELS) < D)[None, :, None, None]
    n_of = torch.arange(MAX_N).view(LANES, SPL)
    on = n_of < N
    A = torch.where(on, -torch.exp(A_log[dsel][:, n_of.clamp(max=N - 1)]), 0.0)
    A2 = A * np.float32(math.log2(math.e))
    lane = lambda t: torch.where(on, t[..., n_of.clamp(max=N - 1)], 0.0)  # noqa: E731
    Bl, Cl = lane(B), lane(C)                                          # [b, S, 2, 8]
    dt, xs, dys = (t[:, :, dsel] for t in (delta, x, dy))             # [b, S, Dp]
    G = lane(dh[:, dsel]) if dh is not None else torch.zeros(b, len(dsel), LANES, SPL)
    dA = torch.zeros_like(G)

    def step(h, t):
        du = (dt[:, t] * xs[:, t])[..., None, None]
        return torch.exp2(dt[:, t, :, None, None] * A2) * h + du * Bl[:, t, None]

    # the forward's boundary store, with the kernel's arithmetic
    bnd, h = [], torch.zeros_like(G)
    for t in range(S):
        h = step(h, t)
        if (t + 1) % CHUNK == 0 or t == S - 1:
            bnd.append(h)
    parts = torch.zeros(2, blocks, b, S, MAX_N)
    ddelta, dx = torch.zeros(b, S, D), torch.zeros(b, S, D)
    for k in reversed(range(len(bnd))):
        t0, length = k * CHUNK, min(CHUNK, S - k * CHUNK)
        h = bnd[k - 1] if k > 0 else torch.zeros_like(G)
        sb = []
        for tt in range(length):
            if tt % SUB == 0:
                sb.append(h)
            h = step(h, t0 + tt)
        for j in reversed(range(len(sb))):
            s0, s1 = j * SUB, min(j * SUB + SUB, length)
            hs, h = [], sb[j]
            for tt in range(s0, s1):
                h = step(h, t0 + tt)
                hs.append(h)
            for tt in reversed(range(s0, s1)):
                t = t0 + tt
                ht, hp = hs[tt - s0], (hs[tt - s0 - 1] if tt > s0 else sb[j])
                d_, x_, dy_ = (v[:, t, :, None, None] for v in (dt, xs, dys))
                a = torch.exp2(d_ * A2)
                g = G + dy_ * Cl[:, t, None]
                ah = a * hp
                sx = (g * Bl[:, t, None]).sum(-1).sum(-1)
                sd = (g * (A * ah + x_ * Bl[:, t, None])).sum(-1).sum(-1)
                dA = dA + g * d_ * ah
                vb = torch.where(valid, g * (d_ * x_), 0.0)
                vc = torch.where(valid, dy_ * ht, 0.0)
                dx[:, t] = (dt[:, t] * sx)[:, :D]
                ddelta[:, t] = sd[:, :D]
                G = a * g
                for q, v in enumerate((vb, vc)):
                    w = _channel_sum(v.reshape(b, blocks, WARPS, CH_PER_WARP, LANES, SPL))
                    lanes = w[:, :, :, :SPL, :]                # lanes with c & 8 == 0
                    by_n = lanes.permute(0, 1, 2, 4, 3).reshape(b, blocks, WARPS, MAX_N)
                    acc = by_n[:, :, 0]
                    for wi in range(1, WARPS):
                        acc = acc + by_n[:, :, wi]
                    parts[q, :, :, t] = acc.transpose(0, 1)
    dBC = []
    for q in range(2):
        acc = parts[q, 0]
        for blk in range(1, blocks):
            acc = acc + parts[q, blk]
        dBC.append(acc[..., :N])
    dA_sum = dA[0]
    for r in range(1, b):
        dA_sum = dA_sum + dA[r]
    dA_log = (A * dA_sum)[:D].reshape(D, MAX_N)[:, :N]
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
