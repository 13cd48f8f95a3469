"""The attention backward's kernels on the CPU: their two-pass schedule as a
plain-torch model, their bands, their design constants and the wrapper's
host logic.

The kernels (``csrc/flash_attention_bwd_wgmma.cu`` for bf16,
``csrc/flash_attention_bwd.cu`` for float32) run only on the card.  What a
CPU can check is their arithmetic, modelled here from the constants of their
sources: a prologue (Δ = rowsum(dO·O) and the row's log-sum-exp), a dK/dV
pass with one block per (batch, KV head, key tile) that walks the G query
heads and the query tiles of the key tile's band in a fixed order and sums
dK and dV in the block, and a dQ pass that walks the forward's band of key
tiles per query tile; P and dS are rounded to the operand dtype before their
products, masks are aligned at 0 and ragged rows and keys are masked in P
and dS.  The model is held against ``backward.flash_attention_bwd`` (2e-5 in
float32; in bf16 2e-2 relative and 2e-2 of the tensor's largest magnitude,
the tolerances of ``tests/test_torch_flash_backward.py``) and against
``jax.vjp`` of the JAX package's ``full_attention`` on numpy-seeded inputs.
The band tests show that each (query, key) pair the plain version keeps is
visited exactly once in each pass, at tile edges and ragged ends.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import full_attention
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_kernel, ops)
from repro_torch.kernels.flash_attention.backward import kv_extent

torch.set_num_threads(1)

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels"
        / "flash_attention" / "csrc")
TC_SOURCE = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
CC_SOURCE = (CSRC / "flash_attention_bwd.cu").read_text()
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOG2E = 1.4426950408889634
NEG_INF = -2.0e38


def _const(source: str, name: str) -> int:
    """A design constant (``constexpr int name = value;``) of a kernel's source."""
    match = re.search(rf"^constexpr int {name} = (\d+);", source, re.M)
    assert match, name
    return int(match.group(1))


class Tiles:
    """The tile sizes of one route at head_dim ``d``, from its source:
    ``keys`` / ``bq`` of the dK/dV pass (keys a block, query rows a walked
    tile), ``rows`` / ``bk`` of the dQ pass (query rows a block, keys a
    walked tile) and ``wg_rows``, the rows of one independent band inside a
    dQ block (a consumer warpgroup's)."""

    def __init__(self, dtype: str, d: int):
        if dtype == "bfloat16":
            s = TC_SOURCE
            self.keys, self.bq = _const(s, "kKeys"), _const(s, "kQueryTile")
            self.wg_rows = _const(s, "kRowsPerWarpgroup")
            self.rows = self.wg_rows * (2 if d >= 128 else 3)
            self.bk = _const(s, "kKeyTile256") if d == 256 else _const(s, "kKeyTile")
        else:
            s = CC_SOURCE
            other = _const(s, "kOther256") if d > 128 else _const(s, "kOther")
            self.keys = self.rows = self.wg_rows = _const(s, "kOwn")
            self.bq = self.bk = other


def key_band(k0, keys, sq, causal, window, bq):
    """The query tiles the dK/dV block of keys [k0, k0 + keys) walks: from the
    tile holding k0 (causal) to the one holding k0 + keys − 1 + window − 1
    (window), clipped to Sq (the kernels' q_lo, q_end, t_lo, t_hi)."""
    q_lo = k0 if causal else 0
    q_end = min(sq, k0 + keys - 1 + window) if window is not None else sq
    t_lo = q_lo // bq
    t_hi = (q_end - 1) // bq + 1 if q_lo < q_end else t_lo
    return range(t_lo, t_hi)


def query_band(q0, rows, qa, sq, sk, causal, window, bk):
    """The key tiles that the dQ rows [qa, qa + 64) of the block [q0, q0 +
    rows) compute: the forward's band of the block, [lo, hi), cut to the
    warpgroup's own (the tensor-core kernel's lo_w, hi_w; the CUDA-core
    kernel has one 64-row band a block, qa = q0)."""
    nk = -(-sk // bk)
    hi = min((min(q0 + rows, sq) - 1) // bk + 1, nk) if causal else nk
    lo = max(q0 - window + 1, 0) // bk if window is not None else 0
    lo_w = max(lo, max(qa - window + 1, 0) // bk if window is not None else 0)
    if qa >= sq:
        return range(lo_w, lo_w)
    hi_w = min(hi, (min(qa + 64, sq) - 1) // bk + 1 if causal else nk)
    return range(lo_w, hi_w)


def _keep(qpos, kpos, sq, sk, causal, window):
    keep = (qpos < sq) & (kpos < sk)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= (qpos - kpos) < window
    return keep


def two_pass(q, k, v, out, m, l, dout, *, causal, window, softcap, scale):
    """The backward kernel of q's dtype, modelled in plain torch: (dq, dk, dv)
    in the inputs' dtypes.  bf16: base-2 exponentials against lse·log2(e),
    P and dS rounded to bf16 before their products; float32: P as
    exp(s − m) / max(l, 1e-30), the scale applied to the sums of dQ and
    dK."""
    dt = q.dtype
    bf16 = dt == torch.bfloat16
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    t = Tiles("bfloat16" if bf16 else "float32", d)
    rnd = (lambda x: x.to(dt).float()) if bf16 else (lambda x: x)
    qf, kf, vf = q.float(), k.float(), v.float()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)            # [B,H,Sq]
    if bf16:
        lse = m * LOG2E + torch.log2(torch.clamp(l, min=1e-30))
        lse = torch.where(m <= NEG_INF, torch.full_like(lse, math.inf), lse)[..., None]
    else:   # the float32 kernels divide by l, as the plain version does
        lse = torch.stack((m, torch.clamp(l, min=1e-30)), -1)              # [B,H,Sq,2]

    def scores(qt, kt, qpos, kpos, lse_r, delta_r, dp):
        """P and dS of a tile: qt [rows, D], kt [cols, D]; lse_r (the base-2
        log-sum-exp, or float32's (m, max(l, 1e-30))) and delta_r per row."""
        raw = (qt @ kt.T) * scale
        dfac = torch.ones_like(raw)
        if softcap is not None:
            th = torch.tanh(raw / softcap)
            raw, dfac = softcap * th, 1.0 - th * th
        if bf16:
            p = torch.exp2(raw * LOG2E - lse_r[:, :1])
        else:
            p = torch.exp(raw - lse_r[:, :1]) / lse_r[:, 1:]
        keep = _keep(qpos[:, None], kpos[None, :], sq, sk, causal, window)
        p = torch.where(keep, p, 0.0)
        ds = p * (dp - delta_r[:, None]) * dfac * (scale if bf16 else 1.0)
        return p, ds

    def rows_of(x, start, n, limit, fill=0.0):
        """Rows [start, start + n) of a [S, D] slice, ``fill`` past ``limit`` (TMA's
        zeros)."""
        out = torch.full((n, x.shape[-1]), fill, dtype=torch.float32)
        stop = min(start + n, limit)
        if stop > start:
            out[:stop - start] = x[start:stop]
        return out

    dq = torch.zeros((b, sq, h, d))
    dk = torch.zeros((b, sk, kvh, d))
    dv = torch.zeros((b, sk, kvh, d))
    # pass 1: dK, dV of each key tile, summed in the block over the G heads and the band
    for bi in range(b):
        for kh in range(kvh):
            for k0 in range(0, sk, t.keys):
                kt, vt = rows_of(kf[bi, :, kh], k0, t.keys, sk), rows_of(vf[bi, :, kh], k0,
                                                                           t.keys, sk)
                kpos = torch.arange(k0, k0 + t.keys)
                acc_k, acc_v = torch.zeros(t.keys, d), torch.zeros(t.keys, d)
                for gi in range(g):
                    hi = kh * g + gi
                    for qt_i in key_band(k0, t.keys, sq, causal, window, t.bq):
                        q0 = qt_i * t.bq
                        qpos = torch.arange(q0, q0 + t.bq)
                        qt = rows_of(qf[bi, :, hi], q0, t.bq, sq)
                        ot = rows_of(dout[bi, :, hi].float(), q0, t.bq, sq)
                        lse_r = rows_of(lse[bi, hi], q0, t.bq, sq, fill=1.0)
                        dl_r = rows_of(delta[bi, hi][:, None], q0, t.bq, sq)[:, 0]
                        p, ds = scores(qt, kt, qpos, kpos, lse_r, dl_r, ot @ vt.T)
                        acc_v += rnd(p).T @ ot
                        acc_k += rnd(ds).T @ qt
                n = min(t.keys, sk - k0)
                dk[bi, k0:k0 + n, kh] = acc_k[:n] * (1.0 if bf16 else scale)
                dv[bi, k0:k0 + n, kh] = acc_v[:n]
    # pass 2: dQ of each query tile over the forward's band of key tiles
    for bi in range(b):
        for hi in range(h):
            kh = hi // g
            for q0 in range(0, sq, t.rows):
                for qa in range(q0, q0 + t.rows, t.wg_rows):
                    qt = rows_of(qf[bi, :, hi], qa, t.wg_rows, sq)
                    ot = rows_of(dout[bi, :, hi].float(), qa, t.wg_rows, sq)
                    lse_r = rows_of(lse[bi, hi], qa, t.wg_rows, sq, fill=1.0)
                    dl_r = rows_of(delta[bi, hi][:, None], qa, t.wg_rows, sq)[:, 0]
                    qpos = torch.arange(qa, qa + t.wg_rows)
                    acc = torch.zeros(t.wg_rows, d)
                    for j in query_band(q0, t.rows, qa, sq, sk, causal, window, t.bk):
                        kt = rows_of(kf[bi, :, kh], j * t.bk, t.bk, sk)
                        vt = rows_of(vf[bi, :, kh], j * t.bk, t.bk, sk)
                        _, ds = scores(qt, kt, qpos, torch.arange(j * t.bk, (j + 1) * t.bk),
                                       lse_r, dl_r, ot @ vt.T)
                        acc += rnd(ds) @ kt
                    n = min(t.wg_rows, sq - qa)
                    if n > 0:
                        dq[bi, qa:qa + n, hi] = acc[:n] * (1.0 if bf16 else scale)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


CASES = {
    # B, S, KV, G, D, causal, window, softcap, q scale
    "causal_g1_d64": (2, 96, 2, 1, 64, True, None, None, 1.0),
    "window_g2_d16_s130": (1, 130, 2, 2, 16, True, 40, None, 1.0),
    "softcap_d128": (1, 96, 1, 2, 128, True, None, 30.0, 6.0),
    # the cap in its nonlinear range at moderate scores: with q x8 and a cap of 50 the
    # float32 function itself moves by 4.7e-5 between two chunkings of the plain version
    "window_softcap_gqa_d256_s130": (1, 130, 1, 4, 256, True, 70, 5.0, 2.0),
    "non_causal_g7_s130": (1, 130, 2, 7, 64, False, None, None, 1.0),
    "gqa_g16_d16": (1, 96, 1, 16, 16, True, None, None, 1.0),
}


def _inputs(B, S, KV, G, D, qscale, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, KV * G, D), np.float32) * qscale,
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV * G, D), np.float32)]
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _close(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale, err_msg=what)


def _model_grads(name, dtype):
    B, S, KV, G, D, causal, window, cap, qscale = CASES[name]
    q, k, v, do = _inputs(B, S, KV, G, D, qscale, dtype)
    kw = dict(causal=causal, window=window, softcap=cap, scale=1.0 / D ** 0.5)
    out, m, l = ops.flash_attention_fwd(q, k, v, **kw)
    return (q, k, v, do), out, m, l, kw, two_pass(q, k, v, out, m, l, do, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_two_pass_model_matches_plain_backward(name, dtype):
    (q, k, v, do), out, m, l, kw, grads = _model_grads(name, dtype)
    want = flash_attention_bwd(q, k, v, out, m, l, do, q_chunk=32, kv_chunk=32, **kw)
    for what, got, ref, t in zip(("dq", "dk", "dv"), grads, want, (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape
        _close(got, ref.float().numpy(), dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_two_pass_model_matches_jax_vjp(name, dtype):
    B, S, KV, G, D, causal, window, cap, qscale = CASES[name]
    (q, k, v, do), _, _, _, kw, grads = _model_grads(name, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(dtype) for x in (q, k, v, do))
    chunk = 32 if S % 32 == 0 else S

    def f(q_, k_, v_):
        k_, v_ = jnp.repeat(k_, G, axis=2), jnp.repeat(v_, G, axis=2)
        return full_attention(q_, k_, v_, causal=causal, scale=kw["scale"], cap=cap,
                              window=window, q_chunk=chunk, kv_chunk=chunk)

    _, vjp = jax.vjp(f, jq, jk, jv)
    for what, got, want in zip(("dq", "dk", "dv"), grads, vjp(jdo)):
        _close(got, want, dtype, what)


def test_softcap_case_is_capped():
    """The softcap cases scale q so that the cap moves the gradients: the
    model without it differs from the model with it by far more than the
    tolerance."""
    (q, k, v, do), out, m, l, kw, grads = _model_grads("softcap_d128", "float32")
    kw0 = dict(kw, softcap=None)
    out0, m0, l0 = ops.flash_attention_fwd(q, k, v, **kw0)
    uncapped = two_pass(q, k, v, out0, m0, l0, do, **kw0)
    assert float((grads[0] - uncapped[0]).abs().max()) > 100 * TOL["float32"]


BAND_SHAPES = [1, 63, 64, 65, 96, 127, 128, 130, 200]
BAND_MASKS = [(True, None), (True, 1), (True, 16), (True, 64), (True, 65), (True, 100),
              (False, None), (False, 40)]


@pytest.mark.parametrize("route", [("bfloat16", 64), ("bfloat16", 128), ("bfloat16", 256),
                                   ("float32", 64), ("float32", 256)])
@pytest.mark.parametrize("causal,window", BAND_MASKS)
def test_bands_visit_each_kept_pair_once(route, causal, window):
    """Over every S of BAND_SHAPES (tile edges and ragged ends), each (query,
    key) pair that the plain version keeps lies in exactly one tile that the
    dK/dV pass computes for it, and in exactly one that the dQ pass
    computes; no pass computes a tile twice."""
    t = Tiles(*route)
    for s in BAND_SHAPES:
        qpos, kpos = torch.arange(s)[:, None], torch.arange(s)[None, :]
        keep = _keep(qpos, kpos, s, s, causal, window).int()
        seen = torch.zeros((s, s), dtype=torch.int32)
        for k0 in range(0, s, t.keys):
            tiles = list(key_band(k0, t.keys, s, causal, window, t.bq))
            assert len(set(tiles)) == len(tiles)
            for qt in tiles:
                seen[qt * t.bq:(qt + 1) * t.bq, k0:k0 + t.keys] += 1
        assert torch.equal(seen * keep, keep), (s, "dK/dV")
        seen.zero_()
        for q0 in range(0, s, t.rows):
            for qa in range(q0, q0 + t.rows, t.wg_rows):
                tiles = list(query_band(q0, t.rows, qa, s, s, causal, window, t.bk))
                assert len(set(tiles)) == len(tiles)
                for j in tiles:
                    seen[qa:qa + t.wg_rows, j * t.bk:(j + 1) * t.bk] += 1
        assert torch.equal(seen * keep, keep), (s, "dQ")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (True, 100),
                                           (False, None)])
def test_key_side_band_is_kv_extent_reversed(causal, window):
    """For tiles of one size, a query tile lies in a key tile's band exactly
    when that key tile lies in the query tile's whole-chunk KV extent
    (``backward.kv_extent``, the JAX package's ``_kv_extent``)."""
    tile = 64
    for s in (64, 130, 256):
        for k0 in range(0, s, tile):
            band = set(key_band(k0, tile, s, causal, window, tile))
            want = {q0 // tile for q0 in range(0, s, tile)
                    if k0 in range(*kv_extent(q0, tile, s, causal, window, tile))}
            assert band == want, (s, k0)


def _tc_smem(d: int) -> tuple:
    """Shared bytes of the tensor-core dK/dV and dQ kernels at head_dim d,
    from the constants of their source (``Tile<D>``)."""
    s = TC_SOURCE
    stages = _const(s, "kStages256") if d == 256 else _const(s, "kStages")
    keys, bq = _const(s, "kKeys"), _const(s, "kQueryTile")
    kv = 2 * keys * d * 2 + 2 * stages * bq * d * 2 + keys * bq * 4 + 2 * stages * bq * 4
    wg = 2 if d >= 128 else 3
    bk = _const(s, "kKeyTile256") if d == 256 else _const(s, "kKeyTile")
    dq = 2 * wg * _const(s, "kRowsPerWarpgroup") * d * 2 + 2 * stages * bk * d * 2
    return kv + 128 + 1024, dq + 128 + 1024


def _cc_smem(d: int) -> tuple:
    s = CC_SOURCE
    own, pad = _const(s, "kOwn"), _const(s, "kPad")
    bo = _const(s, "kOther256") if d > 128 else _const(s, "kOther")
    dkdv = 2 * own * (d + 1) + 2 * bo * (d + 1) + 2 * own * (bo + pad) + 3 * bo
    dq = 2 * own * (d + 1) + 2 * bo * (d + 1) + own * (bo + pad)
    return 4 * dkdv, 4 * dq


@pytest.mark.parametrize("d", ops.TC_HEAD_DIMS)
def test_shared_memory_within_budget(d):
    """Every instantiation's shared memory, computed from the design
    constants, fits the 232,448 bytes a block can have (both sources state
    that budget); at D = 256 the tensor-core kernels take two ring stages
    and 32-key dQ tiles, the CUDA-core ones 32-row walked tiles."""
    for source in (TC_SOURCE, CC_SOURCE):
        assert _const(source, "kSmemBudget") == 232448
    sizes = _tc_smem(d) + _cc_smem(d)
    assert all(0 < x <= 232448 for x in sizes), sizes
    if d == 256:
        assert _tc_smem(d)[0] > 200_000   # the stages are what the budget allows


def test_design_constants_match_the_wrapper():
    """The wrapper's tile rows and stats padding are the kernel's."""
    s = TC_SOURCE
    assert _const(s, "kKeys") == _const(s, "kQueryTile") == ops.BWD_TILE_ROWS
    assert _const(s, "kRowsPerWarpgroup") == ops.BWD_TILE_ROWS
    assert _const(s, "kStatsPad") == ops.BWD_STATS_PAD == _const(s, "kQueryTile")
    for d in ops.TC_HEAD_DIMS:
        assert ops.bwd_kv_box_rows(d) == Tiles("bfloat16", d).bk
        assert ops.bwd_kv_box_rows(d) % 8 == 0 and ops.bwd_kv_box_rows(d) <= 256
    assert _const(CC_SOURCE, "kThreads") == 16 * (_const(CC_SOURCE, "kOwn")
                                                  // _const(CC_SOURCE, "kTR"))
    for source in (TC_SOURCE, CC_SOURCE):
        assert "atomicAdd" not in source and "red.global" not in source
        assert "atom." not in source


def test_backward_route():
    """The backward's route follows the forward's: bf16 at a tensor-core
    head_dim to the tensor-core kernel, float32 up to 256 to the CUDA-core
    one; any other dtype or head_dim raises."""
    for d in ops.TC_HEAD_DIMS:
        assert ops.bwd_route(torch.bfloat16, d) == ops.TENSOR_CORE_BWD
    for d in (1, 16, 80, 256):
        assert ops.bwd_route(torch.float32, d) == ops.CUDA_CORE_BWD
    for dtype, d in ((torch.bfloat16, 80), (torch.bfloat16, 512), (torch.float32, 257)):
        with pytest.raises(ValueError, match="head_dim"):
            ops.bwd_route(dtype, d)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.bwd_route(torch.float16, 64)
    assert set(flash_attention.bwd_kernel_launches) == {ops.TENSOR_CORE_BWD, ops.CUDA_CORE_BWD}
    from repro_torch.kernels import _build
    assert {ops.TENSOR_CORE_BWD, ops.CUDA_CORE_BWD} <= set(_build.SOURCES)


def test_bwd_kernel_wrapper_refuses_cpu_and_bad_inputs():
    q, k, v, do = _inputs(1, 32, 1, 2, 16, 1.0, "float32")
    out, m, l = ops.flash_attention_fwd(q, k, v)
    kw = dict(causal=True, window=None, softcap=None, scale=0.25)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_kernel(q, k, v, out, m, l, do, **kw)
    with pytest.raises(TypeError):
        flash_attention_bwd_kernel(q.half(), k.half(), v.half(), out, m, l, do, **kw)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_bwd_kernel(q, k[:, :16], v[:, :16], out, m, l, do, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_backward_on_cpu_is_the_plain_backward(dtype):
    """On CPU tensors ``FlashAttention.backward`` is ``flash_attention_bwd``
    bit for bit, and launches no kernel."""
    q, k, v, do = _inputs(1, 96, 2, 2, 32, 1.0, dtype, seed=4)
    kw = dict(causal=True, window=40, softcap=30.0, scale=0.2)
    before = (flash_attention.bwd_launches, dict(flash_attention.bwd_kernel_launches))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*ins, q_chunk=32, kv_chunk=32, **kw)
    assert isinstance(out.grad_fn, FlashAttention._backward_cls)
    out.backward(do)
    o, m, l = ops.flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_bwd(q, k, v, o, m, l, do, q_chunk=32, kv_chunk=32, **kw)
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w)
    assert (flash_attention.bwd_launches, flash_attention.bwd_kernel_launches) == before
