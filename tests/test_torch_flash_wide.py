"""The flash op above head width 256 (the wide kernels' route), on the CPU.

The Pallas kernel takes any D and Dv, and JAX differentiates
``full_attention`` at any width; so does the op.  Past the widest tile
(``ops.MAX_HEAD_DIM``) a card runs ``flash_attention_wide`` and its
backward ``flash_attention_wide_bwd`` at the widths as they come, in both
dtypes.  Held here, at S <= 64, widths (257, 257), (320, 320) and
(576, 512) (DeepSeek-V2's absorbed latent attention: q·k over the 512
latent + 64 rope columns, v over the latent), GQA and MQA, causal, window,
softcap and non-causal cases:

* the forward and its row stats against the JAX package's
  ``attention_ref`` and ``full_attention`` (float32 2e-5, bf16 2e-2), along
  the CPU's route and along the card's (``ops._at_kernel_widths`` forced
  on: the op routes and reports work as on a card, the plain version in
  the kernels' place);
* ``FlashAttention``'s dq, dk, dv against ``jax.vjp`` of ``full_attention``
  (v padded for JAX, which takes one head_dim, and cut), both routes;
* ``route`` / ``bwd_route`` / ``kernel_widths`` past 256, and fake tensors
  through ``flash_attention``, ``flash_attention_fwd`` and
  ``FlashAttention`` at (257, 257), (320, 320), (512, 512) and (576, 512)
  in both dtypes, with ``op_cost``'s reported work
  (``ops.wide_flops_per_score``);
* the kernels' decomposition, from the tile and slab constants read out of
  their ``.cu`` files (keep the ``constexpr int kName = n;`` form): every
  kept (query, key) pair is visited exactly once by each slab's band walk
  (forward, dK/dV, dQ) at ragged lengths and windows; and a plain-torch
  model of both kernels' arithmetic (q·kᵀ summed in 64-column chunks,
  v / dK, dV / dQ in slabs that each recompute the scores, p and ds
  rounded to the operand dtype) against the plain version and JAX.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import full_attention
from repro_torch.analysis import op_cost
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_fwd, flash_attention_ref, ops)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CHUNK = 16
WIDTHS = [(257, 257), (320, 320), (576, 512)]
# B, S, KV, G, causal, window, softcap, q's scale (the softcap case's scores reach past the cap)
CASES = {
    "gqa": (2, 48, 2, 2, True, None, None, 1.0),
    "mqa_window": (1, 64, 1, 4, True, 24, None, 1.0),
    "softcap": (1, 48, 2, 1, True, None, 3.0, 4.0),
    "non_causal": (1, 32, 1, 2, False, None, None, 1.0),
}
GRAD_CASES = ("mqa_window", "softcap")
CSRC = Path(ops.__file__).parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["cpu_widths", "card_route"])
def route(request, monkeypatch):
    """The CPU's widths, or the card's route (the plain version in the
    kernels' place)."""
    if request.param == "card_route":
        monkeypatch.setattr(ops, "_at_kernel_widths", lambda t: True)
    return request.param


def _arrays(case, d, dv, seed):
    b, s, kv, g, *_, q_scale = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, kv * g, d), np.float32) * np.float32(q_scale),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv, dv), np.float32),
            rng.standard_normal((b, s, kv * g, dv), np.float32)]


def _inputs(case, d, dv, dtype, seed=0):
    """q, k, v, dout in torch (``dtype``) and the same values in JAX."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in _arrays(case, d, dv, seed)]
    return t, [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]


def _close(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale, err_msg=what)


def _full_attention(q, k, v, g, dv, **kw):
    """JAX's ``full_attention`` (one head_dim) with the narrower of q, k and
    v padded to the wider and the output cut back; k, v GQA-repeated."""
    if g > 1:
        k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    d = q.shape[-1]
    if dv < d:
        v = jnp.pad(v, ((0, 0),) * 3 + ((0, d - dv),))
    elif dv > d:
        q, k = (jnp.pad(x, ((0, 0),) * 3 + ((0, dv - d),)) for x in (q, k))
    return full_attention(q, k, v, q_chunk=CHUNK, kv_chunk=CHUNK, **kw)[..., :dv]


def _opts(case):
    _, _, _, g, causal, window, cap, _ = CASES[case]
    return g, causal, window, cap


@functools.lru_cache(maxsize=None)
def _jax_forward(case, d, dv, dtype):
    """JAX's attention_ref and full_attention outputs (shared by both routes)."""
    _, (jq, jk, jv, _) = _inputs(case, d, dv, dtype)
    g, causal, window, cap = _opts(case)
    scale = d ** -0.5
    ref = jax_attention_ref(jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2),
                            causal=causal, window=window, softcap=cap, scale=scale)
    full = _full_attention(jq, jk, jv, g, dv, causal=causal, window=window, cap=cap,
                           scale=scale)
    return np.asarray(ref, np.float32), np.asarray(full, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_vjp(case, d, dv, dtype):
    _, (jq, jk, jv, jdo) = _inputs(case, d, dv, dtype, seed=3)
    g, causal, window, cap = _opts(case)
    fn = lambda *x: _full_attention(*x, g, dv, causal=causal, window=window,  # noqa: E731
                                    cap=cap, scale=d ** -0.5)
    out, vjp = jax.vjp(fn, jq, jk, jv)
    return tuple(np.asarray(x, np.float32) for x in (out, *vjp(jdo)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", WIDTHS, ids=[f"{d}x{dv}" for d, dv in WIDTHS])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_forward_matches_jax(case, width, dtype, route):
    d, dv = width
    b, s, kv, *_ = CASES[case]
    g, causal, window, cap = _opts(case)
    (q, k, v, _), _ = _inputs(case, d, dv, dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    out = flash_attention(q, k, v, **kw)
    assert out.shape == (b, s, kv * g, dv) and out.dtype == q.dtype
    ref, full = _jax_forward(case, d, dv, dtype)
    _close(out, ref, dtype, "attention_ref")
    _close(out, full, dtype, "full_attention")
    o2, m, l = flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(o2, out) and m.shape == l.shape == (b, kv * g, s)
    _, rm, rl = flash_attention_ref(q, k, v, scale=d ** -0.5, return_stats=True, **kw)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    torch.testing.assert_close(l, rl, rtol=0, atol=0)
    if route == "card_route":
        kept = b * kv * g * ops.kept_scores(s, s, causal, window)
        cost = op_cost.analyze(lambda: flash_attention(q, k, v, **kw))
        assert cost.flops == ops.wide_flops_per_score(d, dv, False) * kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", WIDTHS, ids=[f"{d}x{dv}" for d, dv in WIDTHS])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_wide_backward_matches_jax_vjp(case, width, dtype, route):
    """No padding on either route: the Function's gradients are the plain
    backward's at the widths as they come."""
    d, dv = width
    g, causal, window, cap = _opts(case)
    (q, k, v, do), _ = _inputs(case, d, dv, dtype, seed=3)
    jout, jdq, jdk, jdv = _jax_vjp(case, d, dv, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                          q_chunk=CHUNK, kv_chunk=CHUNK)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    _close(out.detach(), jout, dtype, "out")
    for what, t, want in (("dq", q, jdq), ("dk", k, jdk), ("dv", v, jdv)):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype, what
        _close(t.grad, want, dtype, what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [(257, 257), (320, 320), (512, 512), (576, 512), (64, 300),
                                   (300, 16)])
def test_routes_past_the_widest_tile(width, dtype):
    d, dv = width
    for grad in (False, True):
        assert ops.kernel_widths(dtype, d, dv, grad) == (d, dv)      # never padded
    assert ops.route(dtype, d, dv) == ops.CUDA_CORE_WIDE
    assert ops.bwd_route(dtype, d, dv) == ops.CUDA_CORE_WIDE_BWD
    assert ops.CUDA_CORE_WIDE in flash_attention.kernel_launches
    assert ops.CUDA_CORE_WIDE_BWD in flash_attention.bwd_kernel_launches


def test_at_256_and_below_the_routes_are_the_tiles():
    """The wide route is taken only where the wider is past 256."""
    for d in (1, 16, 80, 128, 192, 256):
        assert ops.route(torch.float32, d) == ops.CUDA_CORE
        assert ops.bwd_route(torch.float32, d) == ops.CUDA_CORE_BWD
        assert ops.kernel_widths(torch.float32, d)[0] in ops.TC_HEAD_DIMS
    for pair in ops.TC_HEAD_DIM_PAIRS:
        assert ops.route(torch.bfloat16, *pair) == ops.TENSOR_CORE
    with pytest.raises(ValueError, match="head_dims >= 1"):
        ops.kernel_widths(torch.float32, 0, 300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [(257, 257), (320, 320), (512, 512), (576, 512)])
def test_fake_tensors_take_the_wide_route(width, dtype):
    """The dry run's fake tensors through all three entries, forward and
    backward: shapes as they come and the wide kernels' own work."""
    d, dv = width
    b, s, h, kv = 1, 128, 4, 1
    kept = b * h * ops.kept_scores(s, s, True, None)
    with FakeTensorMode():
        q = torch.empty((b, s, h, d), dtype=dtype, requires_grad=True)
        k = torch.empty((b, s, kv, d), dtype=dtype, requires_grad=True)
        v = torch.empty((b, s, kv, dv), dtype=dtype, requires_grad=True)

        def train():
            out = flash_attention(q, k, v)
            assert out.shape == (b, s, h, dv)
            dq, dk, dvv = torch.autograd.grad(out.sum(), (q, k, v))
            assert (dq.shape, dk.shape, dvv.shape) == (q.shape, k.shape, v.shape)
        cost = op_cost.analyze(train)
        assert cost.flops_by_name["flash_attention_fwd"] == \
            ops.wide_flops_per_score(d, dv, False) * kept
        assert cost.flops_by_name["flash_attention_bwd"] == \
            ops.wide_flops_per_score(d, dv, True) * kept
        with torch.no_grad():
            o, m, l = flash_attention_fwd(q, k, v)
        assert o.shape == (b, s, h, dv) and m.shape == l.shape == (b, h, s)
        out = ops.FlashAttention.apply(q, k, v, True, None, None, d ** -0.5, 1024, 1024)
        assert out.shape == (b, s, h, dv)


def test_wide_work_formula_at_absorbed_mla():
    """2·(D·ceil(Dv/256) + Dv) a kept score forward; 2·(D + Dv)·(ceil(max(D,
    Dv)/128) + ceil(D/256)) + 2·Dv + 4·D backward: at (576, 512) two v slabs,
    five dK/dV slabs and three dQ slabs."""
    assert ops.wide_flops_per_score(576, 512, False) == 2 * (576 * 2 + 512) == 3328
    assert ops.wide_flops_per_score(576, 512, True) == 2 * 1088 * (5 + 3) + 1024 + 2304 \
        == 20736
    kept = 16 * ops.kept_scores(4096, 4096, True, None)
    assert kept == 134_250_496
    assert round(2 * (576 + 512) * kept / 1e9, 1) == 292.1      # the function's own FLOPs


def _cu_constants(name):
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


FWD = _cu_constants("flash_attention_wide.cu")
BWD = _cu_constants("flash_attention_wide_bwd.cu")


def test_slab_constants_match_the_op():
    assert (FWD["kSlab"], BWD["kKvSlab"], BWD["kQSlab"]) == (
        ops.WIDE_V_SLAB, ops.WIDE_KV_SLAB, ops.WIDE_Q_SLAB)
    assert FWD["kSlab"] == 16 * FWD["kNJ"] and BWD["kQSlab"] == 16 * BWD["kQNJ"]
    assert BWD["kKvSlab"] == 16 * BWD["kKvNJ"]
    # shared memory does not grow with the widths: the kernels' fixed tiles
    ldc, budget = FWD["kChunk"] + 1, FWD["kSmemBudget"]
    fwd = 2 * FWD["kBQ"] * ldc + FWD["kBK"] * FWD["kSlab"] + FWD["kBQ"] * (FWD["kBK"] + 4)
    own, other, ldp = BWD["kOwn"], BWD["kOther"], BWD["kOther"] + BWD["kPad"]
    dkdv = 2 * own * ldc + 2 * other * BWD["kKvSlab"] + 2 * own * ldp + 3 * other
    dq = 2 * own * ldc + other * BWD["kQSlab"] + own * ldp
    assert [4 * x for x in (fwd, dkdv, dq)] == [116_224, 134_400, 116_224]
    assert max(fwd, dkdv, dq) * 4 <= budget


def _kept(sq, sk, causal, window):
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    return keep


def _fwd_band(q0, sq, sk, causal, window, bq, bk):
    """The forward's (and dQ's) key tiles [lo, hi) of the query tile at q0."""
    nk = -(-sk // bk)
    hi = min((min(q0 + bq, sq) - 1) // bk + 1, nk) if causal else nk
    lo = max(q0 - window + 1, 0) // bk if window else 0
    return lo, hi


def _dkdv_band(k0, sq, causal, window, own, other):
    """The dK/dV kernel's query tiles [t_lo, t_hi) of the key tile at k0."""
    q_lo = k0 if causal else 0
    q_end = min(sq, k0 + own - 1 + window) if window else sq
    t_lo = q_lo // other
    return t_lo, ((q_end - 1) // other + 1 if q_lo < q_end else t_lo)


@pytest.mark.parametrize("s,causal,window", [(64, True, None), (333, True, None),
                                              (333, True, 16), (200, True, 100),
                                              (129, False, None), (77, True, 1),
                                              (500, True, 300)])
def test_every_band_walk_visits_each_kept_pair_once(s, causal, window):
    keep = _kept(s, s, causal, window)
    bq, bk, own, other = FWD["kBQ"], FWD["kBK"], BWD["kOwn"], BWD["kOther"]
    fwd = np.zeros((s, s), int)
    for q0 in range(0, s, bq):
        lo, hi = _fwd_band(q0, s, s, causal, window, bq, bk)
        fwd[q0:q0 + bq, lo * bk:hi * bk] += 1
    dq = np.zeros((s, s), int)
    for q0 in range(0, s, own):
        lo, hi = _fwd_band(q0, s, s, causal, window, own, other)
        dq[q0:q0 + own, lo * other:hi * other] += 1
    dkdv = np.zeros((s, s), int)
    for k0 in range(0, s, own):
        t_lo, t_hi = _dkdv_band(k0, s, causal, window, own, other)
        dkdv[t_lo * other:t_hi * other, k0:k0 + own] += 1
    for name, visits in (("forward", fwd), ("dQ", dq), ("dK/dV", dkdv)):
        assert (visits[keep] == 1).all(), name
        assert visits.max() == 1, name


def _chunked_scores(a, b, chunk):
    """[.., R, W] · [.., C, W]ᵀ as the kernels sum it: over W in chunks."""
    s = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for d0 in range(0, a.shape[-1], chunk):
        s += a[..., d0:d0 + chunk] @ b[..., d0:d0 + chunk].transpose(-1, -2)
    return s


def _model_forward(q, k, v, causal, window, cap, scale):
    """The wide forward's arithmetic: per (head, v slab, query tile) the key
    tiles of its band, scores summed in chunks and recomputed in every slab,
    the online softmax with p rounded to v's dtype, stats from each slab."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    bq, bk, chunk, slab = FWD["kBQ"], FWD["kBK"], FWD["kChunk"], FWD["kSlab"]
    pad = lambda t, n: torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, n - t.shape[1]))  # noqa
    nq, nk = -(-sq // bq) * bq, -(-sk // bk) * bk
    qp, kp, vp = pad(q, nq).transpose(1, 2), pad(k, nk).transpose(1, 2), pad(v, nk).transpose(1, 2)
    out = torch.zeros(b, h, nq, dv)
    stats = []
    for c0 in range(0, dv, slab):
        m_all, l_all = torch.zeros(b, h, nq), torch.zeros(b, h, nq)
        for q0 in range(0, sq, bq):
            lo, hi = _fwd_band(q0, sq, sk, causal, window, bq, bk)
            m, l = torch.full((b, h, bq), -2e38), torch.zeros(b, h, bq)
            acc = torch.zeros(b, h, bq, min(slab, dv - c0))
            qpos = torch.arange(q0, q0 + bq)[:, None]
            for j in range(lo, hi):
                keys = slice(j * bk, (j + 1) * bk)
                kt = kp[:, :, keys].repeat_interleave(h // kvh, 1)
                vt = vp[:, :, keys, c0:c0 + slab].repeat_interleave(h // kvh, 1)
                x = _chunked_scores(qp[:, :, q0:q0 + bq], kt, chunk) * scale
                if cap is not None:
                    x = cap * torch.tanh(x / cap)
                kpos = torch.arange(j * bk, (j + 1) * bk)[None, :]
                keep = torch.ones(bq, bk, dtype=torch.bool)
                if causal:
                    keep &= qpos >= kpos
                if window is not None:
                    keep &= qpos - kpos < window
                x = torch.where(keep, x, torch.tensor(-2e38))
                x = torch.where(kpos < sk, x, torch.tensor(-float("inf")))
                m_new = torch.maximum(m, x.amax(-1))
                p = torch.exp(x - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + p.to(v.dtype).float() @ vt
                m = m_new
            out[:, :, q0:q0 + bq, c0:c0 + slab] = acc / l.clamp_min(1e-30)[..., None]
            m_all[:, :, q0:q0 + bq], l_all[:, :, q0:q0 + bq] = m, l
        stats.append((m_all[..., :sq], l_all[..., :sq]))
    return out[:, :, :sq].transpose(1, 2).to(q.dtype), stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 150, 1, 2, 576, 512, True, 40, None),
                                   (1, 130, 2, 1, 300, 320, False, None, 3.0),
                                   (2, 70, 1, 3, 257, 520, True, None, None)],
                         ids=["mla_window", "non_causal_cap", "three_v_slabs"])
def test_kernel_model_forward_matches_plain_and_jax(shape, dtype):
    b, s, kv, g, d, dv, causal, window, cap = shape
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(x, np.float32) for x in
            ((b, s, kv * g, d), (b, s, kv, d), (b, s, kv, dv))]
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    kw = dict(causal=causal, window=window, softcap=cap, scale=d ** -0.5)
    out, stats = _model_forward(q, k, v, causal, window, cap, d ** -0.5)
    ref, m, l = flash_attention_ref(q, k, v, return_stats=True, **kw)
    _close(out, ref.float().numpy(), dtype, "plain")
    for sm, sl in stats:              # every slab computes the same stats
        torch.testing.assert_close(sm, stats[0][0], rtol=0, atol=0)
        torch.testing.assert_close(sl, stats[0][1], rtol=0, atol=0)
    torch.testing.assert_close(stats[0][0], m, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(stats[0][1], l, rtol=1e-5, atol=1e-6)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrs)
    want = jax_attention_ref(jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2),
                             causal=causal, window=window, softcap=cap, scale=d ** -0.5)
    _close(out, want, dtype, "JAX attention_ref")


def _model_backward(q, k, v, out, m, l, dout, causal, window, cap, scale):
    """The wide backward's arithmetic: Δ over Dv; dK/dV by (KV head, slab,
    key tile) walking its G heads' band of query tiles, dQ by (head, slab,
    query tile) walking the forward's band; s and dP summed in chunks and
    recomputed in every slab; p and ds rounded to the operand dtype."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    own, other, chunk = BWD["kOwn"], BWD["kOther"], BWD["kChunk"]
    kvs, qsl, g = BWD["kKvSlab"], BWD["kQSlab"], h // kvh
    rnd = lambda x: x.to(q.dtype).float()  # noqa: E731
    n = -(-max(sq, sk) // own) * own
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, n - t.shape[1]))  # noqa
    qp, kp, vp, op_, dp_ = (pad(t).transpose(1, 2) for t in (q, k, v, out, dout))
    delta = (dp_ * op_).sum(-1)                                   # [B, H, n]
    mp = torch.nn.functional.pad(m, (0, n - sq))
    lp = torch.nn.functional.pad(l, (0, n - sq), value=1.0).clamp_min(1e-30)
    pos = torch.arange(n)

    def p_ds(rows, cols, hh, kvhh):
        qi, kj = qp[:, hh, rows], kp[:, kvhh, cols]
        s = _chunked_scores(qi, kj, chunk) * scale
        dfac = torch.ones_like(s)
        if cap is not None:
            t = torch.tanh(s / cap)
            s, dfac = cap * t, 1 - t * t
        dpv = _chunked_scores(dp_[:, hh, rows], vp[:, kvhh, cols], chunk)
        keep = (pos[rows, None] < sq) & (pos[None, cols] < sk)
        if causal:
            keep &= pos[rows, None] >= pos[None, cols]
        if window is not None:
            keep &= pos[rows, None] - pos[None, cols] < window
        p = torch.where(keep, torch.exp(s - mp[:, hh, rows, None]) / lp[:, hh, rows, None], 0.0)
        ds = torch.where(keep, p * (dpv - delta[:, hh, rows, None]) * dfac * scale, 0.0)
        return rnd(p), rnd(ds)

    dk, dvv = torch.zeros(b, kvh, n, d), torch.zeros(b, kvh, n, dv)
    for kh in range(kvh):
        for c0 in range(0, max(d, dv), kvs):
            for k0 in range(0, sk, own):
                cols = slice(k0, k0 + own)
                t_lo, t_hi = _dkdv_band(k0, sq, causal, window, own, other)
                for hh in range(kh * g, (kh + 1) * g):
                    for t in range(t_lo, t_hi):
                        rows = slice(t * other, (t + 1) * other)
                        p, ds = p_ds(rows, cols, hh, kh)
                        dk[:, kh, cols, c0:c0 + kvs] += ds.transpose(-1, -2) @ \
                            qp[:, hh, rows, c0:c0 + kvs]
                        dvv[:, kh, cols, c0:c0 + kvs] += p.transpose(-1, -2) @ \
                            dp_[:, hh, rows, c0:c0 + kvs]
    dq = torch.zeros(b, h, n, d)
    for hh in range(h):
        for c0 in range(0, d, qsl):
            for q0 in range(0, sq, own):
                rows = slice(q0, q0 + own)
                lo, hi = _fwd_band(q0, sq, sk, causal, window, own, other)
                for j in range(lo, hi):
                    cols = slice(j * other, (j + 1) * other)
                    _, ds = p_ds(rows, cols, hh, hh // g)
                    dq[:, hh, rows, c0:c0 + qsl] += ds @ kp[:, hh // g, cols, c0:c0 + qsl]
    cut = lambda t, s_: t[:, :, :s_].transpose(1, 2).to(q.dtype)  # noqa: E731
    return cut(dq, sq), cut(dk, sk), cut(dvv, sk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 140, 1, 2, 576, 512, True, 50, None),
                                   (1, 96, 2, 1, 264, 300, True, None, 3.0)],
                         ids=["mla_window", "dv_wider_cap"])
def test_kernel_model_backward_matches_plain(shape, dtype):
    """Against ``backward.flash_attention_bwd`` on the same inputs and stats:
    float32 1e-4 of max |g|, bf16 2e-2 of max(1, max |g|) (the card's)."""
    b, s, kv, g, d, dv, causal, window, cap = shape
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(x, np.float32) for x in
            ((b, s, kv * g, d), (b, s, kv, d), (b, s, kv, dv), (b, s, kv * g, dv))]
    q, k, v, dout = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    kw = dict(causal=causal, window=window, softcap=cap, scale=d ** -0.5)
    out, m, l = flash_attention_ref(q, k, v, return_stats=True, **kw)
    want = flash_attention_bwd(q, k, v, out, m, l, dout, q_chunk=64, kv_chunk=64, **kw)
    got = _model_backward(q, k, v, out, m, l, dout, causal, window, cap, d ** -0.5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        mx = w.float().abs().max().item()
        tol = 1e-4 * mx if dtype == "float32" else 2e-2 * max(1.0, mx)
        assert (a.float() - w.float()).abs().max().item() <= tol, name
