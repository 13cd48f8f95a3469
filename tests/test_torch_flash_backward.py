"""The flash op under autograd against the JAX package's custom VJP, on
the CPU.

``flash_attention`` becomes ``FlashAttention`` (a ``torch.autograd.Function``)
when an input requires grad: its forward stores the row stats (m, l), its
backward is ``backward.flash_attention_bwd``, the port of ``_fa_bwd``.  On
CPU tensors the forward is the plain version, so these tests run the very
backward that the card runs.  The reference is ``jax.vjp`` of
``full_attention`` (``_fa_fwd`` / ``_fa_bwd``) with k and v repeated over
the G query heads before the call, as ``gqa_apply`` does.  S = 96 at
chunks of 32 gives three query chunks and KV extents that skip whole
chunks.  dq, dk, dv are held to 2e-5 in float32 (sums in another order)
and in bf16 to 2e-2 relative and 2e-2 of the tensor's largest magnitude
(the forward's output, p and ds round to bf16 in both at other places,
and dk, dv sum terms up to ~10 that cancel to values near 0); the stats
to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _fa_forward_chunks, full_attention
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention, ops
from repro_torch.kernels.flash_attention.backward import kv_extent
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

CHUNK = 32
CASES = {
    # B, S, KV, G, D, causal, window, softcap, q scale
    "causal": (2, 96, 2, 1, 32, True, None, None, 1.0),
    "window": (1, 96, 2, 1, 32, True, 32, None, 1.0),
    "softcap": (1, 96, 2, 1, 32, True, None, 50.0, 8.0),
    "gqa_8_2": (1, 96, 2, 4, 32, True, None, None, 1.0),
    "non_causal": (2, 96, 2, 2, 32, False, None, None, 1.0),
    "window_softcap_gqa": (1, 96, 1, 4, 16, True, 40, 30.0, 6.0),
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, KV, G, D, qscale, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, KV * G, D), np.float32) * qscale,
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV * G, D), np.float32)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]
    return t, j


def _jax_grads(jq, jk, jv, jdo, g, **kw):
    def f(q, k, v):
        if g > 1:
            k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
        return full_attention(q, k, v, q_chunk=CHUNK, kv_chunk=CHUNK, **kw)
    out, vjp = jax.vjp(f, jq, jk, jv)
    return out, vjp(jdo)


def _close(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_jax_vjp(name, dtype):
    B, S, KV, G, D, causal, window, cap, qscale = CASES[name]
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(B, S, KV, G, D, qscale, dtype)
    scale = 1.0 / D ** 0.5
    jout, (jdq, jdk, jdv) = _jax_grads(jq, jk, jv, jdo, G, causal=causal, scale=scale,
                                       cap=cap, window=window)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap, scale=scale,
                          q_chunk=CHUNK, kv_chunk=CHUNK)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    _close(out.detach(), jout, dtype, "out")
    for what, t, want in (("dq", q, jdq), ("dk", k, jdk), ("dv", v, jdv)):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        _close(t.grad, want, dtype, what)


def test_softcap_case_is_capped():
    """q is scaled in the softcap cases so that the cap moves the scores:
    without it dq would differ by far more than the tolerance."""
    B, S, KV, G, D, causal, window, cap, qscale = CASES["softcap"]
    (q, k, v, do), _ = _inputs(B, S, KV, G, D, qscale, "float32")
    grads = []
    for c in (cap, None):
        qq = q.clone().requires_grad_()
        flash_attention(qq, k, v, causal=causal, softcap=c, q_chunk=CHUNK,
                        kv_chunk=CHUNK).backward(do)
        grads.append(qq.grad)
    assert float((grads[0] - grads[1]).abs().max()) > 100 * TOL["float32"]


@pytest.mark.parametrize("name", ["causal", "window", "softcap", "gqa_8_2"])
def test_stats_match_jax_forward_chunks(name):
    B, S, KV, G, D, causal, window, cap, qscale = CASES[name]
    (q, k, v, _), (jq, jk, jv, _) = _inputs(B, S, KV, G, D, qscale, "float32")
    scale = 1.0 / D ** 0.5
    out, m, l = ops.flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=cap,
                                        scale=scale)
    jk, jv = jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2)
    jout, jm, jl = _fa_forward_chunks(jq, jk, jv, causal, window, scale, cap, CHUNK, CHUNK,
                                      want_stats=True)
    assert m.shape == l.shape == (B, KV * G, S) and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_80_backward(causal, dtype):
    """Heads of 80 reach the op at their own width
    (``attention._padded_flash``), which on a card pads them with zero
    columns to 128 inside; the grads are those of the unpadded
    attention."""
    B, S, KV, G, D = 1, 96, 2, 2, 80
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(B, S, KV, G, D, 1.0, dtype, seed=3)
    scale = 1.0 / D ** 0.5
    jout, (jdq, jdk, jdv) = _jax_grads(jq, jk, jv, jdo, G, causal=causal, scale=scale)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tattn._padded_flash([q], [k], v, causal=causal, scale=scale, q_chunk=CHUNK,
                              kv_chunk=CHUNK)
    assert out.shape == (B, S, KV * G, D)
    out.backward(do)
    _close(out.detach(), jout, dtype, "out")
    for what, t, want in (("dq", q, jdq), ("dk", k, jdk), ("dv", v, jdv)):
        _close(t.grad, want, dtype, what)


def test_routing_under_grad():
    """The Function runs exactly when grad is enabled and an input requires
    grad; otherwise the op returns a plain tensor with no graph."""
    (q, k, v, _), _ = _inputs(1, 32, 1, 2, 16, 1.0, "float32")
    assert flash_attention(q, k, v).grad_fn is None
    qq = q.clone().requires_grad_()
    assert isinstance(flash_attention(qq, k, v).grad_fn,
                      FlashAttention._backward_cls)
    with torch.no_grad():
        assert flash_attention(qq, k, v).grad_fn is None
    kk = k.clone().requires_grad_()
    assert flash_attention(q, kk, v).grad_fn is not None


@pytest.mark.parametrize("q0,qc,t,causal,window,want", [
    (0, 32, 96, True, None, (0, 32)),
    (64, 32, 96, True, None, (0, 96)),
    (64, 32, 96, True, 32, (32, 96)),
    (32, 32, 96, False, None, (0, 96)),
    (32, 20, 100, True, None, (0, 64)),
    (96, 4, 100, True, 10, (64, 100)),
])
def test_kv_extent(q0, qc, t, causal, window, want):
    """``_kv_extent``'s whole-chunk band, clipped to the sequence for a
    short last chunk (the JAX package takes only whole chunks)."""
    assert kv_extent(q0, qc, t, causal, window, 32) == want
