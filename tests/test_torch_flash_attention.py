"""The port's ``flash_attention`` op against the JAX package, on the CPU.

On CPU tensors the op runs its plain version (``ref.py``); it is held
against the JAX oracle ``flash_attention_ref`` and against the model's
XLA path ``full_attention`` on the cases of ``tests/test_kernels_flash.py``
(the JAX package's Pallas op itself does not run on the installed jax).
Tolerances are that file's: 2e-5 in fp32 (both sides compute in fp32 and
differ only in summation order) and 2e-2 in bf16 (one bf16 rounding of
the output, and ``full_attention`` also rounds p to bf16 before p·v).
The CUDA kernel itself runs only on the card: ``chip_smoke.py`` phase 5
holds it against the same plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_ref as jax_flash_ref
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import full_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops

CASES = [
    # B, S, KV, G, D, causal, window, softcap
    (1, 128, 1, 1, 64, True, None, None),
    (2, 256, 2, 2, 64, True, None, None),
    (1, 256, 1, 4, 32, True, 64, None),
    (2, 128, 4, 1, 64, False, None, None),
    (1, 256, 2, 2, 64, True, None, 50.0),
    (1, 512, 2, 4, 128, True, 128, 30.0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, KV, G, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, KV * G, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


def _both(arrays, dtype):
    """The same values in both packages, rounded once to ``dtype``."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    j = [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_matches_jax_ref(case, dtype):
    B, S, KV, G, D, causal, window, cap = case
    (q, k, v), (jq, jk, jv) = _both(_inputs(B, S, KV, G, D), dtype)
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    ref = jax_flash_ref(jq, jk, jv, causal=causal, window=window, softcap=cap)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in CASES if c[5]])
def test_flash_matches_model_xla_path(case, dtype):
    """``full_attention`` on GQA-repeated k, v (``jnp.repeat``) is what the
    JAX model runs for prefill; the op folds GQA instead."""
    B, S, KV, G, D, causal, window, cap = case
    (q, k, v), (jq, jk, jv) = _both(_inputs(B, S, KV, G, D, seed=1), dtype)
    out = flash_attention(q, k, v, causal=True, window=window, softcap=cap,
                          scale=1.0 / np.sqrt(D))
    xla = full_attention(jq, jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2),
                         causal=True, scale=1.0 / np.sqrt(D), cap=cap,
                         window=window, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(xla, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_gqa_head_order(groups):
    """Query head h reads KV head h // G: each KV head's values are a
    distinct constant, so a wrong grouping shows even where G = 1 would
    hide it."""
    B, S, KV, D = 1, 64, 2, 16
    q, k, _ = _inputs(B, S, KV, groups, D, seed=2)
    v = np.broadcast_to(np.arange(KV, dtype=np.float32)[None, None, :, None],
                        (B, S, KV, D)).copy()
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    want = np.repeat(np.arange(KV, dtype=np.float32), groups)
    np.testing.assert_allclose(out[0, :, :, 0].numpy(),
                               np.broadcast_to(want, (S, KV * groups)), atol=1e-6)
    ref = jax_flash_ref(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S, window", [(1000, None), (1000, 100), (77, 16)])
def test_ragged_lengths(S, window):
    """Any sequence length the model accepts, not only multiples of a tile."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(1, S, 2, 4, 64, seed=3), "float32")
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = jax_flash_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_first_causal_row_is_v0():
    q, k, v = map(torch.from_numpy, _inputs(1, 128, 1, 1, 64))
    out = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_op_checks_raise_and_cpu_leaves_launches_at_zero():
    q, k, v = map(torch.from_numpy, _inputs(1, 32, 2, 2, 16))
    before = flash_attention.launches
    flash_attention(q, k, v)
    flash_attention(q, k[:, :16], v[:, :16], causal=False)   # cross-attention
    assert flash_attention.launches == before == 0
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k[:, :16], v[:, :16], causal=True)
    big = torch.zeros(1, 8, 2, 160)           # the plain version takes any head_dim
    assert flash_attention(big, big[:, :, :1], big[:, :, :1]).shape == big.shape
    assert fa_ops.route(torch.float32, 320) == fa_ops.CUDA_CORE_WIDE   # past the widest tile
    with pytest.raises(ValueError, match="head_dim <= 256"):
        fa_ops.route(torch.float32, 160, 128)  # what a CUDA call checks first
    with pytest.raises(ValueError, match="head_dim in"):
        fa_ops.route(torch.bfloat16, 160)
    with pytest.raises(ValueError, match="span devices"):
        flash_attention(q, k.to("meta"), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(torch.zeros(1, 32, 3, 16), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    assert fa_ops.MAX_HEAD_DIM == 256



HEAD_DIM_CASES = [
    # B, S, KV, G, D, window, softcap: gemma2's head_dim, and one no kernel tile divides
    (1, 96, 4, 2, 256, 40, 50.0),
    (1, 64, 1, 2, 160, 24, 30.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HEAD_DIM_CASES)
def test_head_dims_past_128_match_jax(case, dtype):
    """The plain version takes every head_dim the JAX package takes: GQA,
    causal, a window shorter than S and a softcap, against the kernel's
    oracle ``attention_ref`` (on GQA-repeated k, v) and the model's XLA
    path ``full_attention``."""
    B, S, KV, G, D, window, cap = case
    (q, k, v), (jq, jk, jv) = _both(_inputs(B, S, KV, G, D, seed=4), dtype)
    scale = 1.0 / np.sqrt(D)
    out = flash_attention(q, k, v, causal=True, window=window, softcap=cap)
    assert out.dtype == q.dtype and out.shape == q.shape
    jk, jv = jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2)
    oracle = jax_attention_ref(jq, jk, jv, causal=True, window=window, softcap=cap)
    xla = full_attention(jq, jk, jv, causal=True, scale=scale, cap=cap, window=window,
                         q_chunk=32, kv_chunk=32)
    for name, ref in (("attention_ref", oracle), ("full_attention", xla)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype], err_msg=name)


def test_a_window_needs_aligned_sequences():
    """The kernels align masks at position 0 and the plain version on the
    right: with Sq != Sk a window keeps other keys on the card than on the
    CPU (40 queries, 16 keys, window 8: 17 rows see no key when aligned at
    0).  So only a CUDA call refuses it (``chip_smoke.py`` phase 5); the
    CPU computes it as the JAX package's ``attention_ref`` does."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(1, 40, 2, 1, 256), "float32")
    out = flash_attention(q, k[:, :16], v[:, :16], causal=False, window=8)
    ref = jax_attention_ref(jq, jk[:, :16], jv[:, :16], causal=False, window=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert flash_attention(q, k[:, :16], v[:, :16], causal=False).shape == q.shape


PREFILL_CASES = [
    # B, S, KV, G, D, causal: zamba2's shared block (32/32 heads of 80) and hubert's
    # non-causal encoder (16/16 of 80), at their own width in bf16 and padded to 128 in
    # float32, at narrow heads and a ragged S; internvl2's 14/2 heads of 64 (G = 7, no
    # padding)
    (1, 77, 4, 1, 80, True),
    (2, 40, 2, 1, 80, False),
    (1, 50, 2, 7, 64, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_padded_prefill_matches_jax(case, dtype):
    """The models' prefill call (``attention._padded_flash``) hands the op
    q, k, v at their own width; on a card the op runs the kernels at
    ``ops.kernel_widths``: in bf16 (no grad) at D, a pair of the
    tensor-core forward, in float32 with zero columns up to the least
    tensor-core head_dim, the scale of the unpadded D, the output cut back;
    against the JAX package's ``full_attention`` on the unpadded tensors
    (k, v GQA-repeated)."""
    from repro_torch.models import attention as tattn

    B, S, KV, G, D, causal = case
    (q, k, v), (jq, jk, jv) = _both(_inputs(B, S, KV, G, D, seed=5), dtype)
    scale = 1.0 / np.sqrt(D)
    calls, real = [], tattn.flash_attention

    def spy(*args, **kw):
        calls.append(tuple(t.shape[-1] for t in args))
        return real(*args, **kw)

    tattn.flash_attention = spy
    try:
        out = tattn._padded_flash([q], [k], v, causal=causal, scale=scale)
    finally:
        tattn.flash_attention = real
    assert calls == [(D,) * 3] and out.shape == q.shape
    width = D if dtype == "bfloat16" else (128 if D == 80 else D)
    assert fa_ops.kernel_widths(q.dtype, D, D) == (width, width)
    ref = full_attention(jq, jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2),
                         causal=causal, scale=scale, q_chunk=S, kv_chunk=S)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_padding_is_the_identity_at_kernel_head_dims():
    """At a head_dim the kernel has, the prefill hands the op q, k and v as
    they are: k and v as the strided halves of one fused projection, no
    copy (``ops.tma_map_args`` takes such views)."""
    from repro_torch.models import attention as tattn

    for d in fa_ops.TC_HEAD_DIMS:
        kv = torch.zeros(1, 8, 2, 2, d)
        k, v = kv[:, :, 0], kv[:, :, 1]
        assert fa_ops.kernel_widths(torch.float32, d, d, grad=True) == (d, d)
        assert tattn._side_by_side([k]) is k and tattn._side_by_side([v]) is v
        assert fa_ops._pad_columns(k, d) is k and fa_ops._pad_columns(v, d) is v
    assert fa_ops._pad_columns(torch.ones(1, 2, 80), 128)[..., 80:].abs().sum() == 0
