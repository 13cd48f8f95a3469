"""The port's MLA attention (DeepSeek-V2) against the JAX package's, on
the CPU.

``mla_apply`` on REDUCED deepseek-v2 weights from the JAX package:
prefill (with the compressed cache ``return_state`` builds) and three
absorbed decode steps written in place, in float32 (1e-5) and bf16
(2e-2).  The prefill's flash call runs at a padded head_dim (q, k from
qk_nope + qk_rope, v from v_head_dim, zero columns to the op's next
routable head_dim); that call is held to the plain attention on the
unpadded tensors, whose v is narrower than q and k, and to JAX's
``full_attention``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_ref, flash_attention, ops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

ARCH = "deepseek-v2-236b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
S, CAP = 12, 20


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype))


def _close(out, ref, dtype, msg=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def _x(rng, shape, dtype):
    tx = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(tx.float().numpy()).astype(dtype), tx


@pytest.mark.parametrize("reduced", [True, False])
def test_mla_layouts_match_jax(reduced):
    j, t = jax_config(ARCH, reduced), get_config(ARCH, reduced)
    jl = dict(tcommon.tree_leaves(jattn.attention_layout(j)))
    tl = dict(tcommon.tree_leaves(tattn.attention_layout(t)))
    assert list(jl) == list(tl) == sorted(["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                                           "wk_b", "wv_b", "wo"])
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    for batch, seq in ((2, 40), (1, 4128)):
        jc = jattn.attention_cache_layout(j, batch, seq, False)
        tc = tattn.attention_cache_layout(t, batch, seq, False)
        assert {k: (d.shape, d.axes, d.init) for k, d in jc.items()} == \
            {k: (d.shape, d.axes, d.init) for k, d in tc.items()}
        assert "pos" not in tc


def test_flash_head_dim_pads_to_a_routable_width():
    """The op's ``kernel_widths`` pads MLA's widths to a tile that exists:
    (192, 128) to one width of 256 in float32 and under grad, natively in
    bf16 inference; the REDUCED (24, 16) to 32."""
    a = get_config(ARCH).attention
    qk, dv = a.qk_nope_dim + a.qk_rope_dim, a.v_head_dim
    assert ops.kernel_widths(torch.float32, qk, dv) == (256, 256)       # 192 and 128
    assert ops.kernel_widths(torch.bfloat16, qk, dv, grad=True) == (256, 256)
    assert ops.kernel_widths(torch.float32, dv) == (128, 128)
    r = get_config(ARCH, reduced=True).attention
    assert ops.kernel_widths(torch.bfloat16, r.qk_nope_dim + r.qk_rope_dim,
                             r.v_head_dim) == (32, 32)
    assert ops.kernel_widths(torch.float32, 16) == (16, 16)
    # past the widest tile: the wide kernels at the widths as they come
    assert ops.kernel_widths(torch.bfloat16, 300) == (300, 300)
    assert ops.kernel_widths(torch.float32, 576, 512, grad=True) == (576, 512)
    for d in (16, 24, 100, 192, 256):
        assert ops.route(torch.bfloat16, *ops.kernel_widths(torch.float32, d)) == \
            ops.TENSOR_CORE
    # the padding serves float32 and grad; bf16 inference reaches the (192, 128) tile
    assert ops.route(torch.bfloat16, qk, dv) == ops.TENSOR_CORE
    assert ops.kernel_widths(torch.bfloat16, qk, dv) == (qk, dv)
    assert ops.kernel_widths(torch.float32, qk, qk) == (256, 256)
    assert ops.kernel_widths(torch.bfloat16, qk, dv, grad=True) != (qk, dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_prefill_cache_and_decode(dtype):
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    jp = jcommon.init_params(jax.random.PRNGKey(3), jattn.mla_layout(jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jx, tx = _x(rng, (2, S, 64), dtype)
    pos = np.arange(S)[None, :]
    jy, jc = jattn.mla_apply(jp, jx, jcfg, positions=jnp.asarray(pos), return_state=True,
                             cache_capacity=CAP)
    ty, tc = tattn.attention_apply(tp, tx, tcfg, positions=torch.from_numpy(pos),
                                   is_local=False, return_state=True, cache_capacity=CAP)
    assert ty.dtype == tx.dtype
    _close(ty, jy, dtype, "prefill")
    assert sorted(tc) == ["c_kv", "k_rope"]
    for key in tc:
        assert tc[key].shape == jc[key].shape and tc[key].dtype == tx.dtype
        _close(tc[key], jc[key], dtype, f"cache {key}")
        assert not tc[key][:, S:].any()                   # padded with zeros
    for step in range(3):
        jxd, txd = _x(rng, (2, 1, 64), dtype)
        cp = np.array([S + step, S + 2 * step], np.int32)   # rows at their own positions
        jy, jc = jattn.mla_apply(jp, jxd, jcfg, positions=jnp.asarray(cp)[:, None], cache=jc,
                                 cache_pos=jnp.asarray(cp))
        ty, tc2 = tattn.attention_apply(tp, txd, tcfg, positions=torch.from_numpy(cp)[:, None],
                                        is_local=False, cache=tc,
                                        cache_pos=torch.from_numpy(cp))
        assert tc2 is tc                                   # written in place
        _close(ty, jy, dtype, f"decode {step}")
        for key in tc:
            _close(tc[key], jc[key], dtype, f"decode {step} cache {key}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_flash_call_equals_unpadded_attention(dtype):
    """Zero columns add exactly 0 to every score: the padded call, cut to
    v_head_dim, is the plain attention on the unpadded q, k (192-wide at
    full width) and v (128), and JAX's ``full_attention`` with v padded to
    q's width (it takes one head_dim), cut back."""
    r = get_config(ARCH, reduced=True).attention
    qk, dv = r.qk_nope_dim + r.qk_rope_dim, r.v_head_dim
    hd = ops.kernel_widths(torch.float32, qk)[0]
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    q, k = (torch.from_numpy(rng.standard_normal((2, 40, 4, qk)).astype(np.float32)).to(dt)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 40, 4, dv)).astype(np.float32)).to(dt)
    scale = 1.0 / math.sqrt(qk)
    pad = lambda t: torch.nn.functional.pad(t, (0, hd - t.shape[-1]))  # noqa: E731
    out = flash_attention(pad(q), pad(k), pad(v), causal=True, scale=scale)
    assert out.shape[-1] == hd and not out[..., dv:].any()
    plain = attention_ref(q, k, v, causal=True, scale=scale)
    assert plain.shape[-1] == dv
    tol = 1e-6 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(out[..., :dv].float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (q, k, pad(v)[..., :qk]))
    ref = jattn.full_attention(jq, jk, jv, causal=True, scale=scale, q_chunk=8, kv_chunk=8)
    _close(out[..., :dv], np.asarray(ref, np.float32)[..., :dv], dtype, "full_attention")
