"""The flash op at every width up to 256, against the JAX package, on the CPU.

The op takes any 1 <= D, Dv <= 256 in both dtypes, forward and backward.
On a card (or the dry run's fake tensors) it pads q, k, v with zero
columns to the widths ``ops.kernel_widths`` names (the rule the models
applied before: bf16 inference at a pair of ``TC_HEAD_DIM_PAIRS`` at its
own widths, every other call at the least of ``TC_HEAD_DIMS`` that holds
the wider) and cuts the output and each gradient back; on the CPU its
plain version takes the widths as they come.  Held here:

* the op at (24, 16) (deepseek-v2's REDUCED MLA), (48, 48), (96, 96) and
  (112, 64) against the JAX package's ``attention_ref`` and
  ``full_attention`` (float32 2e-5, bf16 2e-2), at the CPU's widths and
  along the card's route (``ops._at_kernel_widths`` forced on, so the op
  pads and cuts exactly as on a card, the plain version standing in for
  the kernels), with the row stats;
* (80, 80) and (192, 128) under grad in both dtypes, both routes, against
  ``jax.vjp`` of ``full_attention`` (v padded for JAX, which takes one
  head_dim, and cut);
* ``kernel_widths`` for every (dtype, D, Dv, grad) a config of the repo
  produces, equal to the rule the models' ``_padded_flash`` applied (a copy
  kept here);
* fake tensors: the op accepts those widths and ``op_cost`` reports the
  padded kernel's work; above 256 the wide kernels' work at the widths as
  they come (``tests/test_torch_flash_wide.py`` holds that route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import full_attention
from repro_torch.analysis import op_cost
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd, ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CHUNK = 16

FORWARD_CASES = {
    # B, S, KV, G, D, Dv, causal
    "mla_reduced": (2, 48, 2, 2, 24, 16, True),
    "d48": (1, 64, 2, 1, 48, 48, True),
    "d96": (1, 48, 1, 3, 96, 96, False),
    "d112_v64": (2, 32, 2, 2, 112, 64, True),
}
GRAD_CASES = {
    "d80": (1, 64, 2, 2, 80, 80, True),
    "mla": (1, 48, 2, 1, 192, 128, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["cpu_widths", "card_route"])
def route(request, monkeypatch):
    """The CPU's widths, or the card's route: padding to ``kernel_widths``
    and the cut, with the plain version in the kernels' place."""
    if request.param == "card_route":
        monkeypatch.setattr(ops, "_at_kernel_widths", lambda t: True)
    return request.param


def _inputs(b, s, kv, g, d, dv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, kv * g, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv, dv), np.float32),
            rng.standard_normal((b, s, kv * g, dv), np.float32)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return t, [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]


def _close(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale, err_msg=what)


def _full_attention(q, k, v, g, dv, **kw):
    """JAX's ``full_attention`` (one head_dim) with v padded to q's width
    and the output cut back; k, v GQA-repeated."""
    if g > 1:
        k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    d = q.shape[-1]
    if dv < d:
        v = jnp.pad(v, ((0, 0),) * 3 + ((0, d - dv),))
    elif dv > d:
        q, k = (jnp.pad(x, ((0, 0),) * 3 + ((0, dv - d),)) for x in (q, k))
    return full_attention(q, k, v, q_chunk=CHUNK, kv_chunk=CHUNK, **kw)[..., :dv]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_forward_at_any_width_matches_jax(name, dtype, route):
    b, s, kv, g, d, dv, causal = FORWARD_CASES[name]
    (q, k, v, _), (jq, jk, jv, _) = _inputs(b, s, kv, g, d, dv, dtype)
    scale = d ** -0.5
    out = flash_attention(q, k, v, causal=causal)          # the scale of the unpadded D
    assert out.shape == (b, s, kv * g, dv) and out.dtype == q.dtype
    ref = jax_attention_ref(jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2),
                            causal=causal, scale=scale)
    _close(out, ref, dtype, "attention_ref")
    _close(out, _full_attention(jq, jk, jv, g, dv, causal=causal, scale=scale), dtype,
           "full_attention")
    o2, m, l = flash_attention_fwd(q, k, v, causal=causal)
    assert torch.equal(o2, out) and m.shape == l.shape == (b, kv * g, s)
    if route == "card_route":       # zero columns leave the row stats as they are
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "_at_kernel_widths", lambda t: False)
            _, m0, l0 = flash_attention_fwd(q, k, v, causal=causal)
        torch.testing.assert_close(m, m0, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(l, l0, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_backward_at_native_pairs_matches_jax_vjp(name, dtype, route):
    """Under grad the card pads (80, 80) to 128 and (192, 128) to 256 (no
    backward tile at those pairs); the Function cuts dq, dk, dv back."""
    b, s, kv, g, d, dv, causal = GRAD_CASES[name]
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(b, s, kv, g, d, dv, dtype, seed=3)
    scale = d ** -0.5
    jout, vjp = jax.vjp(lambda *x: _full_attention(*x, g, dv, causal=causal, scale=scale),
                        jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, q_chunk=CHUNK, kv_chunk=CHUNK)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    _close(out.detach(), jout, dtype, "out")
    for what, t, want in (("dq", q, jdq), ("dk", k, jdk), ("dv", v, jdv)):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype, what
        _close(t.grad, want, dtype, what)


def _old_padded_flash_rule(dtype, d, dv, grad):
    """The widths the models' ``attention._padded_flash`` handed the op
    before the op took every width (its ``_native_widths`` and
    ``_flash_head_dim``)."""
    if dtype == torch.bfloat16 and not grad and (d, dv) in ops.TC_HEAD_DIM_PAIRS:
        return d, dv
    hd = next((t for t in ops.TC_HEAD_DIMS if t >= max(d, dv)), max(d, dv))
    return hd, hd


def _config_widths():
    out = set()
    for name in ARCH_NAMES:
        for reduced in (False, True):
            a = get_config(name, reduced=reduced).attention
            if a is None:
                continue
            out.add((a.qk_nope_dim + a.qk_rope_dim, a.v_head_dim) if a.kind == "mla"
                    else (a.head_dim, a.head_dim))
    return sorted(out)


def test_kernel_widths_are_the_models_old_rule_at_every_config():
    widths = _config_widths()
    assert {(192, 128), (24, 16), (80, 80), (256, 256), (16, 16)} <= set(widths)
    for d, dv in widths:
        for dtype in (torch.float32, torch.bfloat16):
            for grad in (False, True):
                got = ops.kernel_widths(dtype, d, dv, grad)
                assert got == _old_padded_flash_rule(dtype, d, dv, grad), (dtype, d, dv, grad)
                # every width the rule names is a tile that exists
                assert (ops.bwd_route if grad else ops.route)(dtype, *got)


def test_fake_tensors_take_every_width_and_report_the_padded_kernel():
    b, s, h = 1, 64, 4
    kept = b * h * ops.kept_scores(s, s, True, None)
    with FakeTensorMode():
        for d, dv in ((24, 16), (48, 48), (96, 96), (112, 64), (80, 80), (192, 128), (1, 1),
                      (256, 200)):
            for dtype in (torch.float32, torch.bfloat16):
                for grad in (False, True):
                    q = torch.empty((b, s, h, d), dtype=dtype, requires_grad=grad)
                    k = torch.empty((b, s, h, d), dtype=dtype)
                    v = torch.empty((b, s, h, dv), dtype=dtype)
                    cost = op_cost.analyze(lambda: flash_attention(q, k, v))
                    kd, kdv = ops.kernel_widths(dtype, d, dv, grad)
                    assert cost.flops_by_name["flash_attention_fwd"] == 2 * (kd + kdv) * kept
                    out = flash_attention(q, k, v)
                    assert out.shape == (b, s, h, dv)
        # past 256: the wide kernels, at the widths as they come, and their own work
        for d, dv in ((320, 320), (257, 257), (64, 300)):
            x = torch.empty((b, s, h, d), dtype=torch.bfloat16)
            v = torch.empty((b, s, h, dv), dtype=torch.bfloat16)
            assert ops.kernel_widths(torch.bfloat16, d, dv) == (d, dv)
            cost = op_cost.analyze(lambda: flash_attention(x, x, v))
            assert cost.flops_by_name["flash_attention_fwd"] == \
                2 * (d * -(-dv // 256) + dv) * kept
            assert flash_attention(x, x, v).shape == (b, s, h, dv)
