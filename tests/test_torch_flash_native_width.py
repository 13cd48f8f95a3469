"""B2's bf16 forward at its native widths, against the JAX package, on the CPU.

The op takes q, k of head_dim D and v of its own width Dv, and returns
[B, Sq, H, Dv], as the Pallas kernel does (its ``acc`` and output are Dv
wide).  The tensor-core forward has a tile a (D, Dv) pair
(``ops.TC_HEAD_DIM_PAIRS``): besides 16–256 at one width, heads of 80
(zamba2's shared block, hubert) and MLA's 192 / 128 (deepseek-v2).  Held
here:

* the op with Dv != D and at D = 80, on CPU tensors (its plain version),
  against the JAX package's ``attention_ref`` (k, v GQA-repeated with numpy)
  and the model's ``full_attention``: float32 within 2e-5, bf16 within
  2e-2; causal, non-causal, window and softcap, ragged Sq and Sk, G > 1;
  the row stats and the autograd Function at Dv != D;
* the host side of the kernel: ``tma_map_args`` for q, k at 192 beside v at
  128 and for an 80-wide fused-projection half, ``route`` and
  ``bwd_route`` over the pair table, ``op_cost`` at native widths;
* the new tiles' shared memory and register pool, from the constants of
  ``csrc/flash_attention_wgmma.cu``;
* the op's width rule (``ops.kernel_widths``): bf16 without grad runs at
  its own widths, float32 and grad-requiring calls padded as before; and
  ``mla_apply``, zamba2's shared block and hubert's encoder in bf16 at
  REDUCED size (heads at their full widths) against JAX.

The kernel itself runs only on the card (``chip_smoke.py`` phases 5, 16
and 17 hold it against the plain version there).
"""

import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.attention import full_attention
from repro_torch.analysis import op_cost
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention, ops
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CSRC = Path(ops.__file__).resolve().parent / "csrc"
SOURCE = (CSRC / "flash_attention_wgmma.cu").read_text()

CASES = {
    # B, Sq, Sk, KV, G, D, Dv, causal, window, softcap
    "mla_gqa": (1, 96, 96, 2, 2, 192, 128, True, None, None),
    "mla_ragged_window": (2, 77, 77, 1, 1, 192, 128, True, 16, None),
    "mla_softcap": (1, 64, 64, 2, 1, 192, 128, True, None, 30.0),
    "mla_sq_ne_sk": (1, 33, 90, 1, 2, 192, 128, False, None, None),
    "d80_causal": (2, 50, 50, 4, 1, 80, 80, True, None, None),
    "d80_noncausal_g3": (1, 70, 70, 2, 3, 80, 80, False, None, None),
    "d80_sq_ne_sk": (1, 45, 101, 2, 2, 80, 80, False, None, None),
    "d80_window_softcap": (1, 60, 60, 2, 2, 80, 80, True, 20, 20.0),
    "v_wider": (1, 40, 40, 1, 2, 32, 48, True, None, None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _const(name: str) -> int:
    match = re.search(rf"^constexpr int {name} = (\d+);", SOURCE, re.M)
    assert match, name
    return int(match[1])


def _arrays(b, sq, sk, kv, g, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, kv * g, d), np.float32),
            rng.standard_normal((b, sk, kv, d), np.float32),
            rng.standard_normal((b, sk, kv, dv), np.float32))


def _both(arrays, dtype):
    """The same values in both packages, rounded once to ``dtype``."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    j = [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_op_at_native_widths_matches_jax(name, dtype):
    b, sq, sk, kv, g, d, dv, causal, window, cap = CASES[name]
    (q, k, v), (jq, jk, jv) = _both(_arrays(b, sq, sk, kv, g, d, dv), dtype)
    scale = 1.0 / math.sqrt(d)
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap, scale=scale)
    assert out.shape == (b, sq, kv * g, dv) and out.dtype == q.dtype
    jk_rep, jv_rep = jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2)
    refs = {"attention_ref": jax_attention_ref(jq, jk_rep, jv_rep, causal=causal, window=window,
                                               softcap=cap, scale=scale)}
    if sq == sk:
        refs["full_attention"] = full_attention(jq, jk_rep, jv_rep, causal=causal, scale=scale,
                                                cap=cap, window=window, q_chunk=sq, kv_chunk=sk)
    for what, ref in refs.items():
        assert ref.shape == out.shape, what
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype], err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_stats_do_not_depend_on_v(dtype):
    """``flash_attention_fwd`` at Dv != D: out [B, Sq, H, Dv]; m and l are
    the scores' alone, so v of 128 and v padded to 192 give the same bits."""
    (q, k, v), _ = _both(_arrays(1, 64, 64, 2, 2, 192, 128, seed=1), dtype)
    out, m, l = ops.flash_attention_fwd(q, k, v, window=24)
    wide, wm, wl = ops.flash_attention_fwd(q, k, torch.nn.functional.pad(v, (0, 64)), window=24)
    assert out.shape == (1, 64, 4, 128) and m.shape == l.shape == (1, 4, 64)
    assert torch.equal(m, wm) and torch.equal(l, wl)
    assert torch.equal(out, wide[..., :128]) and not wide[..., 128:].any()


def test_backward_at_dv_ne_d_matches_jax_vjp():
    """``FlashAttention`` forward and its CPU backward at q, k of 192 and v
    of 128 against ``jax.vjp(full_attention)`` (float32)."""
    b, s, kv, g, d, dv = 1, 48, 1, 2, 192, 128
    rng = np.random.default_rng(2)
    (q, k, v, do), (jq, jk, jv, jdo) = _both(
        (*_arrays(b, s, s, kv, g, d, dv, seed=2),
         rng.standard_normal((b, s, kv * g, dv), np.float32)), "float32")
    scale = 1.0 / math.sqrt(d)

    def f(q_, k_, v_):
        return full_attention(q_, jnp.repeat(k_, g, axis=2), jnp.repeat(v_, g, axis=2),
                              causal=True, scale=scale, q_chunk=16, kv_chunk=16)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    grads = vjp(jdo)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=True, scale=scale, q_chunk=16, kv_chunk=16)
    assert isinstance(out.grad_fn, ops.FlashAttention._backward_cls)
    out.backward(do)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    for what, t, want in zip(("dq", "dk", "dv"), (q, k, v), grads):
        assert t.grad.shape == t.shape, what
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=what)


def test_check_takes_v_of_its_own_width_and_refuses_other_leading_axes():
    q, k = torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 1, 32)
    assert flash_attention(q, k, torch.zeros(1, 8, 1, 16)).shape == (1, 8, 2, 16)
    for bad in (torch.zeros(1, 9, 1, 16), torch.zeros(1, 8, 2, 16), torch.zeros(2, 8, 1, 16),
                torch.zeros(8, 1, 16)):
        with pytest.raises(ValueError, match=r"v \[B,Sk,KV,Dv\]|same batch"):
            flash_attention(q, k, bad)


# --- the kernel's host side ----------------------------------------------------------


def test_tma_maps_of_mla_q_k_at_192_beside_v_at_128():
    """MLA's q and k at 192 take three 64-column boxes at the 128-byte
    swizzle and v at 128 two; here k and v are the two column slices of one
    [B, S, KV, 320] buffer, as strided views."""
    b, s, h = 2, 256, 4
    q = torch.empty(b, s, h, 192, dtype=torch.bfloat16)
    buf = torch.empty(b, s, h, 320, dtype=torch.bfloat16)
    k, v = buf[..., :192], buf[..., 192:]
    rows = ops.kv_box_rows(192, 128)
    assert rows == ops.kv_box_rows(192) == 64
    mq, mk, mv = (ops.tma_map_args(q, ops.Q_BOX_ROWS), ops.tma_map_args(k, rows),
                  ops.tma_map_args(v, rows))
    assert mq.dims == (192, s, h, b) and mq.box == (64, 64, 1, 1) and mq.swizzle == 128
    assert mq.strides == (h * 192 * 2, 192 * 2, s * h * 192 * 2)
    assert mk.dims == (192, s, h, b) and mk.box == (64, 64, 1, 1) and mk.swizzle == 128
    assert mv.dims == (128, s, h, b) and mv.box == (64, 64, 1, 1) and mv.swizzle == 128
    assert mk.strides == mv.strides == (h * 320 * 2, 320 * 2, s * h * 320 * 2)
    assert (v.data_ptr() - k.data_ptr()) % 16 == 0
    assert list(mv.as_c()) == [128, s, h, b, 2560, 640, 655360, 64, 64, 1, 1, 128]


def test_tma_maps_of_an_80_wide_fused_projection_half():
    """Heads of 80: 160 bytes a row, five 16-column boxes at the 32-byte
    swizzle; k and v as the halves of one [B, S, 2, KV, 80] projection."""
    b, s, kv = 2, 100, 4
    packed = torch.empty(b, s, 2, kv, 80, dtype=torch.bfloat16)
    rows = ops.kv_box_rows(80, 80)
    assert rows == 64 and ops.box_columns(80) == 16
    for half in (0, 1):
        m = ops.tma_map_args(packed[:, :, half], rows)
        assert m.dims == (80, s, kv, b) and m.box == (16, 64, 1, 1) and m.swizzle == 32
        assert m.strides == (2 * kv * 160, 160, s * 2 * kv * 160) == (1280, 160, 128000)
    mq = ops.tma_map_args(torch.empty(b, s, 8, 80, dtype=torch.bfloat16), ops.Q_BOX_ROWS)
    assert mq.box == (16, 64, 1, 1) and mq.swizzle == 32 and mq.strides[:2] == (1280, 160)


def test_tma_map_refusals_at_the_new_widths():
    buf = torch.empty(1, 64, 2, 84, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="the head stride is 168 bytes"):
        ops.tma_map_args(buf[..., :80], 128)
    wide = torch.empty(1, 64, 2, 88, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned base address"):
        ops.tma_map_args(wide[..., 4:84], 128)
    for width in (48, 96, 112, 160):
        with pytest.raises(ValueError, match="head_dim in"):
            ops.tma_map_args(torch.empty(1, 8, 1, width, dtype=torch.bfloat16), 128)
    assert ops.TMA_WIDTHS == (16, 32, 64, 80, 128, 192, 256)
    assert {w: ops.box_columns(w) for w in ops.TMA_WIDTHS} == {
        16: 16, 32: 32, 64: 64, 80: 16, 128: 64, 192: 64, 256: 64}


@pytest.mark.parametrize("pair", ops.TC_HEAD_DIM_PAIRS)
def test_route_takes_every_pair_of_the_table(pair):
    assert ops.route(torch.bfloat16, *pair) == ops.TENSOR_CORE
    if pair[0] == pair[1] and pair[0] in ops.TC_HEAD_DIMS:
        assert ops.bwd_route(torch.bfloat16, *pair) == ops.TENSOR_CORE_BWD
    else:                                   # (80, 80) and (192, 128): the forward only
        with pytest.raises(ValueError, match="backward kernel takes one head_dim"):
            ops.bwd_route(torch.bfloat16, *pair)


@pytest.mark.parametrize("pair", [(128, 192), (80, 64), (64, 80), (192, 192), (96, 96),
                                  (80, 128), (192, 64), (256, 128)])
def test_route_refuses_pairs_outside_the_table(pair):
    with pytest.raises(ValueError, match="head_dim in"):
        ops.route(torch.bfloat16, *pair)
    with pytest.raises(ValueError, match="head_dim in"):
        ops.bwd_route(torch.bfloat16, *pair)


def test_float32_routes_one_width_only():
    assert ops.route(torch.float32, 80) == ops.route(torch.float32, 80, 80) == ops.CUDA_CORE
    assert ops.bwd_route(torch.float32, 80, 80) == ops.CUDA_CORE_BWD
    for pair in ((192, 128), (80, 64)):
        with pytest.raises(ValueError, match="one head_dim <= 256"):
            ops.route(torch.float32, *pair)
        with pytest.raises(ValueError, match="one head_dim <= 256"):
            ops.bwd_route(torch.float32, *pair)


def test_fake_tensors_route_as_card_tensors():
    """The dry run's fake tensors: the (192, 128) and (80, 80) forwards pass
    and report 2·(D + Dv) a kept score; a grad-requiring call at such a pair
    and a float32 Dv != D pass too, padded to one width of 256 (the op's
    ``kernel_widths``), and report the padded kernel's work; a width past
    256 takes the wide kernels at its own widths, forward and backward, and
    reports their work (``ops.wide_flops_per_score``)."""
    with FakeTensorMode():
        q = torch.empty((2, 256, 16, 192), dtype=torch.bfloat16)
        k = torch.empty((2, 256, 16, 192), dtype=torch.bfloat16)
        v = torch.empty((2, 256, 16, 128), dtype=torch.bfloat16)
        cost = op_cost.analyze(lambda: flash_attention(q, k, v, causal=True))
        kept = 2 * 16 * 256 * 257 // 2
        assert cost.flops == 2 * (192 + 128) * kept
        assert cost.bytes == 2 * (2 * q.numel() + v.numel() + 2 * 256 * 16 * 128)
        x = torch.empty((1, 64, 2, 80), dtype=torch.bfloat16)
        assert flash_attention(x, x, x).shape == x.shape
        padded = 2 * (256 + 256) * kept
        for grad, dt in ((True, torch.bfloat16), (False, torch.float32)):
            qq = q.to(dt).detach().requires_grad_(grad)
            cost = op_cost.analyze(lambda: flash_attention(qq, k.to(dt), v.to(dt)))
            assert cost.flops_by_name["flash_attention_fwd"] == padded
        wide = torch.empty((2, 256, 16, 320), dtype=torch.bfloat16)
        for grad, dt in ((True, torch.bfloat16), (False, torch.float32)):
            w = wide.to(dt).detach().requires_grad_(grad)

            def call():
                out = flash_attention(w, wide.to(dt), wide.to(dt))
                assert out.shape == wide.shape
                if grad:
                    out.sum().backward()
            cost = op_cost.analyze(call)
            assert cost.flops_by_name["flash_attention_fwd"] == \
                ops.wide_flops_per_score(320, 320, False) * kept
            if grad:
                assert cost.flops_by_name["flash_attention_bwd"] == \
                    ops.wide_flops_per_score(320, 320, True) * kept


@pytest.mark.parametrize("d, dv", [(192, 128), (80, 80)])
def test_op_cost_counts_useful_work_at_native_widths(d, dv):
    """2·(D + Dv) a kept score, q, k, v read once and the [B, Sq, H, Dv]
    output written once, on CPU tensors."""
    b, s, kv, g = 1, 40, 2, 2
    q, k, v = (torch.zeros(shape) for shape in ((b, s, kv * g, d), (b, s, kv, d),
                                                 (b, s, kv, dv)))
    cost = op_cost.analyze(lambda: flash_attention(q, k, v, causal=True, window=12))
    kept = b * kv * g * ops.kept_scores(s, s, True, 12)
    assert cost.flops == 2 * (d + dv) * kept and cost.transcendentals == kept
    assert cost.bytes == 4 * (q.numel() + k.numel() + v.numel() + b * s * kv * g * dv)


# --- the tiles, from the source's constants ----------------------------------------


def _tile(d, dv, cap=False):
    """``Tile<D, Dv, kCap>`` of the source, from its design constants."""
    wg = (_const("kWarpgroups80") if d == 80
          else _const("kWarpgroups192Cap" if cap else "kWarpgroups192") if d == 192
          else _const("kNarrowWarpgroups") if dv <= 64 else _const("kWideWarpgroups"))
    regs = (_const("kNarrowRegs") if wg == _const("kNarrowWarpgroups")
            else _const("kWidestRegs") if dv == 256 else _const("kWideRegs"))
    bk = (_const("kKeys80") if d == 80 else _const("kKeys192") if d == 192
          else _const("kWideKeys") if d >= 128 else _const("kNarrowKeys"))
    ring = _const("kStages256") if d == 256 else _const("kStages")
    smem = wg * 64 * d * 2 + ring * (bk * d * 2 + bk * dv * 2) + 128 + 1024
    return dict(wg=wg, regs=regs, bk=bk, ring=ring, smem=smem)


@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("pair", ops.TC_HEAD_DIM_PAIRS)
def test_tiles_fit_shared_memory_and_the_register_file(pair, cap):
    t = _tile(*pair, cap)
    assert t["smem"] <= _const("kSmemOptIn") == 232448
    pool = 128 * t["wg"] * t["regs"] + 128 * _const("kProducerRegs")
    assert pool <= _const("kRegisterFile") == 65536
    assert t["bk"] == ops.kv_box_rows(*pair)
    for width in pair:
        assert width % 16 == 0 and (width // ops.box_columns(width)) * ops.box_columns(width) \
            == width


def test_the_new_tiles_geometry():
    """(80, 80) and (192, 128): three warpgroups at 160 registers on 64-key
    tiles, three ring stages; (192, 128) with the softcap D = 128's two
    warpgroups at 232, 2 × 24 KB of Q and 3 × (24 + 16) KB of K and V."""
    mla, mla_cap, d80 = _tile(192, 128), _tile(192, 128, True), _tile(80, 80)
    assert (mla["wg"], mla["regs"], mla["bk"], mla["ring"]) == (3, 160, 64, 3)
    assert mla["smem"] == 3 * 24576 + 3 * (24576 + 16384) + 1152 == 197760
    assert (mla_cap["wg"], mla_cap["regs"], mla_cap["bk"]) == (2, 232, 64)
    assert mla_cap["smem"] == 2 * 24576 + 3 * (24576 + 16384) + 1152 == 173184
    assert (d80["wg"], d80["regs"], d80["bk"], d80["ring"]) == (3, 160, 64, 3)
    assert d80["smem"] == _tile(80, 80, True)["smem"] == 3 * 10240 + 3 * 2 * 10240 + 1152
    assert _tile(256, 256)["smem"] == 2 * 32768 + 2 * 2 * 16384 * 2 + 1152
    for d in (16, 32, 64, 128, 256):      # the earlier tiles, as they were
        assert _tile(d, d) == _tile(d, d, True)
        assert _tile(d, d)["wg"] == (3 if d <= 64 else 2)
        assert _tile(d, d)["bk"] == (128 if d <= 64 else 64)


def test_source_pairs_are_the_ops_table():
    """``with_tile`` in the source lists the pairs ``ops.TC_HEAD_DIM_PAIRS``
    names, and ``issue_pv`` has an n-width for each Dv."""
    pairs = tuple((int(a), int(b)) for a, b in
                  re.findall(r"if \(d == (\d+) && dv == (\d+)\) return f\(Pair<", SOURCE))
    assert pairs == ops.TC_HEAD_DIM_PAIRS
    for dv in {p[1] for p in pairs}:
        assert re.search(rf"Dv == {dv}\) wgmma_rs_n{dv}\(", SOURCE) or dv == 256
    header = (CSRC / "tensor_core.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16" in header


# --- the models' call ---------------------------------------------------------------


def _spy(monkeypatch):
    calls, real = [], tattn.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("dtype, grad, want", [
    ("bfloat16", False, {"d80": (80, 80), "mla": (192, 128)}),
    ("bfloat16", True, {"d80": (128, 128), "mla": (256, 256)}),
    ("float32", False, {"d80": (128, 128), "mla": (256, 256)}),
])
def test_padded_flash_passes_native_widths_in_bf16_inference(monkeypatch, dtype, grad, want):
    """The models hand the op q, k, v at their own widths; the op's
    ``kernel_widths`` names the tile a card runs: native in bf16
    inference, one padded width in float32 and under grad."""
    calls = _spy(monkeypatch)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt) \
            .requires_grad_(grad)

    out = tattn._padded_flash([t(1, 24, 2, 80)], [t(1, 24, 2, 80)], t(1, 24, 2, 80),
                              causal=True, scale=80 ** -0.5)
    assert out.shape == (1, 24, 2, 80)
    q_nope, q_rope, k_nope = t(1, 24, 2, 128), t(1, 24, 2, 64), t(1, 24, 2, 128)
    k_rope, v = t(1, 24, 1, 64), t(1, 24, 2, 128)
    out = tattn._padded_flash([q_nope, q_rope], [k_nope, k_rope], v, causal=True,
                              scale=192 ** -0.5)
    assert out.shape == (1, 24, 2, 128)
    assert calls == [(80, 80, 80), (192, 192, 128)]
    assert [ops.kernel_widths(dt, d, dv, grad) for d, _, dv in calls] == [want["d80"],
                                                                        want["mla"]]
    if grad:
        out.float().sum().backward()
        assert q_rope.grad is not None and k_rope.grad.shape == k_rope.shape


def test_native_and_padded_calls_agree(monkeypatch):
    """The rule changes which widths reach the op, not the function: the
    bf16 call at 80 (native) against the same call padded to 128, and
    MLA's (192, 128) against 256."""
    from repro_torch.kernels.flash_attention import attention_ref

    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    for d, dv in ((80, 80), (192, 128)):
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(bf)
                   for s in ((1, 40, 2, d), (1, 40, 2, d), (1, 40, 2, dv)))
        native = tattn._padded_flash([q], [k], v, causal=True, scale=d ** -0.5)
        hd = ops.kernel_widths(bf, d, dv, grad=True)[0]
        pad = lambda x: torch.nn.functional.pad(x, (0, hd - x.shape[-1]))  # noqa: E731
        padded = flash_attention(pad(q), pad(k), pad(v), causal=True, scale=d ** -0.5)
        plain = attention_ref(q, k, v, causal=True, scale=d ** -0.5)
        assert torch.equal(native, padded[..., :dv])
        np.testing.assert_allclose(native.float().numpy(), plain.float().numpy(),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def _full_width_mla_cfgs(dtype):
    """deepseek-v2 REDUCED in depth and model width, its MLA heads at full
    width (q, k of 128 + 64, v of 128)."""
    full = get_config("deepseek-v2-236b").attention
    widths = dict(qk_nope_dim=full.qk_nope_dim, qk_rope_dim=full.qk_rope_dim,
                  v_head_dim=full.v_head_dim)
    out = []
    for cfg in (jax_config("deepseek-v2-236b", reduced=True),
                get_config("deepseek-v2-236b", reduced=True)):
        out.append(dataclasses.replace(cfg, dtype=dtype,
                                       attention=dataclasses.replace(cfg.attention, **widths)))
    return out


def test_mla_apply_bf16_at_full_head_widths_matches_jax(monkeypatch):
    """``mla_apply`` prefill in bf16 with 192 / 128 heads reaches the op at
    (192, 128), unpadded, and matches JAX's ``mla_apply`` within 2e-2."""
    jcfg, tcfg = _full_width_mla_cfgs("bfloat16")
    assert (tcfg.attention.qk_nope_dim + tcfg.attention.qk_rope_dim,
            tcfg.attention.v_head_dim) == (192, 128)
    calls = _spy(monkeypatch)
    jp = jcommon.init_params(jax.random.PRNGKey(3), jattn.mla_layout(jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    s = 24
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, s, jcfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype("bfloat16")
    pos = np.arange(s)[None, :]
    with jax.disable_jit():
        jy, _ = jattn.mla_apply(jp, jx, jcfg, positions=jnp.asarray(pos))
    ty, _ = tattn.attention_apply(tp, x, tcfg, positions=torch.from_numpy(pos), is_local=False)
    assert calls == [(192, 192, 128)]
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def _head80(cfg, dtype):
    return dataclasses.replace(cfg, dtype=dtype,
                               attention=dataclasses.replace(cfg.attention, head_dim=80))


def test_zamba2_shared_block_bf16_prefill_at_80_matches_jax(monkeypatch):
    """zamba2 REDUCED with its shared block's heads at the full 80, bf16,
    each block held on JAX's input (``BlockInputs``): the shared block's two
    prefill calls reach the op at (80, 80), causal."""
    from repro.models import transformer as jtf
    from repro_torch import convert
    from repro_torch.models import transformer as ttf
    from test_torch_mamba2 import BlockInputs

    jcfg, tcfg = (_head80(c, "bfloat16") for c in (jax_config("zamba2-2.7b", reduced=True),
                                                     get_config("zamba2-2.7b", reduced=True)))
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    blocks = BlockInputs(monkeypatch)
    calls = _spy(monkeypatch)
    with jax.disable_jit():
        jl, _, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, return_state=True,
                               cache_capacity=32)
    tl, _, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, return_state=True,
                           cache_capacity=32)
    assert "attention_apply" in blocks.check("prefill")
    assert calls and set(calls) == {(80, 80, 80)}
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def test_hubert_bf16_encoder_at_80_matches_jax(monkeypatch):
    """hubert REDUCED with its heads at the full 80, bf16 on ``features``:
    every layer's call reaches the op at (80, 80), non-causal, and the
    logits match JAX's (op by op) within 2e-2."""
    from repro.models import transformer as jtf
    from repro_torch import convert
    from repro_torch.models import transformer as ttf

    jcfg, tcfg = (_head80(c, "bfloat16") for c in (jax_config("hubert-xlarge", reduced=True),
                                                     get_config("hubert-xlarge", reduced=True)))
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    feats = np.random.default_rng(0).standard_normal((2, 32, tcfg.frontend_dim)) \
        .astype(np.float32)
    calls = _spy(monkeypatch)
    with jax.disable_jit():
        jl, _, _ = jtf.forward(jp, jcfg, {"features": jnp.asarray(feats)})
    tl, _, _ = ttf.forward(tp, tcfg, {"features": torch.from_numpy(feats)})
    assert calls == [(80, 80, 80)] * tcfg.n_layers
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
