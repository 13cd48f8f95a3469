"""The port's dense GQA model against the JAX package's, on the CPU.

Weights are initialised by the JAX package and carried over by
``convert.model_params_from_numpy``; inputs come from numpy seeds.  In
float32 both packages compute the same function with sums in other
orders, so logits agree to about 1e-6 and are held to 1e-4.  In bf16
each matmul output is rounded to bf16 (8 bits of mantissa) in both, and
prefill attention keeps p in fp32 in the port's op where the JAX XLA path
rounds it to bf16, so bf16 runs are held to 2e-2, the flash kernel's
bf16 tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import transformer as jtf
from repro_torch import configs, convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttf

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype="float32", **attn):
    """REDUCED llama3.2-1b in both packages, in ``dtype``, with optional
    attention overrides (windows, softcap, QK-norm, bias)."""
    out = []
    for cfg in (jax_config("llama3.2-1b", reduced=True),
                get_config("llama3.2-1b", reduced=True)):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        if attn:
            cfg = dataclasses.replace(
                cfg, attention=dataclasses.replace(cfg.attention, **attn))
        out.append(cfg)
    return out


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _close(out, ref, dtype, msg=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def test_configs_match_and_unported_archs_raise():
    """All ten architectures are ported: the registry matches the JAX
    package's (``NOT_PORTED`` is gone), and an unknown name raises."""
    assert ARCH_NAMES == ["llama3.2-1b", "falcon-mamba-7b", "gemma2-2b", "gemma3-27b",
                          "qwen3-moe-235b-a22b", "deepseek-v2-236b", "zamba2-2.7b",
                          "internvl2-1b", "hubert-xlarge", "llama3-405b"]
    assert not hasattr(configs, "NOT_PORTED")
    assert sorted(ARCH_NAMES) == sorted(JAX_ARCHS)
    for name in ARCH_NAMES:
        for reduced in (False, True):
            j, t = jax_config(name, reduced), get_config(name, reduced)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert t.padded_vocab == j.padded_vocab
            assert tbase.count_params(t) == jbase.count_params(j)
    assert get_config("llama3.2-1b").total_params() == pytest.approx(1.236e9, rel=1e-3)
    assert get_config("llama3-405b").total_params() == pytest.approx(405.8e9, rel=1e-2)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("reduced", [True, False])
def test_model_layout_matches_jax(reduced):
    """Every leaf path, shape, axes, init and scale (no weights allocated)."""
    j = jax_config("llama3.2-1b", reduced)
    t = get_config("llama3.2-1b", reduced)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    jc = dict(tcommon.tree_leaves(jtf.cache_layout(j, 2, 40)))
    tc = dict(tcommon.tree_leaves(ttf.cache_layout(t, 2, 40)))
    assert {p: d.shape for p, d in jc.items()} == {p: d.shape for p, d in tc.items()}


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_count_matches_jax(arch, reduced):
    """``common.param_count`` of every arch's layout, REDUCED and full size."""
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    want = jcommon.param_count(jtf.model_layout(j))
    assert tcommon.param_count(ttf.model_layout(t)) == want > 0


def test_model_params_from_numpy_checks_every_leaf():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jp)
    assert tp["slots"][0]["attn"]["wq"].shape == (2, 64, 4, 16)
    np.testing.assert_array_equal(tp["embed"].numpy(), tree["embed"])
    bad = dict(tree, final_norm=np.ones(65, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.model_params_from_numpy(bad, tcfg, "cpu")
    extra = dict(tree, lm_head=np.zeros((64, 512), np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        convert.model_params_from_numpy(extra, tcfg, "cpu")


def test_init_params_is_seeded():
    layout = ttf.model_layout(get_config("llama3.2-1b", reduced=True))
    a = tcommon.init_params(torch.Generator().manual_seed(0), layout)
    b = tcommon.init_params(torch.Generator().manual_seed(0), layout)
    for (pa, x), (pb, y) in zip(tcommon.tree_leaves(a), tcommon.tree_leaves(b)):
        assert pa == pb and torch.equal(x, y)
    assert torch.equal(a["final_norm"], torch.ones(64))
    assert a["embed"].std().item() == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_ffn_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 4, 16), np.float32)
    w = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(dtype)
    _close(tcommon.rms_norm(tx, torch.from_numpy(w), 1e-6),
           jcommon.rms_norm(jx, jnp.asarray(w), 1e-6), dtype, "rms_norm")
    pos = np.arange(12)[None, :] + 100
    _close(tcommon.apply_rope(tx, torch.from_numpy(pos), 500_000.0),
           jcommon.apply_rope(jx, jnp.asarray(pos), 500_000.0), dtype, "rope")
    jcfg, tcfg = _cfgs(dtype)
    wi = rng.standard_normal((64, 2, 128), np.float32) / 8
    wd = rng.standard_normal((128, 64), np.float32) / 11
    h = rng.standard_normal((2, 12, 64), np.float32)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    out = tffn.ffn_apply({"w_in": torch.from_numpy(wi), "w_down": torch.from_numpy(wd)},
                         th, tcfg)
    ref = jffn.ffn_apply({"w_in": jnp.asarray(wi), "w_down": jnp.asarray(wd)},
                         jnp.asarray(th.float().numpy()).astype(dtype), jcfg)
    assert out.dtype == th.dtype
    _close(out, ref, dtype, "ffn")


ATTN_VARIANTS = {
    "llama": {},
    # a gemma-style local layer: window, softcap, QK-norm and qkv bias
    "local_softcap_qknorm_bias": dict(sliding_window=8, pattern_period=2,
                                      pattern_local=1, attn_softcap=30.0,
                                      qk_norm=True, attn_bias=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
def test_gqa_apply_prefill_cache_and_decode(variant, dtype):
    jcfg, tcfg = _cfgs(dtype, **ATTN_VARIANTS[variant])
    is_local = variant != "llama"
    rng = np.random.default_rng(1)
    layout = jattn.gqa_layout(jcfg)
    jp = jcommon.init_params(jax.random.PRNGKey(3), layout)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    if "bq" in jp:   # non-zero biases, so the bias path is exercised
        for k in ("bq", "bk", "bv"):
            b = rng.standard_normal(jp[k].shape).astype(np.float32) * 0.1
            jp[k], tp[k] = jnp.asarray(b), torch.from_numpy(b)
    S, cap = 12, 16
    x = rng.standard_normal((2, S, 64), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(dtype)
    pos = np.arange(S)[None, :]
    jy, jc = jattn.gqa_apply(jp, jx, jcfg, positions=jnp.asarray(pos), is_local=is_local,
                             return_state=True, cache_capacity=cap)
    ty, tc = tattn.gqa_apply(tp, tx, tcfg, positions=torch.from_numpy(pos),
                             is_local=is_local, return_state=True, cache_capacity=cap)
    _close(ty, jy, dtype, "prefill")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        _close(tc[key], jc[key], dtype, f"cache {key}")
    # two decode steps at positions S and S+1 (the ring wraps at window 8)
    for step in range(2):
        xd = rng.standard_normal((2, 1, 64), np.float32)
        txd = torch.from_numpy(xd).to(getattr(torch, dtype))
        jxd = jnp.asarray(txd.float().numpy()).astype(dtype)
        cp = np.full((2,), S + step, np.int32)
        jy, jc = jattn.gqa_apply(jp, jxd, jcfg, positions=jnp.asarray(cp)[:, None],
                                 is_local=is_local, cache=jc, cache_pos=jnp.asarray(cp))
        ty, tc2 = tattn.gqa_apply(tp, txd, tcfg, positions=torch.from_numpy(cp)[:, None],
                                  is_local=is_local, cache=tc,
                                  cache_pos=torch.from_numpy(cp))
        assert tc2 is tc                                  # updated in place
        _close(ty, jy, dtype, f"decode {step}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_return_state_and_decode(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, none, aux = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert none is None and aux == {} and tl.shape == (2, 16, 512)
    _close(tl, jl, dtype, "full prefill logits")

    jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, return_state=True,
                            cache_capacity=24, last_only=True)
    tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            return_state=True, cache_capacity=24, last_only=True)
    assert tl.shape == (2, 1, 512)
    _close(tl, jl, dtype, "last-only logits")
    jleaves = dict(tcommon.tree_leaves(jax.tree.map(np.asarray, jc)))
    tleaves = dict(tcommon.tree_leaves(tc))
    assert list(jleaves) == list(tleaves)
    for path, leaf in jleaves.items():
        assert tleaves[path].shape == leaf.shape, path
    np.testing.assert_array_equal(tleaves["slots/0/pos"].numpy(), jleaves["slots/0/pos"])

    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((2,), 16 + step, np.int32)
        jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, cache=jc,
                                cache_pos=jnp.asarray(pos))
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                cache_pos=torch.from_numpy(pos))
        _close(tl, jl, dtype, f"decode step {step}")


def test_unported_families_raise():
    """The hybrid and frontend families once raised here, and llama3-405b
    after them; now every model family, llama3-405b included, builds its
    layout and runs a forward, and only an unknown name is refused."""
    for name in ("zamba2-2.7b", "internvl2-1b", "hubert-xlarge", "llama3-405b"):
        cfg = dataclasses.replace(get_config(name, reduced=True), dtype="float32")
        params = tcommon.init_params(torch.Generator().manual_seed(0), ttf.model_layout(cfg))
        batch = ({"features": torch.randn(1, 16, cfg.frontend_dim)} if cfg.family == "audio"
                 else {"tokens": torch.zeros(1, 16, dtype=torch.int32)})
        logits, _, _ = ttf.forward(params, cfg, batch)
        assert logits.shape == (1, 16, cfg.padded_vocab) and torch.isfinite(logits).all()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama3-406b")
