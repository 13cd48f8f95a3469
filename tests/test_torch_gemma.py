"""The local:global attention family (gemma2-2b, gemma3-27b) of the port
against the JAX package's, on the CPU.

Configs, layouts and the decode cache's layout leaf for leaf; ``forward``
at REDUCED widths with a 96-token prompt (past the REDUCED window of 32,
so the local layers' flash calls take the window and their decode caches
are 32-slot rings) and then 8 decode steps, which wrap every ring; gemma3
also at 8 layers, one period of 6 and 2 remainder layers, so ``rem``
runs; ``ServeEngine.generate`` tokens; ``convert.model_params_from_numpy``
on both trees.  Weights come from the JAX package and inputs from numpy
seeds.  In float32 both packages compute the same function with sums in
other orders and are held to 1e-4.  In bf16 the JAX package runs op by
op (``jax.disable_jit()``: compiled, XLA's fusion moves its own bf16
logits by up to ~0.04) and both round the attention's probabilities to
bf16 before ``p·v``, as the kernels do; they are held to 2e-2.  The
decode cache's k and v are compared leaf by leaf in float32; in bf16
through the decode logits they give, since a deep layer's k carries the
residual stream's rounding.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import ServeEngine

ARCHS = ("gemma2-2b", "gemma3-27b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PROMPT, STEPS = 96, 8
#: (arch, n_layers): REDUCED depth, and gemma3 with a remainder after its period
MODELS = [("gemma2-2b", None), ("gemma3-27b", None), ("gemma3-27b", 8)]


def _cfgs(arch, dtype="float32", n_layers=None):
    """REDUCED ``arch`` in both packages, in ``dtype``, optionally at another depth."""
    extra = {"dtype": dtype}
    if n_layers is not None:
        extra["n_layers"] = n_layers
    return (dataclasses.replace(jax_config(arch, reduced=True), **extra),
            dataclasses.replace(get_config(arch, reduced=True), **extra))


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _close(out, ref, dtype, msg=""):
    """``out`` (port) within ``TOL[dtype]`` of ``ref`` (JAX, same dtype)."""
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def _jax_mode(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _model_id(m):
    return f"{m[0]}-{m[1] or 'reduced'}"


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_count_params_match_jax(arch, reduced):
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.padded_vocab == j.padded_vocab
    assert tbase.count_params(t) == jbase.count_params(j)
    if not reduced:
        n = sum(int(np.prod(d.shape)) for _, d in tcommon.tree_leaves(ttf.model_layout(t)))
        want = {"gemma2-2b": 2.614e9, "gemma3-27b": 27.009e9}[arch]
        assert n == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_and_cache_layouts_match_jax(arch, reduced):
    """Every parameter leaf's path, shape, axes, init and scale, and every
    decode-cache leaf's shape: the local layers' rings hold
    ``min(window, capacity)`` slots, the global layers ``capacity``."""
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    assert "lm_head" not in tl                                # tied embeddings
    assert any(p.endswith("attn/q_norm") for p in tl) == (arch == "gemma3-27b")
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    capacity = 8192 if not reduced else PROMPT + STEPS
    jc = dict(tcommon.tree_leaves(jtf.cache_layout(j, 2, capacity)))
    tc = dict(tcommon.tree_leaves(ttf.cache_layout(t, 2, capacity)))
    assert {p: (d.shape, d.axes) for p, d in jc.items()} == \
        {p: (d.shape, d.axes) for p, d in tc.items()}
    a = t.attention
    kv_seq = sorted({d.shape[d.axes.index("kv_seq")] for p, d in tc.items()
                     if p.endswith("/k")})
    assert kv_seq == sorted({min(a.sliding_window, capacity), capacity})


def test_gemma3_remainder_layers_keep_the_pattern():
    """62 = 10 periods of 6 + 2 remainder layers, and both remainder layers
    are local (global layers sit at the end of each period), as in JAX."""
    t, j = get_config("gemma3-27b"), jax_config("gemma3-27b")
    assert ttf.scanned_layers(t) == jtf.scanned_layers(j) == (0, 10, 2)
    for gidx in range(t.n_layers):
        assert ttf._is_local(t, gidx) == jtf._is_local(j, gidx), gidx
    assert [ttf._is_local(t, g) for g in (60, 61)] == [True, True]
    assert [ttf._is_local(t, g) for g in range(6)] == [True] * 5 + [False]
    g2 = get_config("gemma2-2b")
    assert ttf.scanned_layers(g2) == (0, 13, 0)
    assert [ttf._is_local(g2, g) for g in range(4)] == [True, False, True, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS, ids=_model_id)
def test_forward_prefill_past_the_window_then_decode_past_the_ring_wrap(model, dtype):
    arch, n_layers = model
    jcfg, tcfg = _cfgs(arch, dtype, n_layers)
    assert tcfg.attention.sliding_window < PROMPT
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    capacity = PROMPT + STEPS

    def jax_forward(batch, **kw):
        with _jax_mode(dtype):
            logits, cache, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(batch)}, **kw)
        return logits, cache

    jl, jc = jax_forward(toks, return_state=True, cache_capacity=capacity)
    tl, tc, aux = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              return_state=True, cache_capacity=capacity)
    assert aux == {} and tl.shape == (2, PROMPT, 512)
    _close(tl, jl, dtype, "prefill logits")
    jleaves = dict(tcommon.tree_leaves(jax.tree.map(np.asarray, jc)))
    tleaves = dict(tcommon.tree_leaves(tc))
    assert list(jleaves) == list(tleaves)
    for path, leaf in jleaves.items():
        assert tleaves[path].shape == leaf.shape and tleaves[path].dtype == \
            (torch.int32 if path.endswith("pos") else getattr(torch, dtype)), path
        if path.endswith("pos"):
            np.testing.assert_array_equal(tleaves[path].numpy(), leaf, err_msg=path)
        elif dtype == "float32":
            _close(tleaves[path], leaf, dtype, path)
    if n_layers == 8:
        assert len(tleaves) == 3 * 6 + 3 * 2            # six slots and two rem layers

    for step in range(STEPS):                            # every ring wraps at slot 0
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((2,), PROMPT + step, np.int32)
        jl, jc = jax_forward(tok, cache=jc, cache_pos=jnp.asarray(pos))
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                cache_pos=torch.from_numpy(pos))
        _close(tl, jl, dtype, f"decode step {step}")
    for path, leaf in tcommon.tree_leaves(jax.tree.map(np.asarray, jc)):
        if path.endswith("pos"):
            np.testing.assert_array_equal(dict(tcommon.tree_leaves(tc))[path].numpy(), leaf,
                                          err_msg=path)


@pytest.mark.parametrize("model", MODELS, ids=_model_id)
def test_generate_matches_jax_tokens(model):
    arch, n_layers = model
    jcfg, tcfg = _cfgs(arch, "float32", n_layers)
    jp, tp = _params(jcfg, tcfg, seed=1)
    prompts = np.random.default_rng(3).integers(0, 512, (2, PROMPT)).astype(np.int32)
    ref = JaxEngine(cfg=jcfg, params=jp, capacity=PROMPT + STEPS, batch_size=2) \
        .generate(jnp.asarray(prompts), STEPS + 1)
    out = ServeEngine(cfg=tcfg, params=tp, capacity=PROMPT + STEPS, batch_size=2,
                      device="cpu").generate(torch.from_numpy(prompts), STEPS + 1)
    assert out.dtype == torch.int32 and out.shape == (2, STEPS + 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_from_numpy_carries_the_tree_and_checks_every_leaf(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jp)
    assert [p for p, _ in tcommon.tree_leaves(tp)] == [p for p, _ in tcommon.tree_leaves(tree)]
    for path, leaf in tcommon.tree_leaves(tree):
        np.testing.assert_array_equal(dict(tcommon.tree_leaves(tp))[path].numpy(), leaf)
    with pytest.raises(ValueError, match="unexpected"):          # tied: no lm_head
        convert.model_params_from_numpy(dict(tree, lm_head=np.zeros((64, 512), np.float32)),
                                        tcfg, "cpu")
    slot = dict(tree["slots"][0])
    slot["attn"] = {k: v for k, v in slot["attn"].items() if k != "wq"}
    with pytest.raises(ValueError, match="missing"):
        convert.model_params_from_numpy(dict(tree, slots=[slot] + tree["slots"][1:]),
                                        tcfg, "cpu")
    if arch == "gemma3-27b":
        assert tp["slots"][0]["attn"]["q_norm"].shape == (1, 16)
        bad = dict(tree["slots"][0], attn=dict(tree["slots"][0]["attn"],
                                                k_norm=np.ones((1, 17), np.float32)))
        with pytest.raises(ValueError, match="k_norm"):
            convert.model_params_from_numpy(dict(tree, slots=[bad] + tree["slots"][1:]),
                                            tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_arch_on_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 16) tokens" in out and "power_gain=" in out
