"""The port's Mamba-1 model (falcon-mamba-7b) against the JAX package's, on the CPU.

Weights are initialised by the JAX package and carried over by
``convert.model_params_from_numpy``; inputs come from numpy seeds.  In
float32 both packages compute the same function, the recurrence
sequentially in the port's op and associatively within chunks in XLA's
``chunked_scan``, so logits agree to about 1e-6 and are held to 1e-4.

In bf16 the port reproduces the JAX code op for op: run op by op
(``jax.disable_jit()``), the JAX package gives the port's logits to
about 1e-5.  Compiled, XLA fuses the elementwise chains of the layer body
inside ``lax.scan`` and rounds them in other places, which moves the JAX
package's own bf16 logits (up to about 4 in size) by up to about 0.04 from
its op-by-op run.  So bf16 comparisons are made against the op-by-op run,
held to 2e-2, the model-level bf16 tolerance of ``tests/test_torch_models.py``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import base as jbase
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import FP32_LEAVES, ServeEngine

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ARCH = "falcon-mamba-7b"


def _cfgs(dtype="float32"):
    """REDUCED falcon-mamba-7b in both packages, in ``dtype``."""
    return tuple(dataclasses.replace(f(ARCH, reduced=True), dtype=dtype)
                 for f in (jax_config, get_config))


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _jax_mode(dtype):
    """Compiled JAX in float32; op by op in bf16 (see the module note)."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _close(out, ref, dtype, msg=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def _both(array, dtype):
    t = torch.from_numpy(array).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def _port_cfg(jcfg):
    """A JAX ModelConfig as the port's, field for field."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tbase.ModelConfig)}
    for name, cls in (("attention", tbase.AttentionConfig), ("moe", tbase.MoEConfig),
                      ("ssm", tbase.SSMConfig)):
        sub = fields[name]
        fields[name] = None if sub is None else cls(**dataclasses.asdict(sub))
    return tbase.ModelConfig(**fields)


def _layer_params(jp, i=0):
    """Layer ``i``'s Mamba block in both packages."""
    jl = jax.tree.map(lambda t: t[i], jp["slots"][0]["mamba"])
    return jl, {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}


def test_config_and_param_count():
    for reduced in (False, True):
        j, t = jax_config(ARCH, reduced), get_config(ARCH, reduced)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert tbase.count_params(t) == jbase.count_params(j)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state,
            tssm.dt_rank(cfg), cfg.ssm.d_conv, cfg.vocab_size) == \
        (64, 4096, 8192, 16, 256, 4, 65_024)
    # the layout holds 7,272,665,088 parameters; the reference's
    # count_params formula leaves some out (ROADMAP C), and the port keeps it
    held = sum(int(np.prod(d.shape)) for _, d in tcommon.tree_leaves(ttf.model_layout(cfg)))
    assert held == 7_272_665_088
    assert tbase.count_params(cfg) == 7_003_176_960


@pytest.mark.parametrize("arch", [ARCH, "zamba2-2.7b"])
def test_mamba_layouts_match_jax(arch):
    """Block and cache layouts, Mamba-1 and Mamba-2: paths, shapes, axes,
    init and scale (no weights allocated)."""
    for reduced in (False, True):
        j = jax_config(arch, reduced)
        t = _port_cfg(j)
        jl = dict(tcommon.tree_leaves(jssm.mamba_layout(j)))
        tl = dict(tcommon.tree_leaves(tssm.mamba_layout(t)))
        assert list(jl) == list(tl)
        for path, d in jl.items():
            assert (tl[path].shape, tl[path].axes, tl[path].init) == \
                (d.shape, d.axes, d.init), path
            assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
        jc = dict(tcommon.tree_leaves(jssm.mamba_cache_layout(j, 3)))
        tc = dict(tcommon.tree_leaves(tssm.mamba_cache_layout(t, 3)))
        assert {p: (d.shape, d.axes) for p, d in jc.items()} == \
            {p: (d.shape, d.axes) for p, d in tc.items()}
        assert tssm.dt_rank(t) == jssm.dt_rank(j)


@pytest.mark.parametrize("reduced", [True, False])
def test_model_and_cache_layout_match_jax(reduced):
    j, t = jax_config(ARCH, reduced), get_config(ARCH, reduced)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    jc = dict(tcommon.tree_leaves(jtf.cache_layout(j, 2, 40)))
    tc = dict(tcommon.tree_leaves(ttf.cache_layout(t, 2, 40)))
    assert {p: d.shape for p, d in jc.items()} == {p: d.shape for p, d in tc.items()}


def test_mamba2_is_not_ported():
    """Mamba-2 once raised here; now its block runs, from the same layout
    as Mamba-1's, and hands back its ``[B, nh, p, n]`` state
    (``tests/test_torch_mamba2.py`` holds it against JAX)."""
    t = dataclasses.replace(_port_cfg(jax_config("zamba2-2.7b", reduced=True)), dtype="float32")
    params = tcommon.init_params(torch.Generator().manual_seed(0), tssm.mamba_layout(t))
    y, cache = tssm.mamba_apply(params, torch.randn(1, 16, t.d_model), t, return_state=True)
    assert y.shape == (1, 16, t.d_model) and torch.isfinite(y).all()
    assert cache["h"].shape == (1, t.ssm.n_heads(t.d_model), t.ssm.head_dim, t.ssm.d_state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    tx, jx = _both(rng.standard_normal((2, 12, 40)).astype(np.float32), dtype)
    w = rng.standard_normal((4, 40)).astype(np.float32) / 2
    b = rng.standard_normal(40).astype(np.float32) / 10
    out = tssm._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, jssm._causal_conv(jx, jnp.asarray(w), jnp.asarray(b)), dtype)
    # a cross-correlation: w[K-1] weights the current step, w[0] the step
    # K-1 back, and steps before the start count as zero
    x1 = torch.zeros(1, 6, 1)
    x1[0, 2, 0] = 1.0
    one = tssm._causal_conv(x1, torch.arange(1.0, 5.0)[:, None], torch.zeros(1))
    np.testing.assert_array_equal(one[0, :, 0].numpy(), [0, 0, 4, 3, 2, 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_prefill_state_and_decode(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, _ = _params(jcfg, tcfg)
    jl, tl = _layer_params(jp)
    rng = np.random.default_rng(1)
    tx, jx = _both(rng.standard_normal((2, 16, 64)).astype(np.float32), dtype)
    with _jax_mode(dtype):
        jy, jc = jssm.mamba_apply(jl, jx, jcfg, return_state=True)
    ty, tc = tssm.mamba_apply(tl, tx, tcfg, return_state=True)
    assert ty.dtype == tx.dtype and tc["h"].dtype == torch.float32
    assert tc["conv"].dtype == tx.dtype and tc["conv"].shape == (2, 3, 128)
    _close(ty, jy, dtype, "prefill y")
    _close(tc["h"], jc["h"], dtype, "prefill h")
    _close(tc["conv"], jc["conv"], dtype, "prefill conv tail")
    # decode steps: the cache is updated in place and handed back
    for step in range(2):
        txd, jxd = _both(rng.standard_normal((2, 1, 64)).astype(np.float32), dtype)
        h_before = tc["h"].clone()
        with _jax_mode(dtype):
            jy, jc = jssm.mamba_apply(jl, jxd, jcfg, cache=jc)
        ty, tc2 = tssm.mamba_apply(tl, txd, tcfg, cache=tc)
        assert tc2 is tc and not torch.equal(tc["h"], h_before)
        _close(ty, jy, dtype, f"decode {step} y")
        _close(tc["h"], jc["h"], dtype, f"decode {step} h")
        _close(tc["conv"], jc["conv"], dtype, f"decode {step} conv tail")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    with _jax_mode(dtype):
        jl, _, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, none, aux = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert none is None and aux == {} and tl.shape == (2, 16, 512)
    _close(tl, jl, dtype, "full prefill logits")

    with _jax_mode(dtype):
        jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, return_state=True,
                                last_only=True)
    tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            return_state=True, last_only=True)
    assert tl.shape == (2, 1, 512)
    _close(tl, jl, dtype, "last-only logits")
    jleaves = dict(tcommon.tree_leaves(jax.tree.map(np.asarray, jc)))
    tleaves = dict(tcommon.tree_leaves(tc))
    assert list(jleaves) == list(tleaves) == ["slots/0/conv", "slots/0/h"]
    for path, leaf in jleaves.items():
        assert tleaves[path].shape == leaf.shape, path
    _close(tleaves["slots/0/h"], jleaves["slots/0/h"], dtype, "cache h")

    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((2,), 16 + step, np.int32)
        with _jax_mode(dtype):
            jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, cache=jc,
                                    cache_pos=jnp.asarray(pos))
        tl, tc2, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                 cache_pos=torch.from_numpy(pos))
        assert tc2["slots"] is tc["slots"]              # written in place
        _close(tl, jl, dtype, f"decode step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_equals_longer_forward(dtype):
    """The state hands over: prefill(15) + decode(1) == forward(16), and a
    second decode step continues from the first (the cache is written in
    place, so a step that left it alone would repeat the prefill state)."""
    _, tcfg = _cfgs(dtype)
    tp = tcommon.init_params(torch.Generator().manual_seed(0), ttf.model_layout(tcfg))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 32)).astype(np.int32))
    full, _, _ = ttf.forward(tp, tcfg, {"tokens": toks})
    _, cache, _ = ttf.forward(tp, tcfg, {"tokens": toks[:, :15]}, return_state=True)
    for t in (15, 16):
        dec, cache, _ = ttf.forward(tp, tcfg, {"tokens": toks[:, t:t + 1]}, cache=cache,
                                    cache_pos=torch.full((2,), t, dtype=torch.int32))
        _close(dec[:, 0], full[:, t].float().numpy(), dtype, f"decode at {t}")


def test_prompt_length_follows_the_chunk_contract():
    """The port accepts and refuses the prompts the JAX chunked scan does:
    S must be a multiple of min(chunk, S) (REDUCED chunk is 16)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    for s in (8, 32):
        toks = np.zeros((1, s), np.int32)
        jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    toks = np.zeros((1, 24), np.int32)
    with pytest.raises(AssertionError):
        jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with pytest.raises(AssertionError):
        ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})


@pytest.fixture(scope="module")
def falcon():
    """REDUCED falcon-mamba-7b in float32: (jax cfg, port cfg, jax params, port params)."""
    jcfg, tcfg = _cfgs("float32")
    return (jcfg, tcfg) + _params(jcfg, tcfg)


@pytest.mark.parametrize("b, s, n_new, capacity", [(2, 16, 8, 48), (1, 8, 4, 32)])
def test_generate_matches_jax_tokens(falcon, b, s, n_new, capacity):
    jcfg, tcfg, jp, tp = falcon
    prompts = np.random.default_rng(1).integers(0, 512, (b, s)).astype(np.int32)
    ref = JaxEngine(cfg=jcfg, params=jp, capacity=capacity, batch_size=b) \
        .generate(jnp.asarray(prompts), n_new)
    eng = ServeEngine(cfg=tcfg, params=tp, capacity=capacity, batch_size=b, device="cpu")
    out = eng.generate(torch.from_numpy(prompts), n_new)
    assert out.dtype == torch.int32 and out.shape == (b, n_new)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_bf16_matches_jax_op_by_op(falcon):
    _, _, jp, tp = falcon
    jcfg, tcfg = _cfgs("bfloat16")
    prompts = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(np.int32)
    with jax.disable_jit():
        ref = JaxEngine(cfg=jcfg, params=jp, capacity=24, batch_size=2) \
            .generate(jnp.asarray(prompts), 6)
    out = ServeEngine(cfg=tcfg, params=tp, capacity=24, batch_size=2, device="cpu") \
        .generate(torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_serving_copy_keeps_fp32_leaves(falcon):
    """The bf16 serving copy keeps in float32 every leaf the JAX package
    reads in float32; a bf16 dt_bias would be -4.59375, not -4.6."""
    _, _, _, tp = falcon
    llama_cfg = get_config("llama3.2-1b", reduced=True)
    llama = tcommon.init_params(torch.Generator().manual_seed(0),
                                ttf.model_layout(llama_cfg))
    for cfg, params in ((get_config(ARCH, reduced=True), tp), (llama_cfg, llama)):
        eng = ServeEngine(cfg=cfg, params=params, capacity=24, batch_size=2, device="cpu")
        assert cfg.dtype == "bfloat16"
        for path, leaf in tcommon.tree_leaves(eng._params):
            want = torch.float32 if path.split("/")[-1] in FP32_LEAVES else torch.bfloat16
            assert leaf.dtype == want, path
    eng = ServeEngine(cfg=get_config(ARCH, reduced=True), params=tp, capacity=24,
                      batch_size=2, device="cpu")
    mamba = eng._params["slots"][0]["mamba"]
    assert {k for k, v in mamba.items() if v.dtype == torch.float32} == {"A_log", "dt_bias", "D"}
    assert torch.equal(mamba["dt_bias"], torch.full_like(mamba["dt_bias"], -4.6))
    assert eng._params["slots"][0]["ln"].dtype == torch.float32
    assert tp["slots"][0]["mamba"]["in_proj"].dtype == torch.float32   # caller's tree intact


def test_serve_main_runs_falcon_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 16) tokens" in out
    assert "technique=proposed power_gain=" in out
