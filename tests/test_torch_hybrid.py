"""The hybrid family (zamba2-2.7b: Mamba-2 layers and one shared attention
block) of the port against the JAX package's, on the CPU, as a whole model.

Config and ``count_params``; model and decode-cache layouts leaf for leaf,
the ``shared`` block one set of weights and its cache stacked one a
period; ``forward`` at REDUCED width (2 periods of 2 Mamba-2 layers and
the shared block) with ``return_state`` and then decode steps;
``ServeEngine.generate`` tokens; ``convert``; ``serve.main --device cpu``.
Weights come from the JAX package and inputs from numpy seeds.

float32 runs free with the SSD's bf16 roundings out of both packages
(``_ssd_in_fp32``; ``tests/test_torch_mamba2.py`` holds the roundings
themselves on equal inputs), at 1e-5.  bf16 keeps them and is held block
by block on JAX's inputs (``BlockInputs``), at 2e-2.  ``generate`` runs
both packages as they are, roundings in.
"""

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
from test_torch_mamba2 import BlockInputs, _ssd_in_fp32

ARCH = "zamba2-2.7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, PROMPT, STEPS = 2, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _close(out, ref, dtype, msg=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_count_params_match_jax(reduced):
    j, t = jax_config(ARCH, reduced), get_config(ARCH, reduced)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tbase.count_params(t) == jbase.count_params(j)
    assert ttf.period_of(t) == t.shared_attn_every
    assert ttf.scanned_layers(t) == ((0, 9, 0) if not reduced else (0, 2, 0))
    if not reduced:
        n = sum(int(np.prod(d.shape)) for _, d in tcommon.tree_leaves(ttf.model_layout(t)))
        assert n == 2_422_907_840
        assert (t.ssm.n_heads(t.d_model), t.ssm.head_dim, t.ssm.d_state) == (80, 64, 64)
        assert (t.attention.n_heads, t.attention.head_dim) == (32, 80)


@pytest.mark.parametrize("reduced", [False, True])
def test_model_and_cache_layouts_match_jax(reduced):
    """Every leaf's path, shape, axes, init and scale; ``shared`` is one
    dense block (not stacked), its cache one full-length GQA cache a period."""
    j, t = jax_config(ARCH, reduced), get_config(ARCH, reduced)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    a = t.attention
    assert tl["shared/attn/wq"].shape == (t.d_model, a.n_heads, a.head_dim)
    assert tl["slots/0/mamba/A_log"].shape == (ttf.scanned_layers(t)[1], t.ssm.n_heads(t.d_model))
    _, n_per, _ = ttf.scanned_layers(t)
    for batch, seq in ((2, 40), (4, 2080)):
        jc = dict(tcommon.tree_leaves(jtf.cache_layout(j, batch, seq)))
        tc = dict(tcommon.tree_leaves(ttf.cache_layout(t, batch, seq)))
        assert {p: (d.shape, d.axes, d.init) for p, d in jc.items()} == \
            {p: (d.shape, d.axes, d.init) for p, d in tc.items()}
        assert tc["shared/k"].shape == (n_per, batch, seq, a.n_kv_heads, a.head_dim)
        assert tc["slots/0/h"].shape == (n_per, batch, t.ssm.n_heads(t.d_model),
                                         t.ssm.head_dim, t.ssm.d_state)


def test_forward_prefill_return_state_and_decode_float32():
    """Free-running: full-sequence logits, then a ``return_state`` prefill
    and decode steps through the slots' and the shared block's caches,
    written in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    with _ssd_in_fp32():
        jl, _, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        tl, none, aux = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        assert none is None and aux == {} and tl.shape == (B, PROMPT, 512)
        _close(tl, jl, "float32", "full prefill logits")
        jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, return_state=True,
                                cache_capacity=PROMPT + STEPS, last_only=True)
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                return_state=True, cache_capacity=PROMPT + STEPS,
                                last_only=True)
        jleaves = dict(tcommon.tree_leaves(jax.tree.map(np.asarray, jc)))
        tleaves = dict(tcommon.tree_leaves(tc))
        assert list(jleaves) == list(tleaves)
        assert {p for p in tleaves if p.startswith("shared/")} == \
            {"shared/k", "shared/v", "shared/pos"}
        for path, leaf in jleaves.items():
            assert tuple(tleaves[path].shape) == leaf.shape, path
            _close(tleaves[path], leaf, "float32", f"cache {path}")
        for step in range(STEPS):
            tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
            pos = np.full((B,), PROMPT + step, np.int32)
            jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, cache=jc,
                                    cache_pos=jnp.asarray(pos))
            shared_k = tc["shared"]["k"]
            tl, tc2, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                     cache_pos=torch.from_numpy(pos))
            assert tc2["shared"]["k"] is shared_k and tc2["slots"] is tc["slots"]
            assert shared_k[:, :, PROMPT + step].any()        # this step's keys, in place
            _close(tl, jl, "float32", f"decode step {step}")
            _close(tc["shared"]["k"], jc["shared"]["k"], "float32", f"decode {step} shared k")


def test_forward_prefill_and_decode_bf16_block_by_block(monkeypatch):
    """bf16, each Mamba, attention and FFN block on JAX's own input: in
    prefill the 4 Mamba-2 layers and the shared block twice (once a
    period), then decode steps through the caches."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    blocks = BlockInputs(monkeypatch)
    with jax.disable_jit():
        jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, return_state=True,
                                cache_capacity=PROMPT + STEPS)
    tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            return_state=True, cache_capacity=PROMPT + STEPS)
    order = ["mamba_apply", "mamba_apply", "attention_apply", "ffn_apply"] * 2
    assert blocks.check("prefill") == order
    _close(tl, jl, "bfloat16", "prefill logits")
    for step in range(STEPS):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((B,), PROMPT + step, np.int32)
        with jax.disable_jit():
            jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, cache=jc,
                                    cache_pos=jnp.asarray(pos))
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                cache_pos=torch.from_numpy(pos))
        assert blocks.check(f"decode step {step}") == order
        _close(tl, jl, "bfloat16", f"decode step {step} logits")


@pytest.mark.parametrize("b, s, n_new, capacity", [(2, 32, 8, 48), (1, 16, 4, 24)])
def test_generate_matches_jax_tokens(b, s, n_new, capacity):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=1)
    prompts = np.random.default_rng(3).integers(0, 512, (b, s)).astype(np.int32)
    ref = JaxEngine(cfg=jcfg, params=jp, capacity=capacity, batch_size=b) \
        .generate(jnp.asarray(prompts), n_new)
    out = ServeEngine(cfg=tcfg, params=tp, capacity=capacity, batch_size=b,
                      device="cpu").generate(torch.from_numpy(prompts), n_new)
    assert out.dtype == torch.int32 and out.shape == (b, n_new)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_model_params_from_numpy_carries_the_tree_and_checks_every_leaf():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jp)
    assert [p for p, _ in tcommon.tree_leaves(tp)] == [p for p, _ in tcommon.tree_leaves(tree)]
    for path, leaf in tcommon.tree_leaves(tree):
        np.testing.assert_array_equal(dict(tcommon.tree_leaves(tp))[path].numpy(), leaf)
    with pytest.raises(ValueError, match="missing.*shared"):
        convert.model_params_from_numpy({k: v for k, v in tree.items() if k != "shared"},
                                        tcfg, "cpu")
    mamba = dict(tree["slots"][0]["mamba"], gate_norm=tree["slots"][0]["mamba"]["gate_norm"][:, :-1])
    with pytest.raises(ValueError, match="gate_norm"):
        convert.model_params_from_numpy(dict(tree, slots=[dict(tree["slots"][0], mamba=mamba),
                                                          tree["slots"][1]]), tcfg, "cpu")
    extra = dict(tree, shared=dict(tree["shared"], ln3=tree["shared"]["ln1"]))
    with pytest.raises(ValueError, match="unexpected.*ln3"):
        convert.model_params_from_numpy(extra, tcfg, "cpu")


def test_serve_main_runs_zamba2_on_cpu(capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 16) tokens" in out and "power_gain=" in out
