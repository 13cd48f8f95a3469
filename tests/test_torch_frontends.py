"""The VLM (internvl2-1b) and audio (hubert-xlarge) families of the port
against the JAX package's, on the CPU.

Configs and ``count_params``; layouts leaf for leaf with their
``frontend`` leaves (hubert's head untied, internvl2's tied, its padded
vocabulary masked); ``forward`` at REDUCED width: internvl2 with and
without ``patches``, then decode steps; hubert's non-causal encoder on
``features``; both in float32 (1e-5) and bf16 (2e-2, JAX op by op,
``jax.disable_jit()``); ``generate`` tokens for internvl2; ``convert`` on
both trees; ``serve.main``, which serves internvl2 and refuses the
encoder-only hubert.  Weights come from the JAX package, inputs from
numpy seeds.
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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import ServeEngine

VLM, AUDIO = "internvl2-1b", "hubert-xlarge"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, PROMPT, STEPS = 2, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _jax_mode(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _close(out, ref, dtype, msg=""):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def _batch(jcfg, seed, **arrays):
    """The same batch for both packages: int32 tokens and float32 arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)}
    out.update({k: rng.standard_normal(shape).astype(np.float32) for k, shape in arrays.items()})
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_config_layout_and_count_params_match_jax(arch, reduced):
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.padded_vocab == j.padded_vocab
    assert tbase.count_params(t) == jbase.count_params(j)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    front = {p.split("/", 1)[1] for p in tl if p.startswith("frontend/")}
    assert front == ({"w1", "b1", "w2", "b2"} if arch == VLM else {"proj", "bias"})
    assert ("lm_head" in tl) == (arch == AUDIO)       # internvl2 tied; hubert's head untied
    if not reduced:
        n = sum(int(np.prod(d.shape)) for d in tl.values())
        assert n == {VLM: 495_640_192, AUDIO: 1_260_382_720}[arch]
    if arch == VLM:
        assert (t.vocab_size, t.padded_vocab) == ((151_655, 151_808) if not reduced else (512, 512))
    else:
        assert t.is_encoder_only and not t.causal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("patches", [True, False])
def test_vlm_forward_prefill_and_decode(patches, dtype):
    """Patches (or none) in the prefill, then decode steps on tokens."""
    jcfg, tcfg = _cfgs(VLM, dtype)
    jp, tp = _params(jcfg, tcfg)
    extra = {"patches": (B, jcfg.frontend_len, jcfg.frontend_dim)} if patches else {}
    jb, tb = _batch(jcfg, 1, **extra)
    with _jax_mode(dtype):
        jl, jc, _ = jtf.forward(jp, jcfg, jb, return_state=True, cache_capacity=PROMPT + STEPS)
    tl, tc, aux = ttf.forward(tp, tcfg, tb, return_state=True, cache_capacity=PROMPT + STEPS)
    assert aux == {} and tl.shape == (B, PROMPT, tcfg.padded_vocab)
    _close(tl, jl, dtype, "prefill logits")
    if patches:   # the patches moved the first frontend_len positions, and only those
        plain, _, _ = ttf.forward(tp, tcfg, {"tokens": tb["tokens"]})
        moved = (plain - tl).abs().amax(-1).amax(0) > 0
        assert moved[0] and moved[:tcfg.frontend_len].all()
    for step in range(STEPS):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((B,), PROMPT + step, np.int32)
        with _jax_mode(dtype):
            jl, jc, _ = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, cache=jc,
                                    cache_pos=jnp.asarray(pos))
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                cache_pos=torch.from_numpy(pos))
        _close(tl, jl, dtype, f"decode step {step}")


def test_vlm_head_masks_the_padded_vocabulary():
    """Full width pads 151,655 to 151,808 columns; at REDUCED width with a
    vocabulary of 500 (padded to 512) the tied head's padding columns come
    out at -1e9 in both packages."""
    assert get_config(VLM).padded_vocab - get_config(VLM).vocab_size == 153
    j, t = (dataclasses.replace(c, vocab_size=500) for c in _cfgs(VLM))
    assert t.padded_vocab == j.padded_vocab == 512
    jp, tp = _params(j, t)
    toks = np.arange(16, dtype=np.int32)[None] * 31
    jl, _, _ = jtf.forward(jp, j, {"tokens": jnp.asarray(toks)}, last_only=True)
    tl, _, _ = ttf.forward(tp, t, {"tokens": torch.from_numpy(toks)}, last_only=True)
    assert tl.shape == (1, 1, 512)
    assert (tl[..., 500:] == -1e9).all() and (tl[..., :500] > -1e3).all()
    _close(tl, jl, "float32", "masked logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_encoder_on_features(dtype):
    """``features`` projected in place of tokens, a non-causal encoder:
    a later frame moves every earlier position's logits."""
    jcfg, tcfg = _cfgs(AUDIO, dtype)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(jcfg, 2, features=(B, PROMPT, jcfg.frontend_dim))
    del jb["tokens"], tb["tokens"]
    with _jax_mode(dtype):
        jl, _, _ = jtf.forward(jp, jcfg, jb)
    tl, none, _ = ttf.forward(tp, tcfg, tb)
    assert none is None and tl.shape == (B, PROMPT, tcfg.padded_vocab)
    _close(tl, jl, dtype, "encoder logits")
    later = dict(tb, features=tb["features"].clone())
    later["features"][:, -1] += 1.0
    moved, _, _ = ttf.forward(tp, tcfg, later)
    assert ((moved - tl).abs().amax(-1) > 0).all()


def test_audio_attention_pads_head_dim_80_and_is_non_causal(monkeypatch):
    """hubert's 80-wide heads (its full width's, in a REDUCED model) reach
    the flash op at 80, non-causal, with the scale of 80; in float32 the op
    pads them to 128 on a card (``ops.kernel_widths``)."""
    assert get_config(AUDIO).attention.head_dim == 80
    j, t = (dataclasses.replace(c, attention=dataclasses.replace(c.attention, head_dim=80))
            for c in _cfgs(AUDIO))
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(j))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), t, "cpu")
    feats = np.random.default_rng(0).standard_normal((1, 16, t.frontend_dim)).astype(np.float32)
    calls, real = [], tattn.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["causal"], kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    jl, _, _ = jtf.forward(jp, j, {"features": jnp.asarray(feats)})
    tl, _, _ = ttf.forward(tp, t, {"features": torch.from_numpy(feats)})
    assert calls == [(80, 80, 80, False, pytest.approx(80 ** -0.5))] * t.n_layers
    assert fa_ops.kernel_widths(torch.float32, 80, 80) == (128, 128)
    _close(tl, jl, "float32", "logits")


def test_generate_matches_jax_tokens():
    jcfg, tcfg = _cfgs(VLM)
    jp, tp = _params(jcfg, tcfg, seed=1)
    prompts = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(np.int32)
    ref = JaxEngine(cfg=jcfg, params=jp, capacity=32, batch_size=2) \
        .generate(jnp.asarray(prompts), 8)
    out = ServeEngine(cfg=tcfg, params=tp, capacity=32, batch_size=2,
                      device="cpu").generate(torch.from_numpy(prompts), 8)
    assert out.dtype == torch.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_model_params_from_numpy_takes_the_frontend_and_checks_it(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jp)
    assert [p for p, _ in tcommon.tree_leaves(tp)] == [p for p, _ in tcommon.tree_leaves(tree)]
    np.testing.assert_array_equal(tp["frontend"]["b1" if arch == VLM else "bias"].numpy(),
                                  tree["frontend"]["b1" if arch == VLM else "bias"])
    with pytest.raises(ValueError, match="missing.*frontend"):
        convert.model_params_from_numpy({k: v for k, v in tree.items() if k != "frontend"},
                                        tcfg, "cpu")
    first = next(iter(tree["frontend"]))
    bad = dict(tree, frontend=dict(tree["frontend"], **{first: tree["frontend"][first][1:]}))
    with pytest.raises(ValueError, match=f"frontend/{first}"):
        convert.model_params_from_numpy(bad, tcfg, "cpu")
    if arch == VLM:   # tied: a head the layout does not have is refused
        with pytest.raises(ValueError, match="unexpected.*lm_head"):
            convert.model_params_from_numpy(dict(tree, lm_head=tree["embed"].T), tcfg, "cpu")


def test_serve_main_serves_internvl2_and_refuses_hubert(capsys, monkeypatch):
    assert tserve.main(["--arch", VLM, "--device", "cpu", "--requests", "4"]) == 0
    assert "generated (4, 16) tokens" in capsys.readouterr().out
    drawn = []
    monkeypatch.setattr(tserve.common, "init_params", lambda *a, **k: drawn.append(1))
    with pytest.raises(SystemExit, match="encoder-only arch has no decode step"):
        tserve.main(["--arch", AUDIO, "--device", "cpu"])
    assert not drawn                                  # refused before any weights
