"""The MoE family (qwen3-moe-235b-a22b, deepseek-v2-236b) of the port
against the JAX package's, on the CPU, as whole models.

Configs and ``count_params``; layouts and decode-cache layouts leaf for
leaf (deepseek's leading dense layer with ``d_ff_dense``, its MLA cache);
``forward`` at REDUCED width (a 64-token prompt, one dispatch group a
row) with ``return_state`` and then decode steps; ``ServeEngine.generate``
tokens; ``convert`` on both trees; ``serve.main --device cpu``.  Weights
come from the JAX package and inputs from numpy seeds.

Every MoE call's routing is recorded on both sides (JAX runs op by op,
``jax.disable_jit()``, so its ``top_k`` and blocks can be watched).  In
float32 the models run free, the routing is equal call for call and
logits agree within 1e-5.  In bf16 each attention, MoE and FFN block
runs on JAX's input of that block (``_BlockInputs``) and is held to 2e-2.  Both routers then see
one input, but a call's router probabilities may still differ by some δ
(sums in other orders), and two experts can swap only where their
probabilities are within 2δ: every token whose expert set differs is
asserted to be such a near tie, and the batch rows the flip reaches (its
own, and those whose capacity it moved) leave that block's comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import ServeEngine

ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, PROMPT, STEPS = 4, 64, 3


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jtf.model_layout(jcfg))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_count_params_match_jax(arch, reduced):
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.padded_vocab == j.padded_vocab
    assert tbase.count_params(t) == jbase.count_params(j)
    assert tbase.count_params(t, active_only=True) == jbase.count_params(j, active_only=True)
    if not reduced:
        n = sum(int(np.prod(d.shape)) for _, d in tcommon.tree_leaves(ttf.model_layout(t)))
        want = {"qwen3-moe-235b-a22b": 235.1e9, "deepseek-v2-236b": 236.0e9}[arch]
        assert n == pytest.approx(want, rel=1e-2)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_and_cache_layouts_match_jax(arch, reduced):
    """Every parameter leaf's path, shape, axes, init and scale and every
    cache leaf's shape and axes; deepseek's prefix layer is dense at
    ``d_ff_dense``, every other layer MoE."""
    j, t = jax_config(arch, reduced), get_config(arch, reduced)
    jl = dict(tcommon.tree_leaves(jtf.model_layout(j)))
    tl = dict(tcommon.tree_leaves(ttf.model_layout(t)))
    assert list(jl) == list(tl)
    for path, d in jl.items():
        assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init), path
        assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
    m = t.moe
    assert [ttf._layer_kind(t, i) for i in range(t.n_layers)] == \
        [jtf._layer_kind(j, i) for i in range(t.n_layers)] == \
        ["dense"] * m.first_dense_layers + ["moe"] * (t.n_layers - m.first_dense_layers)
    if m.first_dense_layers:
        assert tl["prefix/0/ffn/w_down"].shape == (m.d_ff_dense, t.d_model)
    assert "slots/0/moe/router" in tl
    for batch, capacity in ((2, 72), (2, 4128)):
        jc = dict(tcommon.tree_leaves(jtf.cache_layout(j, batch, capacity)))
        tc = dict(tcommon.tree_leaves(ttf.cache_layout(t, batch, capacity)))
        assert {p: (d.shape, d.axes) for p, d in jc.items()} == \
            {p: (d.shape, d.axes) for p, d in tc.items()}


class _Routings:
    """Every MoE call's routing on both sides, in call order: JAX's
    ``top_k`` inputs and outputs, the port's ``Routing``."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        top_k, route = jax.lax.top_k, tmoe.route

        def jax_spy(probs, k):
            vals, idx = top_k(probs, k)
            self.jax.append((np.asarray(probs), np.asarray(idx)))
            return vals, idx

        def port_spy(*args):
            r = route(*args)
            self.port.append(r)
            return r

        monkeypatch.setattr(jmoe.jax.lax, "top_k", jax_spy)
        monkeypatch.setattr(tmoe, "route", port_spy)

    def check(self, cfg, seq, dtype):
        """Compare the calls recorded since the last check (batch rows of
        ``seq`` tokens).  float32: equal.  bf16: a token's expert set may
        differ only at a near tie (2δ, δ the call's largest probability
        difference), and ``keep`` only in a group with such a flip.
        Returns, per call, the batch rows a flip reached."""
        k, out = cfg.moe.top_k, []
        assert len(self.jax) == len(self.port)
        for (probs, idx), r in zip(self.jax, self.port):
            g, gs, e = probs.shape
            keep = _keep(idx, tmoe._capacity(gs, cfg), e)
            if dtype == "float32":
                np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
                np.testing.assert_array_equal(r.keep.numpy(), keep)
                out.append(set())
                continue
            disagree = np.abs(r.probs.numpy() - probs).max()
            assert disagree <= TOL[dtype], disagree
            top = -np.sort(-probs, axis=-1)
            gap = top[..., k - 1] - top[..., k]
            flipped = np.array([[set(a) != set(b) for a, b in zip(ia, ib)]
                                for ia, ib in zip(idx.tolist(), r.expert_idx.tolist())])
            assert (gap[flipped] <= 2 * disagree).all(), (gap[flipped], disagree)
            moved = (r.keep.numpy() != keep).any(-1)
            assert not (moved & ~flipped.any(-1, keepdims=True)).any(), \
                "capacity differs in a group with no flip"
            row = np.arange(g * gs).reshape(g, gs) // seq              # token -> batch row
            out.append(set(row[flipped | moved].tolist()))
        self.jax.clear()
        self.port.clear()
        return out


def _keep(idx, cap, n_experts):
    """The reference's ``keep`` for JAX's recorded experts."""
    g, gs, k = idx.shape
    onehot = np.eye(n_experts, dtype=np.int64)[idx]                  # [g,s,k,e]
    flat = onehot.transpose(0, 2, 1, 3).reshape(g, k * gs, n_experts)
    pos = (np.cumsum(flat, axis=1) - flat).reshape(g, k, gs, n_experts).transpose(0, 2, 1, 3)
    return ((pos < cap) * onehot).sum(-1) > 0


class _BlockInputs:
    """bf16: the attention, MoE and FFN blocks of every layer, held one by
    one on JAX's input.  JAX's op-by-op run records each top-level block
    call's input and output; each of the port's calls that follow is
    checked on its own input (the port's norms against JAX's), runs on
    JAX's input, is checked on its output, and hands JAX's output on, so
    the port's residual stream stays JAX's (bf16 adds of equal operands
    are equal) and its caches, aux and head are its own.  A shared
    expert's FFN inside an MoE block is part of that block."""

    BLOCKS = {"attention_apply": (jattn, tattn), "moe_apply": (jmoe, tmoe),
              "ffn_apply": (jffn, tffn)}

    def __init__(self, monkeypatch):
        self.jax, self.port, self.depth = [], [], [0]
        for name, (jmod, tmod) in self.BLOCKS.items():
            monkeypatch.setattr(jmod, name, self._jax_spy(name, getattr(jmod, name)))
            monkeypatch.setattr(tmod, name, self._port_spy(name, getattr(tmod, name)))

    def _nested(self, fn, *args, **kw):
        self.depth[0] += 1
        try:
            return fn(*args, **kw)
        finally:
            self.depth[0] -= 1

    def _jax_spy(self, name, fn):
        def spy(params, x, cfg, **kw):
            if self.depth[0]:
                return fn(params, x, cfg, **kw)
            out = self._nested(fn, params, x, cfg, **kw)
            y = out[0] if isinstance(out, tuple) else out
            self.jax.append((name, np.asarray(x, np.float32), np.asarray(y, np.float32)))
            return out
        return spy

    def _port_spy(self, name, fn):
        def spy(params, x, cfg, **kw):
            if self.depth[0]:
                return fn(params, x, cfg, **kw)
            want, x_in, y_ref = self.jax[len(self.port)]
            assert want == name, (want, name)
            out = self._nested(fn, params, torch.from_numpy(x_in).to(x.dtype), cfg, **kw)
            y = out[0] if isinstance(out, tuple) else out
            self.port.append((name, x, y))
            y_ref = torch.from_numpy(y_ref).to(y.dtype)
            return (y_ref,) + tuple(out[1:]) if isinstance(out, tuple) else y_ref
        return spy

    def check(self, flips, what):
        """Every block's input and output within 2e-2 of JAX's, an MoE
        block's output on the rows no routing flip of that call reached."""
        assert len(self.jax) == len(self.port) > 0
        flips = list(flips)
        for i, ((name, x_in, y_ref), (_, x, y)) in enumerate(zip(self.jax, self.port)):
            _rows_close(x, x_in, range(B), "bfloat16", f"{what}: block {i} ({name}) input")
            rows = set(range(B)) - (flips.pop(0) if name == "moe_apply" else set())
            _rows_close(y, y_ref, rows, "bfloat16", f"{what}: block {i} ({name}) output")
        assert not flips
        self.jax.clear()
        self.port.clear()


def _rows_close(out, ref, rows, dtype, msg):
    rows = sorted(rows)
    np.testing.assert_allclose(out.float().numpy()[rows], np.asarray(ref, np.float32)[rows],
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=msg)


def _jax_forward(jp, jcfg, tokens, **kw):
    """JAX's forward op by op (its ``top_k`` and layers can be watched)."""
    with jax.disable_jit():
        return jtf.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)}, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_return_state_and_decode_float32(arch, monkeypatch):
    """Free-running: prefill with ``return_state``, then decode steps, the
    routing equal call for call, logits, caches and aux within 1e-5."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    routings = _Routings(monkeypatch)
    jl, jc, jaux = _jax_forward(jp, jcfg, toks, return_state=True,
                                cache_capacity=PROMPT + STEPS)
    tl, tc, taux = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                               return_state=True, cache_capacity=PROMPT + STEPS)
    assert tl.shape == (B, PROMPT, 512) and set(taux) == set(jaux)
    assert len(routings.check(tcfg, PROMPT, "float32")) == \
        tcfg.n_layers - tcfg.moe.first_dense_layers
    _rows_close(tl, jl, range(B), "float32", "prefill logits")
    for key, v in taux.items():
        np.testing.assert_allclose(v.item(), float(jaux[key]), rtol=1e-6, err_msg=key)
    assert taux["moe_dropped"].item() > 0                          # capacity binds
    jleaves = dict(tcommon.tree_leaves(jax.tree.map(np.asarray, jc)))
    tleaves = dict(tcommon.tree_leaves(tc))
    assert list(jleaves) == list(tleaves)
    for path, leaf in jleaves.items():
        assert tleaves[path].shape == leaf.shape and tleaves[path].dtype == \
            (torch.int32 if path.endswith("pos") else torch.float32), path
        np.testing.assert_allclose(tleaves[path].numpy(), leaf, rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    for step in range(STEPS):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((B,), PROMPT + step, np.int32)
        jl, jc, jaux = _jax_forward(jp, jcfg, tok, cache=jc, cache_pos=jnp.asarray(pos))
        tl, tc, taux = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                   cache_pos=torch.from_numpy(pos))
        routings.check(tcfg, 1, "float32")
        assert taux["moe_dropped"].item() == float(jaux["moe_dropped"]) == 0.0  # 4 slots
        _rows_close(tl, jl, range(B), "float32", f"decode step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_bf16_block_by_block(arch, monkeypatch):
    """bf16, each block on JAX's own input (``_BlockInputs``): a layer's
    bf16 output moves by a bf16 ulp of the residual stream (0.0156 at
    magnitude 2–4) with the order of its sums, and through the depth that
    reaches the logits (JAX's own compiled and op-by-op runs of this
    prefill differ by 0.03–0.05 on rows where both route alike), so the
    blocks are held one by one, within 2e-2, in prefill and decode, and
    the logits from the residual stream they hand on."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    routings, blocks = _Routings(monkeypatch), _BlockInputs(monkeypatch)
    jl, jc, _ = _jax_forward(jp, jcfg, toks, return_state=True, cache_capacity=PROMPT + STEPS)
    tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            return_state=True, cache_capacity=PROMPT + STEPS)
    blocks.check(routings.check(tcfg, PROMPT, "bfloat16"), "prefill")
    _rows_close(tl, jl, range(B), "bfloat16", "prefill logits")
    for step in range(STEPS):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((B,), PROMPT + step, np.int32)
        jl, jc, _ = _jax_forward(jp, jcfg, tok, cache=jc, cache_pos=jnp.asarray(pos))
        tl, tc, _ = ttf.forward(tp, tcfg, {"tokens": torch.from_numpy(tok)}, cache=tc,
                                cache_pos=torch.from_numpy(pos))
        blocks.check(routings.check(tcfg, 1, "bfloat16"), f"decode step {step}")
        _rows_close(tl, jl, range(B), "bfloat16", f"decode step {step} logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_tokens(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg, seed=1)
    prompts = np.random.default_rng(3).integers(0, 512, (2, 32)).astype(np.int32)
    ref = JaxEngine(cfg=jcfg, params=jp, capacity=40, batch_size=2) \
        .generate(jnp.asarray(prompts), 8)
    out = ServeEngine(cfg=tcfg, params=tp, capacity=40, batch_size=2,
                      device="cpu").generate(torch.from_numpy(prompts), 8)
    assert out.dtype == torch.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_from_numpy_carries_the_tree_and_checks_every_leaf(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jp)
    assert [p for p, _ in tcommon.tree_leaves(tp)] == [p for p, _ in tcommon.tree_leaves(tree)]
    for path, leaf in tcommon.tree_leaves(tree):
        np.testing.assert_array_equal(dict(tcommon.tree_leaves(tp))[path].numpy(), leaf)
    slot = dict(tree["slots"][0], moe={k: v for k, v in tree["slots"][0]["moe"].items()
                                      if k != "router"})
    with pytest.raises(ValueError, match="missing"):
        convert.model_params_from_numpy(dict(tree, slots=[slot]), tcfg, "cpu")
    w_in = tree["slots"][0]["moe"]["w_in"]
    bad = dict(tree["slots"][0], moe=dict(tree["slots"][0]["moe"], w_in=w_in[..., :-1]))
    with pytest.raises(ValueError, match="w_in"):
        convert.model_params_from_numpy(dict(tree, slots=[bad]), tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_arch_on_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 16) tokens" in out and "power_gain=" in out
