"""The port's optimizer against ``repro.optim``, on the CPU, leaf for leaf.

Both sides get the same parameters, gradients and moments, made from a
numpy seed.  JAX computes the schedule, the bias corrections and the clip
scale in float32; so does the port, so the learning rate is equal to the
bit and the updates agree to float32 roundings (held to 1e-6 relative and
absolute).  bf16 moments round once per step in both; they are held to
one bf16 ulp.  The int8 compression's levels are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOpt
from repro.optim import adamw as jadamw
from repro.optim.compress import compress_gradients as jcompress
from repro.optim.schedule import make_schedule as jschedule
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import common
from repro_torch.optim import (AdamWState, adamw_init, adamw_update, compress_gradients,
                               global_norm, make_schedule)

torch.set_num_threads(1)

SHAPES = {"b": (7,), "layers": [{"w": (16, 8)}, {"w": (3, 5, 2)}], "scale": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return common.tree_map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                           SHAPES)


def _torch(tree, dtype=torch.float32):
    return common.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype),
                           tree)


def _jax(tree, dtype=jnp.float32):
    return common.tree_map(lambda a: jnp.asarray(a, jnp.float32).astype(dtype), tree)


def _pairs(t_tree, j_tree):
    jl = dict(common.tree_leaves(j_tree))
    for path, t in common.tree_leaves(t_tree):
        yield path, t.float().numpy(), np.asarray(jl[path], np.float32)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_equal(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    t, j = make_schedule(OptimizerConfig(**kw)), jschedule(JOpt(**kw))
    for step in (0, 1, 6, 7, 8, 20, 49, 50, 80):
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.item() == float(j(jnp.int32(step))), step


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (0.0, 0.0), (1e3, 0.1)])
def test_adamw_matches_jax_leaf_for_leaf(moments, clip, decay):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip,
              weight_decay=decay)
    tcfg, jcfg = OptimizerConfig(**kw), JOpt(**kw)
    p0 = _tree(0)
    tp, jp = _torch(p0), _jax(p0)
    ts, js = adamw_init(tp, moments), jadamw.adamw_init(jp, moments)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for _, m in common.tree_leaves(ts.m):
        assert m.dtype == getattr(torch, moments)
    for step in range(4):
        g = _tree(10 + step, scale=3.0)
        tp, ts, tm = adamw_update(tcfg, _torch(g), ts, tp)
        jp, js, jm = jadamw.adamw_update(jcfg, _jax(g), js, jp)
        assert tm["lr"].item() == float(jm["lr"])
        assert tm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for path, a, b in _pairs(tp, jp):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=path)
        for tree_t, tree_j in ((ts.m, js.m), (ts.v, js.v)):
            for path, a, b in _pairs(tree_t, tree_j):
                tol = 2 ** -7 if moments == "bfloat16" else 1e-6
                np.testing.assert_allclose(a, b, rtol=tol, atol=1e-7, err_msg=path)


def test_adamw_is_functional():
    tp = _torch(_tree(0))
    before = common.tree_map(torch.clone, tp)
    state = adamw_init(tp)
    adamw_update(OptimizerConfig(), _torch(_tree(1)), state, tp)
    for (_, a), (_, b) in zip(common.tree_leaves(tp), common.tree_leaves(before)):
        assert torch.equal(a, b)
    assert int(state.step) == 0
    assert isinstance(state, AdamWState)


def test_global_norm_matches_jax():
    g = _tree(4, scale=5.0)
    assert global_norm(_torch(g)).item() == pytest.approx(float(jadamw.global_norm(_jax(g))),
                                                          rel=1e-6)
    t = {"a": torch.ones(4), "b": torch.ones(9)}
    assert np.isclose(float(global_norm(t)), np.sqrt(13.0))


def test_compress_matches_jax_with_error_feedback():
    terr = jerr = None
    for step in range(5):
        g = _tree(20 + step, scale=0.01)
        tdeq, terr = compress_gradients(_torch(g), terr)
        jdeq, jerr = jcompress(_jax(g), jerr)
        for path, a, b in _pairs(tdeq, jdeq):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=path)
        for path, a, b in _pairs(terr, jerr):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9, err_msg=path)


def test_compress_rounds_half_to_even():
    """Levels land exactly on .5 at scale 1: 127 is the max, so g/scale is
    0.5, 1.5, 2.5 … and must round as ``jnp.round`` does (to even)."""
    g = {"g": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5])}
    deq, err = compress_gradients(g, None)
    jdeq, _ = jcompress({"g": jnp.asarray(g["g"].numpy())}, None)
    np.testing.assert_array_equal(deq["g"].numpy(), np.asarray(jdeq["g"]))
    assert deq["g"][1:4].tolist() == pytest.approx([0.0, 2.0, 2.0], abs=1e-5)


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal(256).astype(np.float32) * 0.01)
    err, acc = None, torch.zeros(256)
    for _ in range(64):
        deq, err = compress_gradients({"g": g_true}, err)
        acc = acc + deq["g"]
    np.testing.assert_allclose((acc / 64).numpy(), g_true.numpy(), atol=2e-4)


def test_adamw_converges_on_quadratic_bf16_moments():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    cfg = OptimizerConfig(learning_rate=0.1, warmup_steps=1, total_steps=400,
                          weight_decay=0.0, schedule="constant")
    state = adamw_init(params, moment_dtype="bfloat16")
    for _ in range(400):
        params, state, _ = adamw_update(cfg, {"w": 2 * (params["w"] - target)}, state, params)
    assert state.m["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=5e-2)
