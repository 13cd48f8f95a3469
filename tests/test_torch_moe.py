"""The port's ``models/moe.py`` (dispatch by index) against the JAX
package's one-hot ``moe_apply``, on the CPU.

Both REDUCED MoE configs (qwen3-moe: no shared expert; deepseek-v2: one).
Routing is held to the reference's intermediates, recomputed here with
the reference's own lines (``_jax_routing``, tied to the reference by its
``moe_dropped``): experts in ``jax.lax.top_k``'s order, ``keep`` and
``slot`` equal, gates within 1e-6.  Outputs are held to 1e-5 in float32
and 2e-2 in bf16, aux values to 1e-6 (``moe_dropped`` exactly).  In bf16
both packages route the same bf16 input from the float32 router, so a
flip can only sit where two probabilities are closer than the packages'
float32 router disagreement (``test_bf16_routing_flips_only_at_near_ties``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import FP32_LEAVES, _serving_copy

ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: (B, S) shapes: two groups of 64 (REDUCED group_size); 40 tokens, below it
SHAPES = {"two_groups": (2, 64), "below_group": (1, 40)}


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype))


def _params(jcfg, seed=0):
    """MoE weights from the JAX package's init; the port's as float32 tensors."""
    jp = jcommon.init_params(jax.random.PRNGKey(seed), jmoe.moe_layout(jcfg))
    tp = tcommon.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(shape, dtype, seed=1, shift=0.0):
    """numpy-seeded activations in ``dtype`` for both packages, each token
    scaled to unit RMS as the layer's ``rms_norm`` hands them to the MoE;
    ``shift`` adds one shared direction to every token first (it crowds
    the router)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32) + shift * rng.standard_normal(shape[-1:],
                                                                              np.float32)
    x /= np.sqrt(np.mean(np.square(x), axis=-1, keepdims=True))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(tx.float().numpy()).astype(dtype), tx


def _jax_routing(router, xg, cfg):
    """The reference's routing intermediates, by its own lines
    (``repro/models/moe.py:73-94``): probs, expert_idx, gates, keep, slot."""
    m = cfg.moe
    n_groups, gs, _ = xg.shape
    cap = jmoe._capacity(gs, cfg)
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32), router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, m.top_k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(n_groups, m.top_k * gs, m.n_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = pos.reshape(n_groups, m.top_k, gs, m.n_experts).transpose(0, 2, 1, 3)
    keep = (pos < cap) * onehot
    slot = jnp.sum(pos * keep, axis=-1)
    return tuple(np.asarray(a) for a in (probs, idx, gate, keep.sum(-1) > 0, slot))


def _port_routing(tp, tx, tcfg):
    b, s, d = tx.shape
    gs = min(tcfg.moe.group_size, b * s)
    return tmoe.route(tp["router"], tx.reshape(-1, gs, d), tcfg, tmoe._capacity(gs, tcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_capacity_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    for cfg_j, cfg_t in ((jcfg, tcfg), (jax_config(arch), get_config(arch))):
        jl = dict(tcommon.tree_leaves(jmoe.moe_layout(cfg_j)))
        tl = dict(tcommon.tree_leaves(tmoe.moe_layout(cfg_t)))
        assert list(jl) == list(tl)
        for path, d in jl.items():
            assert (tl[path].shape, tl[path].axes, tl[path].init) == (d.shape, d.axes, d.init)
            assert tl[path].scale == pytest.approx(d.scale, rel=1e-12), path
        assert ("shared/w_in" in tl) == bool(cfg_t.moe.n_shared)
        for gs in (1, 2, 40, 64, 512, 4096):
            assert tmoe._capacity(gs, cfg_t) == jmoe._capacity(gs, cfg_j), gs
    # qwen3 at full width: a 4096-token group gives 320 slots, a 512-token one 40
    q = get_config("qwen3-moe-235b-a22b")
    assert (tmoe._capacity(4096, q), tmoe._capacity(512, q), tmoe._capacity(2, q)) == (320, 40, 4)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_jax(arch, shape):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jx, tx = _x(SHAPES[shape] + (jcfg.d_model,), "float32")
    r = _port_routing(tp, tx, tcfg)
    gs = r.probs.shape[1]
    probs, idx, gate, keep, slot = _jax_routing(jp["router"], jx.reshape(-1, gs, jcfg.d_model),
                                                jcfg)
    np.testing.assert_allclose(r.probs.numpy(), probs, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_allclose(r.gate.numpy(), gate, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot.astype(np.int64))
    # the copied lines are the reference's: its moe_dropped is theirs
    _, aux = jmoe.moe_apply(jp, jx, jcfg)
    assert float(aux["moe_dropped"]) == pytest.approx(1 - keep.mean(), abs=1e-7)


CASES = {
    "two_groups": dict(shape=(2, 64)),
    "below_group": dict(shape=(1, 40)),
    # one shared direction in every token crowds a few experts past capacity
    "overflow": dict(shape=(2, 64), shift=3.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, case, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg)
    c = CASES[case]
    jx, tx = _x(c["shape"] + (jcfg.d_model,), dtype, shift=c.get("shift", 0.0))
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert set(taux) == set(jaux)
    for k in ("moe_load_balance", "moe_router_z"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-6, err_msg=k)
    assert taux["moe_dropped"].item() == pytest.approx(float(jaux["moe_dropped"]), abs=1e-7)
    if case == "overflow":
        assert taux["moe_dropped"].item() > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(tmoe.moe_aux_loss(tcfg, taux).item(),
                                   float(jmoe.moe_aux_loss(jcfg, jaux)), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_probabilities_route_in_jax_top_k_order(arch):
    """A zero router: every probability ties, so every token takes experts
    0..k-1 in that order, and the queues past capacity drop (both packages)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = _x((2, 64, jcfg.d_model), "float32")
    r = _port_routing(tp, tx, tcfg)
    k = tcfg.moe.top_k
    assert (r.expert_idx == torch.arange(k)).all()
    _, idx, _, keep, slot = _jax_routing(jp["router"], jx.reshape(2, 64, -1), jcfg)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot.astype(np.int64))
    cap = tmoe._capacity(64, tcfg)
    assert r.keep[:, :cap].all() and not r.keep[:, cap:].any()     # tokens past cap drop
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert taux["moe_dropped"].item() == pytest.approx(float(jaux["moe_dropped"]), abs=1e-7)
    assert taux["moe_dropped"].item() == pytest.approx(1 - cap / 64)


def _one_hot_dispatch_combine(tp, tx, tcfg):
    """The reference's formulation in torch: one-hot ``disp`` / ``comb``
    ``[g, s, e, C]`` einsums around the same routing and experts."""
    b, s, d = tx.shape
    gs = min(tcfg.moe.group_size, b * s)
    cap = tmoe._capacity(gs, tcfg)
    xg = tx.reshape(-1, gs, d)
    r = tmoe.route(tp["router"], xg, tcfg, cap)
    keep = torch.nn.functional.one_hot(r.expert_idx, tcfg.moe.n_experts).float() \
        * r.keep[..., None]
    slot_oh = torch.nn.functional.one_hot(r.slot, cap).float()
    disp = torch.einsum("gske,gskc->gsec", keep, slot_oh)
    comb = torch.einsum("gsk,gske,gskc->gsec", r.gate, keep, slot_oh)
    xe = torch.einsum("gsec,gsd->gecd", disp.to(tx.dtype), xg)
    ye = tmoe.experts(tp, xe.transpose(0, 1).contiguous(), tcfg)
    y = torch.einsum("gsec,egcd->gsd", comb.to(tx.dtype), ye)
    return xe, r, y.reshape(b, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_index_dispatch_equals_one_hot(arch, dtype):
    """``xe`` bit-equal to the one-hot dispatch; the combine within the
    dtype's tolerance (only the order of the k terms differs).  The shared
    expert is left out on both sides."""
    _, tcfg = _cfgs(arch, dtype)
    tp = tcommon.init_params(torch.Generator().manual_seed(0), tmoe.moe_layout(tcfg))
    _, tx = _x((2, 64, tcfg.d_model), dtype, shift=2.0)
    xe_ref, r, y_ref = _one_hot_dispatch_combine(tp, tx, tcfg)
    xe = tmoe.dispatch(tx.reshape(2, 64, -1), r, tcfg.moe.n_experts, xe_ref.shape[2])
    assert r.keep.sum() < r.keep.numel()                              # some pairs dropped
    assert torch.equal(xe.transpose(0, 1), xe_ref)
    y = tmoe.combine(tmoe.experts(tp, xe, tcfg), r).reshape(tx.shape)
    np.testing.assert_allclose(y.float().numpy(), y_ref.float().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_routing_flips_only_at_near_ties(arch):
    """bf16 activations, the float32 router: both packages round the same
    bf16 input to float32, so they route alike except where the k-th and
    (k+1)-th probabilities are closer than twice their largest probability
    difference; any token whose expert set differs must be such a tie."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _params(jcfg)
    for seed in range(4):
        jx, tx = _x((2, 64, jcfg.d_model), "bfloat16", seed=seed)
        r = _port_routing(tp, tx, tcfg)
        probs, idx, _, _, _ = _jax_routing(jp["router"], jx.reshape(2, 64, -1), jcfg)
        disagree = np.abs(r.probs.numpy() - probs).max()
        assert disagree < 1e-6
        flips = np.array([set(a) != set(b) for a, b in
                          zip(r.expert_idx.reshape(-1, tcfg.moe.top_k).tolist(),
                              idx.reshape(-1, tcfg.moe.top_k).tolist())])
        k = tcfg.moe.top_k
        top = -np.sort(-probs.reshape(-1, probs.shape[-1]), axis=-1)
        gap = top[:, k - 1] - top[:, k]
        assert (gap[flips] <= 2 * disagree).all(), (seed, gap[flips], disagree)


def test_engine_keeps_the_router_float32_and_routes_as_jax():
    """The engine's bf16 serving copy keeps ``router`` (and MLA's
    ``kv_norm``) in float32.  A float32 router that is not bf16-exact then
    routes the bf16 activations as JAX routes them from its float32 master;
    the same router rounded to bf16 routes some tokens elsewhere."""
    assert {"router", "kv_norm"} <= set(FP32_LEAVES)
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", "bfloat16")
    jp, tp = _params(jcfg, seed=3)
    router = tp["router"]
    assert not torch.equal(router.to(torch.bfloat16).float(), router)    # not bf16-exact
    served = _serving_copy(tp, torch.bfloat16, torch.device("cpu"))
    assert served["router"].dtype == torch.float32 and torch.equal(served["router"], router)
    assert served["w_in"].dtype == torch.bfloat16
    jx, tx = _x((64, 64, jcfg.d_model), "bfloat16", seed=5)
    _, idx, _, keep, _ = _jax_routing(jp["router"], jx.reshape(64, 64, -1), jcfg)
    r = _port_routing(served, tx, tcfg)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    rounded = _port_routing(dict(served, router=router.to(torch.bfloat16)), tx, tcfg)
    assert not torch.equal(rounded.expert_idx, r.expert_idx)


def test_tokens_must_fill_whole_groups():
    _, tcfg = _cfgs("qwen3-moe-235b-a22b")
    tp = tcommon.init_params(torch.Generator().manual_seed(0), tmoe.moe_layout(tcfg))
    with pytest.raises(ValueError, match="whole number of groups"):
        tmoe.moe_apply(tp, torch.zeros(1, 80, tcfg.d_model), tcfg)
