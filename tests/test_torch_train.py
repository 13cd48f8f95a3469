"""The port's training step against ``repro.train.step``, on the CPU, in
float32.

Both packages start from the JAX package's initial weights (carried over
by ``convert.model_params_from_numpy``) and take the same pipeline
batches; the JAX side is its jitted ``make_train_step``.  The configs'
``dtype`` is replaced with float32, so the two compute the same function
with sums in other orders:

* each step's metrics within 1e-5 relative; ``accuracy`` and ``lr`` equal
  (with ``compress_grads`` the optimizer's ``grad_norm`` is that of the
  int8-quantized gradients, where a level picked differently moves it:
  1e-4);
* each step's gradients within 1e-4 of each leaf's largest magnitude;
* params, m and v after 3 steps (lr 1e-3) within 1e-5 at all but 0.1 % of
  each leaf's elements (2 in a leaf of fewer than 2000).  The rest are where Adam divides a near-zero
  gradient's float32 noise by its own root-mean-square (up to 2·lr a
  step for a parameter), or, with ``compress_grads``, where a gradient
  lies within rounding noise of an int8 level's boundary and the two
  packages pick neighbouring levels; those are held to 2·lr·steps
  (params) and 2 % of the leaf's largest magnitude (m, v).

Models: llama3.2-1b REDUCED (microbatch 0 and 2, ``compress_grads`` off
and on), gemma2-2b REDUCED at S = 96 (softcap, window 32, final softcap)
qwen3-moe REDUCED (routing, aux losses) and falcon-mamba-7b REDUCED (the
selective scan's autograd Function and its plain backward).  Also: a JAX-written
checkpoint of (params, opt_state) after 2 steps restored in the port
continues to JAX's step 3; and remat runs each period layer's attention
forward twice a step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import TrainConfig as JTrain
from repro.data.pipeline import DataConfig, _sample
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.optim.adamw import adamw_init as jadamw_init
from repro.runtime.checkpoint import CheckpointManager as JCkpt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common
from repro_torch.optim import adamw_init
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import make_grad_fn, make_train_step

torch.set_num_threads(1)

LR = 1e-3
STEPS = 3
OUTLIERS = 1e-3


def _setup(arch, microbatch=0, compress=False, **over):
    jcfg = dataclasses.replace(jax_config(arch, True), dtype="float32", **over)
    tcfg = dataclasses.replace(get_config(arch, True), dtype="float32", **over)
    kw = dict(learning_rate=LR, warmup_steps=2, total_steps=10, compress_grads=compress)
    jt = JTrain(optimizer=JOpt(**kw), microbatch=microbatch)
    tt = TrainConfig(optimizer=OptimizerConfig(**kw), microbatch=microbatch)
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jt, tt, jp, tp


def _batches(cfg, n, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    return [_sample(rng, DataConfig(global_batch=batch, seq_len=seq,
                                    vocab_size=cfg.vocab_size)) for _ in range(n)]


def _leaves(tree):
    return dict(common.tree_leaves(jax.tree.map(np.asarray, tree)))


def _hold_metrics(tm, jm, where, compress=False):
    assert set(tm) == set(jm), where
    for k, v in jm.items():
        rel = 1e-4 if (compress and k == "grad_norm") else 1e-5
        if k in ("accuracy", "lr"):
            assert float(tm[k]) == float(v), f"{where} {k}"
        else:
            assert float(tm[k]) == pytest.approx(float(v), rel=rel, abs=1e-7), f"{where} {k}"


def _hold_grads(tg, jg, where):
    want = _leaves(jg)
    for path, g in common.tree_leaves(tg):
        w = want[path]
        if g is None:   # autograd did not reach the leaf: JAX's grad is exactly 0
            assert not np.any(w), f"{where} {path}"
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{where} {path}")


def _hold_state(t_tree, j_tree, bound, where):
    want = _leaves(j_tree)
    for path, t in common.tree_leaves(t_tree):
        a, w = t.float().numpy(), np.asarray(want[path], np.float32)
        off = np.abs(a - w) > 1e-5 * (1 + np.abs(w))
        assert off.sum() <= max(2, OUTLIERS * off.size), f"{where} {path}: {off.sum()} of {off.size}"
        lim = bound if bound is not None else 0.02 * max(np.abs(w).max(), 1e-30)
        assert np.abs(a - w).max() <= lim, f"{where} {path}"


def _run(arch, seq=32, batch=4, microbatch=0, compress=False, **over):
    jcfg, tcfg, jt, tt, jp, tp = _setup(arch, microbatch, compress, **over)
    js, ts = jadamw_init(jp), adamw_init(tp)
    jfn = jax.jit(jstep.make_train_step(jcfg, jt))
    jgrad = jax.jit(jax.grad(lambda p, b: jstep.make_loss_fn(jcfg, jt)(p, b)[0]))
    tfn, tgrad = make_train_step(tcfg, tt), make_grad_fn(tcfg, tt)
    for i, b in enumerate(_batches(jcfg, STEPS, batch, seq)):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        _hold_grads(tgrad(tp, tb)[2], jgrad(jp, jb), f"step {i}")
        jp, js, jm = jfn(jp, js, jb)
        tp, ts, tm = tfn(tp, ts, tb)
        _hold_metrics(tm, jm, f"step {i}", compress)
    assert int(ts.step) == int(js.step) == STEPS
    _hold_state(tp, jp, 2 * LR * STEPS, "params")
    _hold_state(ts.m, js.m, None, "m")
    _hold_state(ts.v, js.v, None, "v")


@pytest.mark.parametrize("microbatch,compress", [(0, False), (2, False), (0, True), (2, True)])
def test_llama_train_steps_match_jax(microbatch, compress):
    _run("llama3.2-1b", microbatch=microbatch, compress=compress)


def test_gemma2_train_steps_match_jax():
    cfg = get_config("gemma2-2b", True)
    assert cfg.attention.attn_softcap and cfg.final_softcap
    assert cfg.attention.sliding_window == 32
    _run("gemma2-2b", seq=96, batch=2)


def test_qwen3_moe_train_steps_match_jax():
    _run("qwen3-moe-235b-a22b", seq=32, batch=2)


def test_falcon_mamba_train_steps_match_jax():
    """Mamba-1 through ``SelectiveScan``: the plain scan forward and
    ``selective_scan_bwd_ref`` against JAX's differentiated chunked scan."""
    assert get_config("falcon-mamba-7b", True).remat
    _run("falcon-mamba-7b", seq=32, batch=2)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """JAX trains 2 steps and saves (params, opt_state) with its own
    CheckpointManager; the port restores it onto its own template and
    takes step 3, which matches JAX's step 3."""
    jcfg, tcfg, jt, tt, jp, tp = _setup("llama3.2-1b")
    batches = _batches(jcfg, 3, 4, 32)
    jfn = jax.jit(jstep.make_train_step(jcfg, jt))
    js = jadamw_init(jp)
    for b in batches[:2]:
        jp, js, _ = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    JCkpt(str(tmp_path)).save((jp, js), step=2, blocking=True)
    template = (common.tree_map(torch.zeros_like, tp), adamw_init(tp))
    (tp, ts), step = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 2 and int(ts.step) == 2 and ts.step.dtype == torch.int32
    _hold_state(tp, jp, 0.0, "restored params")
    _hold_state(ts.m, js.m, 0.0, "restored m")
    jp, js, jm = jfn(jp, js, {k: jnp.asarray(v) for k, v in batches[2].items()})
    tp, ts, tm = make_train_step(tcfg, tt)(tp, ts, {k: torch.from_numpy(v)
                                                   for k, v in batches[2].items()})
    _hold_metrics(tm, jm, "step 3")
    _hold_state(tp, jp, 2 * LR, "params")
    _hold_state(ts.v, js.v, None, "v")


@pytest.mark.parametrize("remat", [True, False])
def test_remat_runs_attention_forward_twice(monkeypatch, remat):
    """With ``remat`` each period layer runs under ``torch.utils.checkpoint``:
    its attention forward runs in the forward and again in the backward;
    the loss and grads are the same as without it."""
    _, tcfg, _, tt, _, tp = _setup("llama3.2-1b")
    tcfg = dataclasses.replace(tcfg, remat=remat)
    calls = []
    forward = fa_ops._forward
    monkeypatch.setattr(fa_ops, "_forward", lambda *a, **k: calls.append(1) or forward(*a, **k))
    b = {k: torch.from_numpy(v) for k, v in _batches(tcfg, 1, 2, 32)[0].items()}
    loss, _, grads = make_grad_fn(tcfg, tt)(tp, b)
    assert len(calls) == tcfg.n_layers * (2 if remat else 1)
    assert all(g is not None and torch.isfinite(g).all()
               for _, g in common.tree_leaves(grads))
    if remat:
        loss0, _, grads0 = make_grad_fn(dataclasses.replace(tcfg, remat=False), tt)(tp, b)
        assert loss.item() == loss0.item()
        for (_, a), (_, c) in zip(common.tree_leaves(grads), common.tree_leaves(grads0)):
            torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)
