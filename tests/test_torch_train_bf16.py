"""One training step of every architecture, REDUCED, in its config dtype,
through the port and through ``repro.train.step``, on the CPU.

The same JAX-initialised weights and the same pipeline batch go into
both; the JAX side is its jitted loss gradient (``make_loss_fn``, as
``make_train_step`` takes it) and ``adamw_update``.  In bf16 each matmul output rounds to bf16 at other places in the
two packages, so the loss is held to 2e-2 relative; every gradient leaf
must be finite, and a leaf that autograd does not reach (``None`` from
``make_grad_fn``: hubert's unused token embedding, zamba2's unread ``D``)
must have a JAX gradient of exactly zero; every parameter moves except
where JAX's does not.  falcon-mamba-7b trains here through the scan's
autograd Function, whose CPU backward is the plain one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JTrain
from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import common
from repro_torch.optim import adamw_init
from repro_torch.train import make_grad_fn, make_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_step_in_config_dtype(arch):
    jcfg, tcfg = jax_config(arch, True), get_config(arch, True)
    jp = jcommon.init_params(jax.random.PRNGKey(0), jtf.model_layout(jcfg))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    pipe = SyntheticPipeline(DataConfig(global_batch=2, seq_len=32,
                                        vocab_size=jcfg.vocab_size), jcfg)
    batch = next(pipe)
    pipe.close()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (_, jm), jgrads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jcfg, JTrain()),
                                                 has_aux=True))(jp, jb)
    jnew, _, _ = jax.jit(functools.partial(jadamw.adamw_update, JTrain().optimizer))(
        jgrads, jadamw.adamw_init(jp, jcfg.moment_dtype), jp)
    _, tm0, grads = make_grad_fn(tcfg, TrainConfig())(tp, tb)
    tnew, ts, tm = make_train_step(tcfg, TrainConfig())(tp, adamw_init(tp, tcfg.moment_dtype),
                                                        tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2)
    assert float(tm0["loss"]) == float(tm["loss"])
    jg = dict(common.tree_leaves(jax.tree.map(np.asarray, jgrads)))
    jmoved = dict(common.tree_leaves(jax.tree.map(lambda a, b: np.asarray(a != b), jnew, jp)))
    old = dict(common.tree_leaves(tp))
    for path, g in common.tree_leaves(grads):
        if g is None:
            assert not np.any(jg[path]), path
        else:
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
    for path, p in common.tree_leaves(tnew):
        assert torch.isfinite(p).all(), path
        assert bool((p != old[path]).any()) == bool(jmoved[path].any()), path
    for _, m in common.tree_leaves(ts.m):
        assert m.dtype == getattr(torch, tcfg.moment_dtype)
