"""AdamW with dtype-configurable moments (port of ``repro.optim.adamw``).

Parameters are float32 masters; the moments are ``moment_dtype``
(bfloat16 for llama3-405b, float32 otherwise).  Everything the JAX
package computes in float32 — the schedule, ``b1 ** step``, ``b2 ** step``
and the clip scale — is a float32 tensor here too, not a Python float,
so the updates round as the reference's do.  The update is functional, as
the reference's: new parameter and moment tensors come back and the
inputs are left as they are.  ``opt_state_layout`` gives the state's
layout for the dry run (``launch.dryrun``), leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef
from repro_torch.optim.schedule import make_schedule
from repro_torch.parallel import sharding as shd


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def opt_state_layout(layout: Any, moment_dtype: str = "float32") -> AdamWState:
    """The ``ParamDef`` tree of the optimizer state of a model ``layout``:
    the step a scalar, m and v the layout itself (the moments take the
    parameters' shardings).  ``moment_dtype`` is the reference's argument
    and changes nothing: a layout has no dtype."""
    del moment_dtype
    return AdamWState(step=ParamDef((), (), "zeros"), m=common.tree_map(lambda d: d, layout),
                      v=common.tree_map(lambda d: d, layout))


def _first_leaf(tree: Any) -> torch.Tensor:
    return next(iter(common.tree_leaves(tree)))[1]


def adamw_init(params: Any, moment_dtype: str = "float32") -> AdamWState:
    """Zero moments in ``moment_dtype`` shaped like ``params``, step 0
    (int32), all on the parameters' device."""
    dt = getattr(torch, moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_first_leaf(params).device),
                      m=common.tree_map(zeros, params), v=common.tree_map(zeros, params))


def global_norm(tree: Any, sharded: Collection[str] = (), group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.

    ``sharded`` names the leaves (by path) that hold only this rank's
    shard: their sums of squares are added over ``group`` first."""
    leaves = list(common.tree_leaves(tree))
    sums = torch.stack([torch.sum(torch.square(x.float())) for _, x in leaves])
    if sharded:
        held = torch.tensor([path in sharded for path, _ in leaves], device=sums.device)
        total = shd.all_reduce_sum(torch.where(held, sums, 0.0), group)
        sums = torch.where(held, total, sums)
    return torch.sqrt(torch.sum(sums))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Any, state: AdamWState,
                 params: Any, *, sharded: Collection[str] = (), group=None
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step (global-norm clipping, decoupled decay).  Returns
    ``(params, state, {"grad_norm", "lr"})``.  ``sharded`` and ``group``
    go to :func:`global_norm`."""
    lr = make_schedule(cfg)(state.step)
    step = state.step + 1
    gnorm = global_norm(grads, sharded, group)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=gnorm.device)
    if cfg.grad_clip > 0:
        scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    else:
        scale = f32(1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - f32(b1) ** step.float()
    c2 = 1.0 - f32(b2) ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * torch.square(g)
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p_new = p.float() - lr * (update + cfg.weight_decay * p.float())
        return p_new.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    paths = [path for path, _ in common.tree_leaves(params)]
    flat = [dict(common.tree_leaves(t)) for t in (params, grads, state.m, state.v)]
    new = {path: upd(*(f[path] for f in flat)) for path in paths}
    place = lambda i: common.place_leaves(params, {p: t[i] for p, t in new.items()})
    return (place(0), AdamWState(step=step, m=place(1), v=place(2)),
            {"grad_norm": gnorm, "lr": lr})
