"""Training step factory: loss, gradient accumulation, AdamW (port of
``repro.train.step``).

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``.  Parameters are float32 masters; the forward casts
each weight to ``cfg.dtype`` where it uses it, as serving does, so the
activations follow the config.  Microbatching is a Python loop over batch
slices (the reference's ``lax.scan``) that accumulates the gradients in
``tcfg.grad_accum_dtype`` and the metrics as they come, then scales both by
``1/microbatch``.  Then int8 compression when the optimizer asks for it,
then AdamW.  Gradients come from ``torch.autograd.grad`` on the parameter
leaves; a leaf that the loss does not reach (hubert's token embedding)
gets zeros, the gradient JAX gives it.

Under sharding rules with a ``DeviceMesh`` whose data axis has two or
more ranks (``launch.train`` under ``torchrun``) each rank holds its own
rows of the global batch and the step computes what the reference's one
program computes over the whole batch: the loss
divides by the global masked-token count, each MoE layer mean counts as
1/ranks of the global mean (every rank holds the same number of whole
routing groups), so every rank's loss is its share of the global loss and
the gradients, metrics and clipping norm are sums over the ``data`` group.
A leaf held as an FSDP shard gets its gradient summed by the gather's
reduce-scatter; the others are all-reduced.  AdamW then updates each
rank's leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import common, transformer
from repro_torch.models import moe as moe_mod
from repro_torch.optim import adamw_update, compress_gradients
from repro_torch.parallel import sharding as shd


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, metrics)``: cross-entropy with
    z-loss and mask, plus the MoE aux loss of the layer-mean aux terms."""
    n_moe_layers = max(1, cfg.n_layers - (cfg.moe.first_dense_layers if cfg.moe else 0))

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, _, aux = transformer.forward(params, cfg, batch)
        group, mask, denom = shd.data_group(), batch.get("mask"), None
        if group is not None:
            count = (torch.sum(mask.float()) if mask is not None else
                     torch.tensor(float(batch["labels"].numel()), device=logits.device))
            denom = shd.all_reduce_sum(count, group)
        total, metrics = common.cross_entropy(logits, batch["labels"], z_loss=tcfg.z_loss,
                                              mask=mask, denom=denom)
        if cfg.moe is not None:
            mean_aux = {k: v / n_moe_layers for k, v in aux.items()}
            if group is not None:
                ranks = dist.get_world_size(group)
                mean_aux = {k: v / ranks for k, v in mean_aux.items()}
            total = total + moe_mod.moe_aux_loss(cfg, mean_aux)
            metrics.update(mean_aux)
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``grad_fn(params, batch) -> (loss, metrics, grads)`` for one pass.
    ``grads`` has the parameters' structure; a leaf the loss does not reach
    is ``None`` (``train_step`` turns it into zeros), so a caller can see
    which leaves autograd reached."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def grad_fn(params, batch):
        leaves = common.tree_leaves(params)
        live = {path: p.detach().requires_grad_() for path, p in leaves}
        with torch.enable_grad():
            loss, metrics = loss_fn(common.place_leaves(params, live), batch)
            grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, common.place_leaves(params, dict(zip(live, grads)))

    return grad_fn


def _zeros_for_none(grads: Any, params: Any, dtype=None) -> Any:
    flat = dict(common.tree_leaves(params))
    return common.place_leaves(params, {
        path: (torch.zeros_like(flat[path]) if g is None else g).to(dtype or flat[path].dtype)
        for path, g in common.tree_leaves(grads)})


def _reduce_over_data(cfg: ModelConfig, grads: Any, metrics: Dict[str, torch.Tensor], group):
    """Sum each rank's share of the gradients and metrics over the data
    group.  Returns the grads, the metrics and the paths of the leaves held
    as shards (their gradients are summed already)."""
    specs = shd.fsdp_specs(transformer.model_layout(cfg))
    sharded = set() if specs is None else {
        path for path, spec in common.tree_leaves(specs) if shd.over_data(spec)}
    for path, g in common.tree_leaves(grads):
        if path not in sharded:
            shd.all_reduce_sum(g, group)
    keys = sorted(metrics)
    summed = shd.all_reduce_sum(torch.stack([metrics[k].float() for k in keys]), group)
    return grads, dict(zip(keys, summed.unbind())), sharded


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    grad_fn = make_grad_fn(cfg, tcfg)
    ocfg = tcfg.optimizer

    def train_step(params, opt_state, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            n = tcfg.microbatch
            b = next(iter(batch.values())).shape[0]
            assert all(x.shape[0] == b for x in batch.values()) and b % n == 0, (b, n)
            acc_dt = getattr(torch, tcfg.grad_accum_dtype)
            size = b // n
            g_acc = m_acc = None
            for i in range(n):
                mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
                _, metrics, grads = grad_fn(params, mb)
                flat = dict(common.tree_leaves(_zeros_for_none(grads, params, acc_dt)))
                if g_acc is None:
                    g_acc, m_acc = flat, metrics
                else:
                    g_acc = {path: a + flat[path] for path, a in g_acc.items()}
                    m_acc = {key: m_acc[key] + v for key, v in metrics.items()}
            k = 1.0 / n
            grads = common.place_leaves(params, {path: g * k for path, g in g_acc.items()})
            metrics = {key: v * k for key, v in m_acc.items()}
        else:
            _, metrics, grads = grad_fn(params, batch)
            grads = _zeros_for_none(grads, params)
        group, sharded = shd.data_group(), ()
        if group is not None:
            grads, metrics, sharded = _reduce_over_data(cfg, grads, metrics, group)
        if ocfg.compress_grads:
            grads, _ = compress_gradients(grads, None, sharded, group)
        params, opt_state, om = adamw_update(ocfg, grads, opt_state, params, sharded=sharded,
                                             group=group)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
