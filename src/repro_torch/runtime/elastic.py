"""Elastic scaling: re-mesh and re-shard state when the fleet changes
(port of ``repro.runtime.elastic``).

Checkpoint leaves are stored whole (host numpy), so moving between mesh
sizes is a re-placement: build the new mesh, resolve the same layout
against it (the divisibility-checked rules keep a dimension whole when
its axis stops dividing it), and keep each rank's shard.
``shrink_mesh_plan`` picks the largest (data × model) grid that fits the
surviving chip count while keeping the model axis large enough for the
arch's weights.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import mesh_device
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.checkpoint import tree_flatten, tree_unflatten


def shrink_mesh_plan(n_alive: int, prefer_model: int = 16
                     ) -> Tuple[int, int]:
    """(data, model) for the largest usable grid ≤ n_alive chips.

    Keeps the model axis at ``prefer_model`` if possible (weights must
    still fit per-chip), else the largest power-of-two divisor.
    """
    model = prefer_model
    while model > 1 and n_alive // model < 1:
        model //= 2
    data = n_alive // model
    # largest power of two ≤ data (collectives want power-of-two groups)
    p = 1
    while p * 2 <= data:
        p *= 2
    return p, model


def reshard_tree(tree: Any, layout: Any, new_rules: shd.ShardingRules,
                 rules: Optional[shd.ShardingRules] = None) -> Any:
    """Re-place every leaf of ``tree`` by ``layout`` (a ``ParamDef`` per
    leaf, in flatten order) under ``new_rules``.

    Each leaf goes to the host whole, one at a time — gathered over the
    mesh of ``rules`` (default: the active rules), under which ``tree`` is
    placed — and this rank cuts its shard under
    ``new_rules.resolve(d.axes, d.shape)`` there and moves only the shard
    to the new mesh's device (the whole leaf to its own device without a
    mesh).  Every rank of both meshes calls it."""
    rules = rules or shd.active_rules()
    defs, leaves = tree_flatten(layout), tree_flatten(tree)
    if len(defs) != len(leaves):
        raise ValueError(f"{len(defs)} layout leaves for {len(leaves)} tree leaves")
    out, mesh = [], new_rules.mesh
    for d, leaf in zip(defs, leaves):
        if isinstance(rules.mesh, DeviceMesh):
            host = shd.NamedSharding(rules.mesh, rules.resolve(d.axes, d.shape)
                                     ).gather(leaf).cpu()
        else:
            host = leaf.cpu()
        if not isinstance(mesh, DeviceMesh):
            out.append(host.to(leaf.device))
            continue
        out.append(shd.NamedSharding(mesh, new_rules.resolve(d.axes, d.shape))
                   .shard(host).to(mesh_device(mesh)))
    return tree_unflatten(tree, out)
