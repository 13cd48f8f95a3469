"""Logical-axis sharding (port of ``repro.parallel.sharding``): one rule
table maps model-space axis names to mesh axes; divisibility is checked
per tensor, so a dimension that does not divide its mesh axes is kept
whole (kv_heads = 8 on a 16-way model axis).

Parallelism styles expressed through the rules:
  DP    — "batch" → data (and pod, multi-pod)
  TP    — "heads"/"mlp"/"vocab"/"inner" → model
  EP    — "expert" → model
  FSDP  — "embed" → data (+ pod for the largest archs): parameters and
          both AdamW moments kept as each rank's shard, gathered per layer
  SP    — "seq" / "kv_seq" → model

The rules resolve the same specs as the reference's for every layout and
mesh, shape-only meshes included (a ``.shape`` mapping is enough), so a
dry run can price a 256-chip mesh on one host.  What runs is narrower.

**Training: one process per rank.**  ``launch.train`` runs under
``torchrun`` (one process per card) on a
``torch.distributed.device_mesh.DeviceMesh`` with axes ("data",
"model"), the counterpart of the reference's one jitted program over the
host mesh.  Each rank computes on its own rows of the global batch, the
statistics of the reference's one program (the masked-token denominator,
the MoE means, the gradients, the clipping norm) are reduced over the
``data`` group, and a leaf that the rules shard over ``data`` (FSDP) is
held as this rank's shard and gathered whole just before the layer that
uses it (``gather_params``: an ``all_gather`` forward, a
``reduce_scatter`` backward).  A one-rank data axis (a plain run) issues
none of these: ``data_group`` is None and the step is the one-device
step.  The model axis stays 1, as the reference's
``make_host_mesh(model=1)`` has it: tensor, sequence and expert
parallelism are not executed, and ``shard`` raises where they would be.

**The fleet axis: one process, several local devices.**  The
controller's cells are independent, so the reference shards its
flattened fleet axis K over a one-process mesh of local devices with no
collective at all.  Its counterpart here is a list of devices
(``FleetMesh``), each running its own slice of K; ``shard_fleet`` cuts a
tree into one tree per device.  It is not a ``torch.distributed`` group.
The controller splits only over a mesh it is given: its ``shard=True``
runs on one device while a split is slower (``simulate_fleet_stream``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.analysis import op_cost

AxisName = Optional[str]
LogicalAxes = Tuple[AxisName, ...]
MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]   # one entry per dimension, as JAX's PartitionSpec

# where a wrapper below issues a collective; read by chip_smoke.py
collective_calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def axis_names(mesh: Any) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (by ``mesh_dim_names``) or of
    any mesh with a ``.shape`` mapping (a shape-only mesh, ``FleetMesh``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(axis_names(mesh), mesh.shape))
    return dict(mesh.shape)


class ShapeMesh:
    """A mesh of axis sizes only, as the reference's tests and its dry run
    use one: rules resolve on it without any device or process group."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name → mesh axis (or tuple of mesh axes, or None)."""

    mapping: Mapping[str, MeshAxes]
    mesh: Any = None

    def mesh_axis_size(self, name: str) -> int:
        assert self.mesh is not None
        return axis_sizes(self.mesh)[name]

    def resolve(self, axes: LogicalAxes, shape: Sequence[int]) -> Spec:
        """The spec of a tensor, dropping non-divisible entries and any
        mesh axis an earlier dimension already took."""
        entries: List[MeshAxes] = []
        used: set = set()
        for dim, ax in zip(shape, axes):
            m = self.mapping.get(ax) if ax is not None else None
            if m is None:
                entries.append(None)
                continue
            keep, size = [], 1
            for a in ((m,) if isinstance(m, str) else tuple(m)):
                if a in used:
                    continue
                asize = self.mesh_axis_size(a) if self.mesh is not None else 1
                if dim % (size * asize) == 0:
                    keep.append(a)
                    size *= asize
            used.update(keep)
            entries.append(None if not keep else keep[0] if len(keep) == 1 else tuple(keep))
        return tuple(entries)


def default_rules(mesh: Any = None, *, fsdp: bool = False, split_kv: bool = False,
                  seq_shard: bool = False) -> ShardingRules:
    """The reference's rule table (see the module docstring)."""
    multi_pod = mesh is not None and "pod" in axis_names(mesh)
    batch: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    embed: MeshAxes = (("data", "pod") if multi_pod else ("data",)) if fsdp else None
    mapping: Dict[str, MeshAxes] = {
        "batch": batch,
        "embed": embed,
        "vocab": "model",
        "heads": "model",
        "kv_heads": None if split_kv else "model",
        "q_per_kv": None,
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "expert_mlp": None,
        "inner": "model",          # SSM d_inner
        "state": None,
        "conv": None,
        "seq": "model" if seq_shard else None,
        "kv_seq": "model" if split_kv else None,
        "frontend": None,
        "layers": None,            # the stacked-layer dim, never sharded
    }
    return ShardingRules(mapping=mapping, mesh=mesh)


_ACTIVE: list = [default_rules(None)]


class use_rules:
    """Context manager installing the active sharding rules."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE.pop()


def active_rules() -> ShardingRules:
    return _ACTIVE[-1]


def spec_for(axes: LogicalAxes, shape: Sequence[int],
             rules: Optional[ShardingRules] = None) -> Spec:
    return (rules or active_rules()).resolve(axes, shape)


def _executed(spec: Spec, mesh: Any, what: str) -> None:
    """Raise where ``spec`` puts a dimension on a mesh axis larger than 1
    other than data (and pod): no executed path runs that parallelism."""
    sizes = axis_sizes(mesh)
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            if a not in ("data", "pod") and sizes[a] > 1:
                raise NotImplementedError(
                    f"{what} is split over the {sizes[a]}-way {a!r} mesh axis; tensor, "
                    "sequence and expert parallelism are not executed by the port "
                    "(launch.train runs make_host_mesh(model=1))")


def shard(x: torch.Tensor, axes: LogicalAxes,
          rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The activation constraint of the reference, as the identity.

    Each rank computes on its own rows of the batch, which is what the
    reference's ``batch → data`` constraint asks of GSPMD, so there is
    nothing to move.  An axis of ``x`` that the rules put on a mesh axis
    larger than 1 other than data raises instead.
    """
    rules = rules or active_rules()
    if rules.mesh is not None:
        _executed(rules.resolve(axes, x.shape), rules.mesh, f"activation {tuple(axes)}")
    return x


def param_specs(layout: Any, rules: Optional[ShardingRules] = None) -> Any:
    """The spec tree of a model layout (a tree of ``ParamDef``)."""
    rules = rules or active_rules()
    return _layout_map(lambda d: rules.resolve(d.axes, d.shape), layout)


def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in the entry's order."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def shard_index(spec: Spec, shape: Sequence[int], sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slice of a whole tensor of ``shape`` that the rank at mesh
    coordinates ``coords`` holds under ``spec``, as JAX's
    ``NamedSharding.devices_indices_map`` gives it: a dimension on the axes
    (a1, …, ak) is cut into their product of equal chunks, and the rank
    holds chunk c1·n2·…·nk + … + ck, the first axis of the entry the major
    one whatever the mesh's order (the rank at (pod p, data d) of a
    ("data", "pod") entry holds chunk d·n_pod + p)."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        chunks, k = 1, 0
        for a in entry_axes(entry):
            chunks, k = chunks * sizes[a], k * sizes[a] + coords[a]
        out.append(slice(k * (n // chunks), (k + 1) * (n // chunks)))
    return tuple(out)


def _strided_shard(dim: int, split_factor: int):
    """DTensor's placement for a dimension that a later mesh dimension
    splits first (``_StridedShard``, the FSDP2 + TP layout)."""
    from torch.distributed.tensor.placement_types import _StridedShard
    return _StridedShard(dim, split_factor=split_factor)


def leaf_placements(spec: Spec, mesh: Any) -> tuple:
    """One placement per mesh dimension: ``Shard(dim)``, ``Replicate()``,
    or, for a two-axis entry against the mesh's order (multi-pod FSDP's
    ("data", "pod") on a (pod, data, model) mesh: data splits first),
    ``_StridedShard(dim, split_factor=n_data)`` on the earlier mesh
    dimension beside ``Shard(dim)`` on the later one, DTensor's
    right-to-left sharding.

    Raises where an entry of three or more axes is not in the mesh's
    dimension order: DTensor has no placement for that."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        order = [names.index(a) for a in entry_axes(entry)]
        if order == sorted(order):
            for i in order:
                out[i] = Shard(dim)
        elif len(order) == 2:
            later, earlier = order
            out[earlier] = _strided_shard(dim, sizes[names[later]])
            out[later] = Shard(dim)
        else:
            raise ValueError(f"spec entry {entry} is not in the mesh's dimension order "
                             f"{names}, and has more than two axes")
    return tuple(out)


def placements(layout: Any, rules: Optional[ShardingRules] = None) -> Any:
    """The counterpart of ``named_shardings``: each leaf's placements on
    the rules' ``DeviceMesh``."""
    rules = rules or active_rules()
    assert rules.mesh is not None
    return _layout_map(lambda s: leaf_placements(s, rules.mesh), param_specs(layout, rules))


def _layout_map(fn, tree):
    """``fn`` on every leaf of a layout-shaped tree (dicts and lists)."""
    from repro_torch.models import common   # models import this module
    return common.tree_map(fn, tree)


# ---------------------------------------------------------------------------
# Collectives (each call counted in ``collective_calls``, and its operand
# bytes per device reported to a running ``analysis.op_cost`` counter)
# ---------------------------------------------------------------------------

# torch renamed the tensor collectives; either name takes the same arguments
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place."""
    collective_calls["all_reduce"] += 1
    op_cost.add_collective("all-reduce", x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise max over ``group``, in place."""
    collective_calls["all_reduce"] += 1
    op_cost.add_collective("all-reduce", x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of a tensor concatenated along ``dim``, in rank
    order."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + moved.shape[1:], dtype=x.dtype, device=x.device)
    collective_calls["all_gather"] += 1
    op_cost.add_collective("all-gather", x)
    _all_gather(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``x`` summed over ``group``."""
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + moved.shape[1:], dtype=x.dtype, device=x.device)
    collective_calls["reduce_scatter"] += 1
    op_cost.add_collective("reduce-scatter", x)
    _reduce_scatter(out, moved, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def _permute_pieces(x: torch.Tensor, dim: int, grid: Sequence[int],
                    perm: Sequence[int]) -> torch.Tensor:
    """``x`` whose ``dim`` holds prod(grid) equal pieces laid out as an array
    of shape ``grid`` (row-major), with that array's axes permuted by
    ``perm``: piece (i_perm[0], …) of the result is piece (i_0, …) of x."""
    if list(perm) == sorted(perm):
        return x
    shape = x.shape
    n = len(grid)
    y = x.reshape(*shape[:dim], *grid, shape[dim] // math.prod(grid), *shape[dim + 1:])
    y = y.permute(*range(dim), *(dim + p for p in perm), *range(dim + n, y.dim()))
    return y.reshape(shape)


@dataclasses.dataclass(frozen=True)
class _EntryGroup:
    """The process group over the mesh axes of one spec entry, its ranks in
    the mesh's order (a multi-axis entry's group is the flattened sub-mesh
    of its axes, pod-major for pod and data), and how the pieces of a
    gather over it (one a rank, in rank order) are re-ordered into the
    entry's chunk order: ``grid`` the piece array's shape in rank order,
    ``perm`` its axes in the entry's order."""

    group: Any
    grid: Tuple[int, ...]
    perm: Tuple[int, ...]

    def to_chunks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _permute_pieces(x, dim, self.grid, self.perm)

    def to_ranks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        grid = tuple(self.grid[p] for p in self.perm)
        inverse = tuple(self.perm.index(i) for i in range(len(self.perm)))
        return _permute_pieces(x, dim, grid, inverse)


def _flat_group(mesh: DeviceMesh, axes: Tuple[str, ...]):
    """The process group of the sub-mesh of ``axes`` (in the mesh's order)
    flattened into one dimension, made once a mesh (a sub-mesh is cut with
    tensor ops on the mesh's ranks, so a dry run makes it before its fake
    tensors)."""
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in cache:
        cache[axes] = mesh[axes]._flatten("_".join(axes)).get_group()
    return cache[axes]


def entry_group(mesh: DeviceMesh, entry: MeshAxes) -> _EntryGroup:
    """The collective group of a spec entry on ``mesh`` (see ``_EntryGroup``)."""
    names = axis_names(mesh)
    axes = entry_axes(entry)
    by_mesh = sorted(range(len(axes)), key=lambda i: names.index(axes[i]))
    grid = tuple(mesh.size(names.index(axes[i])) for i in by_mesh)
    perm = tuple(by_mesh.index(i) for i in range(len(axes)))
    if len(axes) == 1:
        group = mesh.get_group(names.index(axes[0]))
    else:
        group = _flat_group(mesh, tuple(axes[i] for i in by_mesh))
    return _EntryGroup(group, grid, perm)


class _GatherShards(torch.autograd.Function):
    """All-gather along ``dim`` over an entry's group, the pieces put into
    the entry's chunk order, forward; its adjoint backward: the full
    gradient's chunks put into the group's rank order, then reduce-scattered
    (each rank's loss holds its own rows, so the sum over ranks is the
    gradient of the global loss)."""

    @staticmethod
    def forward(ctx, x, dim, eg):
        ctx.dim, ctx.eg = dim, eg
        return eg.to_chunks(all_gather_dim(x, dim, eg.group), dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(ctx.eg.to_ranks(g, ctx.dim), ctx.dim, ctx.eg.group), None, None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement on a ``DeviceMesh``: its resolved ``spec``.

    ``shard`` cuts a whole tensor to this rank's piece (``shard_index``, as
    JAX places it, an entry's axes in any order); ``gather`` rebuilds the
    whole tensor from the pieces (one collective a sharded dimension, over
    the group of its entry's axes).  A spec of ``None`` entries keeps the
    leaf whole."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return leaf_placements(self.spec, self.mesh)

    def _split(self):
        """``(tensor dim, entry)`` of each dimension split over more than one
        rank."""
        sizes = axis_sizes(self.mesh)
        return [(dim, e) for dim, e in enumerate(self.spec)
                if math.prod(sizes[a] for a in entry_axes(e)) > 1]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        names = axis_names(self.mesh)
        coords = {a: self.mesh.get_local_rank(i) for i, a in enumerate(names)}
        index = shard_index(self.spec, x.shape, axis_sizes(self.mesh), coords)
        return x[index].clone() if self._split() else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        for dim, entry in reversed(self._split()):
            eg = entry_group(self.mesh, entry)
            x = eg.to_chunks(all_gather_dim(x, dim, eg.group), dim)
        return x


def named_shardings(layout: Any, rules: Optional[ShardingRules] = None) -> Any:
    """A ``NamedSharding`` per leaf of a model layout, on the rules' mesh."""
    rules = rules or active_rules()
    assert isinstance(rules.mesh, DeviceMesh), "named_shardings needs a DeviceMesh"
    return _layout_map(lambda s: NamedSharding(rules.mesh, s), param_specs(layout, rules))


# ---------------------------------------------------------------------------
# The training path's use of the active rules
# ---------------------------------------------------------------------------


def data_group(rules: Optional[ShardingRules] = None):
    """The process group of the ``data`` mesh axis (with a ``pod`` axis,
    of the pod and data axes together: ``batch`` splits over both), or
    None (the one-device path) when the rules carry no ``DeviceMesh`` or
    that group has one rank: a collective over one rank is a copy, so a
    plain run on a 1 × 1 mesh takes the one-device step at its speed."""
    rules = rules or active_rules()
    if not isinstance(rules.mesh, DeviceMesh):
        return None
    sizes = axis_sizes(rules.mesh)
    if sizes["data"] * sizes.get("pod", 1) == 1:
        return None
    if "pod" in sizes:
        return _flat_group(rules.mesh, ("pod", "data"))
    return rules.mesh.get_group("data")


def over_data(spec: Spec) -> bool:
    """Whether ``spec`` splits a dimension over the data (or pod) axis."""
    return any(a in ("data", "pod") for e in spec
               for a in ((e,) if isinstance(e, str) else e or ()))


def fsdp_specs(layout: Any, rules: Optional[ShardingRules] = None) -> Optional[Any]:
    """The layout's spec tree when the active rules hold some leaf as a
    shard over the data axis of a ``DeviceMesh`` (FSDP), else None."""
    rules = rules or active_rules()
    if not isinstance(rules.mesh, DeviceMesh):
        return None
    from repro_torch.models import common
    specs = param_specs(layout, rules)
    if not any(over_data(s) for _, s in common.tree_leaves(specs)):
        return None
    return specs


def gather_params(tree: Any, specs: Any, rules: Optional[ShardingRules] = None) -> Any:
    """``tree`` (this rank's shards) with every sharded leaf gathered whole
    through ``_GatherShards``; ``specs`` is its spec tree (a stacked layer
    sliced to one layer passes its specs without the leading entry)."""
    if specs is None:
        return tree
    rules = rules or active_rules()
    mesh = rules.mesh

    def one(x, spec):
        _executed(spec, mesh, "a parameter")
        for dim, entry in reversed(NamedSharding(mesh, spec)._split()):
            x = _GatherShards.apply(x, dim, entry_group(mesh, entry))
        return x

    return _zip_map(one, tree, specs)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


# ---------------------------------------------------------------------------
# Fleet axis: independent cells split over local devices
# ---------------------------------------------------------------------------


class FleetMesh:
    """A one-process mesh of local devices along one axis.

    The reference's fleet mesh partitions a compiled program with zero
    collectives; here each device runs its own slice of the fleet axis
    from the same host thread.  A device may appear more than once (two
    slots of one card)."""

    def __init__(self, devices: Sequence[Any], axis: str = "fleet"):
        if not devices:
            raise ValueError("a fleet mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    def __repr__(self) -> str:
        return f"FleetMesh({[str(d) for d in self.devices]}, axis={self.axis_names[0]!r})"


def fleet_mesh(axis: str = "fleet", devices: Optional[Sequence[Any]] = None
               ) -> Optional[FleetMesh]:
    """A mesh over every local CUDA device, or None with fewer than two;
    ``devices`` builds one over exactly those devices."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 2:
            return None
        devices = [torch.device("cuda", i) for i in range(n)]
    return FleetMesh(devices, axis)


def fleet_rules(mesh: FleetMesh, axis: str = "fleet") -> ShardingRules:
    """Rules mapping the logical fleet axis onto the fleet mesh."""
    return ShardingRules(mapping={axis: axis}, mesh=mesh)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_fleet(tree: Any, rules: ShardingRules, axis: str = "fleet") -> Any:
    """Split every leaf's leading axis over the fleet mesh: a list with one
    tree per device.

    A leaf whose leading dimension divides the device count goes as one
    contiguous slice to each device; any other leaf goes whole to every
    device (the rules drop the entry: replicated).  Scalars pass through
    unchanged.  With a mesh-less ``rules`` the call is the identity."""
    mesh = rules.mesh
    if mesh is None:
        return tree
    n = len(mesh.devices)

    def pieces(x):
        if getattr(x, "ndim", 0) == 0:
            return _PerDevice([x] * n)
        spec = rules.resolve((axis,) + (None,) * (x.ndim - 1), x.shape)
        x = torch.as_tensor(x)
        parts = x.chunk(n) if spec[0] is not None else [x] * n
        return _PerDevice([p.to(d) for p, d in zip(parts, mesh.devices)])

    split = _map_tree(pieces, tree)
    return [_map_tree(lambda leaf: leaf.items[i], split) for i in range(n)]


class _PerDevice:
    """One leaf's pieces, one per device (a leaf to ``_map_tree``)."""

    def __init__(self, items):
        self.items = items
