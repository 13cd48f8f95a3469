"""The port's sharding rules against ``repro.parallel.sharding``.

* ``resolve`` / ``default_rules`` / ``param_specs`` entry by entry
  against JAX's for all ten archs' full layouts, on a shape-only 16 × 16
  and 2 × 16 × 16 mesh with ``fsdp``, ``split_kv`` and ``seq_shard`` each
  on and off, and on ``shrink_mesh_plan``'s meshes for 256, 192, 128 and
  48 chips (a port spec is a tuple; JAX's ``PartitionSpec`` compares as
  one);
* the reference tests' cases: divisibility fallback, no mesh axis used
  twice, FSDP, sequence and split-KV switches, multi-pod batch axes;
* ``placements`` and ``NamedSharding`` on a 2 × 1 gloo ``DeviceMesh`` (two
  processes over a ``FileStore``), and ``shard``'s raise where a mesh axis
  other than data would split an activation;
* multi-pod FSDP's ("data", "pod") entry, against the mesh's order:
  ``shard_index`` equal to JAX's ``NamedSharding.devices_indices_map`` on a
  (2, 4, 1) mesh of 8 host devices (a subprocess), and on a 4-rank gloo
  mesh (pod 2 × data 2) ``NamedSharding.shard`` / ``gather`` and
  ``gather_params`` with its reduce-scatter backward equal to the whole
  tensor and its gradient.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.models import transformer as jtf
from repro.models.common import ParamDef as JaxParamDef
from repro.parallel import sharding as jshd
from repro.runtime.elastic import shrink_mesh_plan as jax_shrink
from repro_torch.configs import get_config
from repro_torch.models import common, transformer
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.elastic import shrink_mesh_plan

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SWITCHES = list(itertools.product((False, True), repeat=3))   # fsdp, split_kv, seq_shard


def _layouts(arch):
    jl = jax.tree.leaves(jtf.model_layout(jax_config(arch)),
                         is_leaf=lambda x: isinstance(x, JaxParamDef))
    tl = [d for _, d in common.tree_leaves(transformer.model_layout(get_config(arch)))]
    assert [(tuple(d.shape), tuple(d.axes)) for d in jl] == \
        [(tuple(d.shape), tuple(d.axes)) for d in tl]
    return jl, tl


def _specs_equal(arch, shape, **kw):
    mesh = shd.ShapeMesh(shape)
    jrules, trules = jshd.default_rules(mesh, **kw), shd.default_rules(mesh, **kw)
    assert dict(jrules.mapping) == dict(trules.mapping)
    jl, tl = _layouts(arch)
    want = [jrules.resolve(d.axes, d.shape) for d in jl]
    got = [s for _, s in common.tree_leaves(shd.param_specs(transformer.model_layout(
        get_config(arch)), trules))]
    assert got == [tuple(w) for w in want] and all(g == w for g, w in zip(got, want))
    return got


@pytest.mark.parametrize("switches", SWITCHES, ids=lambda s: "fsdp%d-kv%d-seq%d" % s)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_jax(arch, mesh, switches):
    fsdp, split_kv, seq_shard = switches
    got = _specs_equal(arch, MESHES[mesh], fsdp=fsdp, split_kv=split_kv, seq_shard=seq_shard)
    sizes = MESHES[mesh]
    for d, spec in zip(_layouts(arch)[1], got):
        for dim, entry in zip(d.shape, spec):
            axes = (entry,) if isinstance(entry, str) else entry or ()
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0


@pytest.mark.parametrize("alive", [256, 192, 128, 48])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_on_shrunk_meshes_match_jax(arch, alive):
    d, m = shrink_mesh_plan(alive)
    assert (d, m) == jax_shrink(alive)
    _specs_equal(arch, {"data": d, "model": m}, fsdp=True)


def _both(kw, mesh, axes, shape):
    mesh = shd.ShapeMesh(mesh)
    j = jshd.ShardingRules(mapping=jshd.default_rules(None, **kw).mapping, mesh=mesh)
    t = shd.ShardingRules(mapping=shd.default_rules(None, **kw).mapping, mesh=mesh)
    got = t.resolve(axes, shape)
    assert got == tuple(j.resolve(axes, shape)) and j.resolve(axes, shape) == got
    return got


@pytest.mark.parametrize("kw,axes,shape,want", [
    ({}, ("embed", "kv_heads", "head_dim"), (2048, 8, 64), (None, None, None)),
    ({}, ("embed", "kv_heads", "head_dim"), (2048, 16, 64), (None, "model", None)),
    ({"fsdp": True}, ("batch", "embed"), (256, 4096), ("data", None)),
    ({"fsdp": True}, ("embed", "heads", "head_dim"), (4096, 32, 128), ("data", "model", None)),
    ({"seq_shard": True}, ("batch", "seq", "embed"), (256, 4096, 2048), ("data", "model", None)),
    ({"seq_shard": True}, ("batch", "seq", "embed"), (256, 1, 2048), ("data", None, None)),
    ({"split_kv": True}, ("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 8, 128),
     ("data", "model", None, None)),
], ids=["kv8-fallback", "kv16", "no-axis-twice", "fsdp", "seq", "seq-decode", "split-kv"])
def test_reference_cases(kw, axes, shape, want):
    assert _both(kw, {"data": 16, "model": 16}, axes, shape) == want


def test_multipod_batch_axes():
    mesh = shd.ShapeMesh({"pod": 2, "data": 16, "model": 16})
    mapping = shd.default_rules(None).mapping | {"batch": ("pod", "data")}
    got = shd.ShardingRules(mapping=mapping, mesh=mesh).resolve(("batch", "seq"), (256, 4096))
    assert got == (("pod", "data"), None) == P(("pod", "data"), None)
    assert shd.default_rules(mesh).mapping["batch"] == ("pod", "data")
    assert shd.default_rules(mesh, fsdp=True).mapping["embed"] == ("data", "pod")


def test_shard_is_the_identity_but_raises_past_the_data_axis():
    rules = shd.default_rules(shd.ShapeMesh({"data": 4, "model": 2}), fsdp=True)
    x = torch.zeros(8, 16, 64)
    assert shd.shard(x, ("batch", "seq", "embed"), rules) is x
    with pytest.raises(NotImplementedError, match="2-way 'model' mesh axis"):
        shd.shard(torch.zeros(8, 16, 4, 32), ("batch", "seq", "heads", "head_dim"), rules)
    one = shd.default_rules(shd.ShapeMesh({"data": 4, "model": 1}))
    assert shd.shard(torch.zeros(8, 4), ("batch", "heads"), one) is not None
    assert shd.shard(x, ("batch", "seq", "embed")) is x            # mesh-less active rules
    with shd.use_rules(rules):
        assert shd.spec_for(("batch", "embed"), (8, 64)) == ("data", None)
    assert shd.active_rules().mesh is None


def test_leaf_placements_refuse_a_tuple_out_of_mesh_order():
    """A two-axis entry against the mesh's order is DTensor's right-to-left
    sharding (``_StridedShard`` on the earlier mesh dimension); one of three
    axes out of order has no placement and is refused."""
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh = shd.ShapeMesh({"pod": 2, "data": 16, "model": 16})
    assert shd.leaf_placements((("pod", "data"), "model"), mesh) == (
        shd.Shard(0), shd.Shard(0), shd.Shard(1))
    got = shd.leaf_placements((("data", "pod"), None), mesh)
    assert isinstance(got[0], _StridedShard) and got[0].dim == 0
    assert got[0].split_factor == 16 and got[1:] == (shd.Shard(0), shd.Replicate())
    with pytest.raises(ValueError, match="not in the mesh's dimension order"):
        shd.leaf_placements((("model", "data", "pod"),), mesh)


_JAX_INDEX_MAP = """
import json, jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devices = np.array(jax.devices()[:8]).reshape(2, 4, 1)
mesh = Mesh(devices, ("pod", "data", "model"))
out = {}
for name, spec in {"data_pod": P(("data", "pod"), None), "pod_data": P(("pod", "data")),
                   "data": P("data", None), "pod_data_model": P(None, ("data", "pod"))}.items():
    shape = (16, 8) if name != "pod_data" else (24,)
    idx = NamedSharding(mesh, spec).devices_indices_map(shape)
    rows = []
    for (p, d, m), dev in np.ndenumerate(devices):
        rows.append([[p, d, m], [[s.start or 0, s.stop if s.stop is not None else n]
                                 for s, n in zip(idx[dev], shape)]])
    out[name] = rows
print(json.dumps(out))
"""


def test_shard_index_is_jaxs_devices_indices_map(tmp_path):
    """``shard_index`` of ("data", "pod"), ("pod", "data") and single-axis
    entries equals JAX's ``NamedSharding.devices_indices_map`` on a
    (pod 2, data 4, model 1) mesh of 8 host devices, device by device (the
    rank at (pod p, data d) of a ("data", "pod") entry holds chunk d·2 + p)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _JAX_INDEX_MAP], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    import json
    want = json.loads(run.stdout.strip().splitlines()[-1])
    sizes = {"pod": 2, "data": 4, "model": 1}
    specs = {"data_pod": (("data", "pod"), None), "pod_data": (("pod", "data"),),
             "data": ("data", None), "pod_data_model": (None, ("data", "pod"))}
    for name, spec in specs.items():
        shape = (16, 8) if name != "pod_data" else (24,)
        for (p, d, m), bounds in want[name]:
            got = shd.shard_index(spec, shape, sizes, {"pod": p, "data": d, "model": m})
            assert [[s.start, s.stop] for s in got] == bounds, (name, p, d)
    # the ("data", "pod") case the multi-pod FSDP rule builds: chunk d·2 + p
    for p in range(2):
        for d in range(4):
            got = shd.shard_index((("data", "pod"),), (16,), sizes, {"pod": p, "data": d,
                                                                     "model": 0})
            assert got[0] == slice(2 * (2 * d + p), 2 * (2 * d + p) + 2)


def _multi_pod_rank(rank, store):
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
        coords = {"pod": rank // 2, "data": rank % 2, "model": 0}
        rules = shd.default_rules(mesh, fsdp=True)
        spec = rules.resolve(("embed", None), (8, 3))
        assert spec == (("data", "pod"), None)
        whole = torch.arange(24.0).reshape(8, 3)
        ns = shd.NamedSharding(mesh, spec)
        piece = ns.shard(whole)
        chunk = 2 * coords["data"] + coords["pod"]
        assert torch.equal(piece, whole[2 * chunk:2 * chunk + 2])
        assert torch.equal(ns.gather(piece), whole)
        # gather_params forward and its reduce-scatter backward: each rank's loss weighs
        # the gathered leaf by its own w_r, so the leaf's gradient is Σ_r w_r, cut to
        # this rank's chunk
        weights = [torch.arange(24.0).reshape(8, 3) * (r + 1) - 5.0 for r in range(4)]
        x = piece.clone().requires_grad_()
        with shd.use_rules(rules):
            full = shd.gather_params({"w": x}, {"w": spec})["w"]
        assert torch.equal(full.detach(), whole)
        (full * weights[rank]).sum().backward()
        assert torch.equal(x.grad, sum(weights)[2 * chunk:2 * chunk + 2])
        # ("pod", "data") in the mesh's order: chunk p·2 + d, gathered the same way
        ns2 = shd.NamedSharding(mesh, (("pod", "data"), None))
        piece2 = ns2.shard(whole)
        chunk2 = 2 * coords["pod"] + coords["data"]
        assert torch.equal(piece2, whole[2 * chunk2:2 * chunk2 + 2])
        assert torch.equal(ns2.gather(piece2), whole)
    finally:
        dist.destroy_process_group()


def test_multi_pod_fsdp_gathers_and_reduce_scatters_on_four_gloo_ranks(tmp_path):
    mp.start_processes(_multi_pod_rank, args=(str(tmp_path / "store"),), nprocs=4,
                       start_method="spawn")


def _placements_rank(rank, store):
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 1)
        cfg = get_config("llama3.2-1b", reduced=True)
        layout = transformer.model_layout(cfg)
        rules = shd.default_rules(mesh, fsdp=True)
        pl = dict(common.tree_leaves(shd.placements(layout, rules)))
        specs = dict(common.tree_leaves(shd.param_specs(layout, rules)))
        defs = dict(common.tree_leaves(layout))
        for path, p in pl.items():
            spec = specs[path]
            data_dim = [i for i, e in enumerate(spec) if e == "data"]
            assert p[0] == (shd.Shard(data_dim[0]) if data_dim else shd.Replicate()), path
            model_dim = [i for i, e in enumerate(spec) if e == "model"]
            assert p[1] == (shd.Shard(model_dim[0]) if model_dim else shd.Replicate()), path
            whole = torch.arange(float(np.prod(defs[path].shape))).reshape(defs[path].shape)
            ns = shd.NamedSharding(mesh, spec)
            piece = ns.shard(whole)
            if data_dim:
                assert piece.shape[data_dim[0]] * 2 == whole.shape[data_dim[0]]
                assert torch.equal(piece, whole.chunk(2, data_dim[0])[rank])
            assert torch.equal(ns.gather(piece), whole)
        assert pl["slots/0/attn/wq"] == (shd.Shard(1), shd.Shard(2))
    finally:
        dist.destroy_process_group()


def test_placements_on_a_two_by_one_gloo_mesh(tmp_path):
    mp.start_processes(_placements_rank, args=(str(tmp_path / "store"),), nprocs=2,
                       start_method="spawn")


def test_production_mesh_needs_its_ranks_and_torchrun_picks_the_local_card(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.launch import make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device(None) == torch.device("cuda")
