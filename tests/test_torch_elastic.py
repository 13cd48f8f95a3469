"""Re-sharding and restoring a training state onto another mesh, on the
CPU (``runtime/elastic.reshard_tree``, ``CheckpointManager.restore(...,
shardings=...)``).

* in 2 gloo processes over a ``FileStore``: a REDUCED llama3.2-1b state
  after one FSDP step (params and both moments held as shards under (2, 1)
  rules) re-sharded onto ``shrink_mesh_plan(1)``'s (1, 1) mesh (each rank
  then holds every leaf whole) and back, every leaf bit-equal; saved with
  its shardings (gathered, rank 0 writes) and restored onto both meshes,
  bit-equal;
* in 2 gloo processes: saving and restoring with shardings holds at most
  one whole leaf at a time on each rank (a whole leaf made by a gather or
  read from disk is gone before the next one is made);
* the reference's shrunk-mesh test (``tests/test_elastic_integration.py``)
  on the port's rules: gemma3-27b's specs on the meshes of 256, 192, 128
  and 48 chips divide every sharded dimension.
"""

import dataclasses
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline, local_rows
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as ttrain
from repro_torch.models import common, transformer
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import checkpoint as ckpt_mod
from repro_torch.runtime.checkpoint import CheckpointManager, tree_flatten, tree_unflatten
from repro_torch.runtime.elastic import reshard_tree, shrink_mesh_plan
from repro_torch.train import make_train_step


def _equal(a, b, what):
    la, lb = tree_flatten(a), tree_flatten(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), (what, i)


def _rank_main(rank, store, ckpt_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), fsdp=True)
        layout = transformer.model_layout(cfg)
        big = shd.default_rules(mesh_mod.make_host_mesh(device="cpu"), fsdp=True)
        d, m = shrink_mesh_plan(1)
        small = shd.default_rules(mesh_mod.make_mesh((d, m), ("data", "model")), fsdp=True)
        assert tuple(small.mesh.shape) == (1, 1) and tuple(big.mesh.shape) == (2, 1)

        pipe = SyntheticPipeline(DataConfig(4, 16, cfg.vocab_size), cfg)
        batch = {k: torch.from_numpy(v) for k, v in local_rows(next(pipe), rank, 2).items()}
        pipe.close()
        with shd.use_rules(big):
            params, opt = ttrain.init_state(cfg, big, torch.device("cpu"))
            tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                                         total_steps=1))
            params, opt, _ = make_train_step(cfg, tcfg)(params, opt, batch)
        state = (params, opt)
        slayout = ttrain.state_layout(layout)
        whole = [sh.gather(x) for x, sh in zip(tree_flatten(state),
                                               tree_flatten(ttrain.state_shardings(layout, big)))]
        assert any(a.shape != b.shape for a, b in zip(tree_flatten(state), whole))

        shrunk = reshard_tree(state, slayout, small, rules=big)
        _equal(shrunk, tree_unflatten(state, whole), "onto (1, 1)")
        back = reshard_tree(shrunk, slayout, big, rules=small)
        _equal(back, state, "back onto (2, 1)")

        ckpt = CheckpointManager(ckpt_dir)
        ckpt.save(state, step=1, blocking=True, shardings=ttrain.state_shardings(layout, big))
        dist.barrier()
        restored, step = ckpt.restore_latest(state, ttrain.state_shardings(layout, big))
        assert step == 1
        _equal(restored, state, "restored onto (2, 1)")
        restored, _ = ckpt.restore_latest(shrunk, ttrain.state_shardings(layout, small))
        _equal(restored, shrunk, "restored onto (1, 1)")
    finally:
        dist.destroy_process_group()


def test_reshard_and_restore_across_two_ranks_are_bit_equal(tmp_path):
    mp.start_processes(_rank_main, args=(str(tmp_path / "store"), str(tmp_path / "ckpt")),
                       nprocs=2, start_method="spawn")


def _one_whole_leaf_main(rank, store, ckpt_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        mesh = mesh_mod.make_host_mesh(device="cpu")
        rng = np.random.default_rng(0)
        whole = {k: torch.from_numpy(rng.standard_normal(shape, np.float32))
                 for k, shape in (("a", (8, 3)), ("b", (4, 5)), ("c", (6,)))}
        shardings = {k: shd.NamedSharding(mesh, ("data",) + (None,) * (x.ndim - 1))
                     for k, x in whole.items()}
        state = {k: shardings[k].shard(x) for k, x in whole.items()}
        assert all(state[k].shape[0] * 2 == x.shape[0] for k, x in whole.items())

        made = []          # weak references to every whole leaf made so far

        def tracked(fn):
            def wrapper(*args, **kwargs):
                alive = [i for i, r in enumerate(made) if r() is not None]
                assert not alive, f"rank {rank}: whole leaves {alive} still held"
                out = fn(*args, **kwargs)
                made.append(weakref.ref(out))
                return out
            return wrapper

        gather, from_host = shd.all_gather_dim, ckpt_mod._from_host
        shd.all_gather_dim, ckpt_mod._from_host = tracked(gather), tracked(from_host)
        try:
            ckpt = CheckpointManager(ckpt_dir)
            ckpt.save(state, step=1, blocking=True, shardings=shardings)
            dist.barrier()
            assert len(made) == 3
            restored, step = ckpt.restore_latest(state, shardings)
        finally:
            shd.all_gather_dim, ckpt_mod._from_host = gather, from_host
        assert step == 1 and len(made) == 6
        _equal(restored, state, "restored shards")
    finally:
        dist.destroy_process_group()


def test_sharded_save_and_restore_hold_one_whole_leaf_at_a_time(tmp_path):
    mp.start_processes(_one_whole_leaf_main,
                       args=(str(tmp_path / "store"), str(tmp_path / "ckpt")),
                       nprocs=2, start_method="spawn")


@pytest.mark.parametrize("alive", [256, 192, 128, 48])
def test_specs_adapt_to_a_smaller_mesh(alive):
    cfg = get_config("gemma3-27b")
    d, m = shrink_mesh_plan(alive)
    rules = shd.ShardingRules(mapping=shd.default_rules(None, fsdp=True).mapping,
                              mesh=shd.ShapeMesh({"data": d, "model": m}))
    for _, leaf in common.tree_leaves(transformer.model_layout(cfg)):
        spec = rules.resolve(leaf.axes, leaf.shape)
        for dim, entry in zip(leaf.shape, spec):
            axes = (entry,) if isinstance(entry, str) else entry or ()
            assert dim % int(np.prod([rules.mesh.shape[a] for a in axes])) == 0
