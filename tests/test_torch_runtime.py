"""The port's runtime against the reference's behaviour, on the CPU:
``CheckpointManager`` (round trip, async save and gc, corruption, partial
steps, bf16 leaves, the on-disk format read by either package),
``FaultInjector``, ``run_with_restarts`` and ``StragglerMitigator`` — the
cases of ``tests/test_runtime.py`` on the port."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import checkpoint as jckpt
from repro.runtime.straggler import StragglerMitigator as JStraggler
from repro_torch.optim import AdamWState
from repro_torch.runtime.checkpoint import CheckpointManager, tree_flatten, tree_unflatten
from repro_torch.runtime.fault import FaultInjector, NodeFailure, run_with_restarts
from repro_torch.runtime.straggler import StragglerMitigator


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g), "b": torch.arange(4, dtype=torch.float32),
            "step": torch.tensor(3)}


def _equal(a, b):
    for x, y in zip(tree_flatten(a), tree_flatten(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree()
    ckpt.save(tree, step=10, blocking=True)
    restored, step = ckpt.restore_latest(tree)
    assert step == 10
    _equal(tree, restored)
    assert os.path.isdir(tmp_path / "step_000000010")
    assert sorted(os.listdir(tmp_path / "step_000000010")) == [
        "_COMMITTED", "arr_0000.npy", "arr_0001.npy", "arr_0002.npy", "manifest.json"]


def test_checkpoint_async_and_gc(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(tree, step=s)
        ckpt.wait()
    assert ckpt.list_steps() == [3, 4]


def test_checkpoint_save_snapshots_before_returning(tmp_path):
    """The async save copies the state first: changing it afterwards (an
    optimizer step in place) does not reach the file."""
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = {k: v.clone() for k, v in tree.items()}
    ckpt.save(tree, step=1)
    tree["w"].add_(1.0)
    ckpt.wait()
    _equal(want, ckpt.restore(want, 1))


def test_checkpoint_detects_corruption(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree()
    ckpt.save(tree, step=1, blocking=True)
    f = os.path.join(str(tmp_path), "step_000000001", "arr_0000.npy")
    data = bytearray(open(f, "rb").read())
    data[-8] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(IOError):
        ckpt.restore(tree, 1)


def test_partial_checkpoint_never_loads(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree()
    ckpt.save(tree, step=5, blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_000000009"))
    tmp = os.path.join(str(tmp_path), "step_000000011.tmp")
    os.makedirs(tmp)
    open(os.path.join(tmp, "_COMMITTED"), "w").write("ok")
    assert ckpt.list_steps() == [5]
    assert ckpt.restore_latest(tree)[1] == 5


def test_bf16_leaves_keep_their_bits(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    m = torch.randn(5, 3, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    state = AdamWState(step=torch.tensor(4, dtype=torch.int32), m={"w": m}, v={"w": m * 2})
    ckpt.save(state, step=4, blocking=True)
    meta = json.load(open(tmp_path / "step_000000004" / "manifest.json"))
    assert [x["dtype"] for x in meta["leaves"]] == ["int32", "bfloat16", "bfloat16"]
    out = ckpt.restore(state, 4)
    assert isinstance(out, AdamWState)
    _equal(state, out)


def test_restore_takes_template_dtype_and_rejects_wrong_tree(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save({"a": torch.ones(3, dtype=torch.float64)}, step=1, blocking=True)
    out = ckpt.restore({"a": torch.zeros(3)}, 1)
    assert out["a"].dtype == torch.float32 and torch.equal(out["a"], torch.ones(3))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore({"a": torch.zeros(3), "b": torch.zeros(1)}, 1)


def test_flatten_order_is_jax_order():
    """Sorted dict keys, list and NamedTuple order, None holds no leaf."""
    tree = AdamWState(step=1, m={"z": 2, "a": [3, {"y": 4, "b": 5}]}, v=None)
    assert tree_flatten(tree) == [1, 3, 5, 4, 2]
    back = tree_unflatten(tree, [10, 30, 50, 40, 20])
    assert back == AdamWState(step=10, m={"z": 20, "a": [30, {"y": 40, "b": 50}]}, v=None)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_format_is_shared_with_the_jax_package(tmp_path, writer):
    """A float32 / int32 tree written by either package restores in the
    other with equal values (same file names, manifest and digests)."""
    rng = np.random.default_rng(0)
    arrs = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(5).astype(np.float32)}],
            "step": np.array(7, np.int32)}
    t_tree = {"w": torch.from_numpy(arrs["w"]), "layers": [{"b": torch.from_numpy(
        arrs["layers"][0]["b"])}], "step": torch.tensor(7, dtype=torch.int32)}
    j_tree = {"w": jnp.asarray(arrs["w"]), "layers": [{"b": jnp.asarray(
        arrs["layers"][0]["b"])}], "step": jnp.asarray(arrs["step"])}
    if writer == "jax":
        jckpt.CheckpointManager(str(tmp_path)).save(j_tree, step=3, blocking=True)
        out, step = CheckpointManager(str(tmp_path)).restore_latest(t_tree)
        _equal(t_tree, out)
    else:
        CheckpointManager(str(tmp_path)).save(t_tree, step=3, blocking=True)
        out, step = jckpt.CheckpointManager(str(tmp_path)).restore_latest(j_tree)
        np.testing.assert_array_equal(np.asarray(out["w"]), arrs["w"])
        np.testing.assert_array_equal(np.asarray(out["layers"][0]["b"]), arrs["layers"][0]["b"])
        assert int(out["step"]) == 7
    assert step == 3


def test_fault_injector_fires_same_node_at_each_scheduled_step():
    inj = FaultInjector(fail_at={3: 1, 9: 1})
    with pytest.raises(NodeFailure):
        inj.check(3)
    inj.check(3)
    with pytest.raises(NodeFailure) as e:
        inj.check(9)
    assert e.value.node == 1 and e.value.step == 9
    assert str(e.value) == "node 1 failed at step 9"
    inj.check(9)
    assert inj._fired == {(3, 1), (9, 1)}


def test_run_with_restarts_recovers(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}

    out = run_with_restarts(step_fn, {"x": torch.tensor(0)}, n_steps=20, ckpt=ckpt,
                            ckpt_every=5, injector=FaultInjector(fail_at={7: 3, 15: 1}))
    assert out["restarts"] == 2 and out["steps"] == 20
    assert int(out["state"]["x"]) == 20
    # replayed from the newest checkpoint: steps 5, 6 after the first failure
    assert calls == list(range(7)) + list(range(5, 15)) + list(range(15, 20))


def test_run_with_restarts_on_failure_hook_and_resume(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    seen = []

    def on_failure(e, state):
        seen.append((e.node, e.step))
        return state

    step = lambda s, i: {"x": s["x"] + 1}
    run_with_restarts(step, {"x": torch.tensor(0)}, n_steps=10, ckpt=ckpt, ckpt_every=4,
                      injector=FaultInjector(fail_at={5: 2}), on_failure=on_failure)
    assert seen == [(2, 5)]
    # a new supervisor resumes from the newest committed step (8)
    out = run_with_restarts(step, {"x": torch.tensor(0)}, n_steps=12, ckpt=ckpt,
                            ckpt_every=4)
    assert int(out["state"]["x"]) == 12 and out["restarts"] == 0


def test_straggler_matches_reference():
    rng = np.random.default_rng(0)
    kw = dict(n_nodes=8, granularity=2, evict_threshold=1.5, evict_patience=3)
    t, j = StragglerMitigator(**kw), JStraggler(**kw)
    for obj in (t, j):
        obj.set_intended_speed(2, 0.4)
    for step in range(12):
        times = 1.0 + 0.05 * rng.standard_normal(8)
        if step >= 4:
            times[5] *= 3.0
        times[2] *= 2.5
        t.observe(times)
        j.observe(times)
        assert t.shares(64) == j.shares(64)
        assert t.evictions() == j.evictions()
        np.testing.assert_array_equal(t.speeds(), j.speeds())
    assert 5 in t.evictions() and 2 not in t.evictions()


def test_straggler_shares_rebalance():
    mit = StragglerMitigator(n_nodes=4, ema=0.0, granularity=2)
    mit.observe(np.array([1.0, 1.0, 1.0, 2.0]))
    shares = mit.shares(64)
    assert sum(shares) == 64 and shares[3] < shares[0]
    assert all(s % 2 == 0 for s in shares)
