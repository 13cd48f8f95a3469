"""Data-parallel and FSDP training of the port across 2 gloo ranks,
held against one process on the CPU.

The reference's trainer cannot run on several devices with the installed
jax, so the 2-rank port is held against the 1-rank port, which
``test_torch_train.py`` holds against JAX.  Configs run in float32 (the
REDUCED configs' bf16 matmuls differ by ~3e-3 with the batch split), with
phase 18's float32 tolerances: metrics 1e-5 relative, gradients (read as
the first AdamW moment, (1 − b1)·g after one step) 1e-4 of each leaf's
max |g|, parameters 1e-5 at all but 0.1 % of a leaf's elements.

* through the entry point: ``torchrun --standalone --nproc-per-node 2``
  of ``launch.train.main --device cpu`` (a two-line script that runs it in
  float32), REDUCED llama3.2-1b for 3 steps, plain and ``--microbatch 2``,
  and REDUCED falcon-mamba-7b for 1 step; each saves its last step to
  ``--ckpt-dir`` (gathered to rank 0) and is compared with ``main`` run in
  this process;
* through the functions ``launch.train`` calls (``init_state``,
  ``make_train_step`` under ``use_rules``, ``local_rows``), in 2 processes
  joined by a ``FileStore``: REDUCED qwen3-moe with one routing group a
  rank and a mask whose token counts differ by rank, and REDUCED llama
  with ``fsdp=True`` (masters and moments held as shards, each layer
  gathered under remat), also with int8 gradient compression;
* ``split_refusal`` of a split that breaks a routing group and the
  per-rank ``refusal`` arithmetic.
"""

import dataclasses
import os
import re
import subprocess
import sys
import types

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
from repro_torch.runtime.checkpoint import CheckpointManager, tree_flatten
from repro_torch.train import make_train_step

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
METRIC_RTOL, GRAD_TOL, PARAM_RTOL, PARAM_OUTLIERS = 1e-5, 1e-4, 1e-5, 1e-3
LR = 3e-3
FLOAT32_MAIN = """import dataclasses, sys
from repro_torch.launch import train
_get = train.get_config
train.get_config = lambda *a, **k: dataclasses.replace(_get(*a, **k), dtype="float32")
raise SystemExit(train.main(sys.argv[1:]))
"""
STEP_LINE = re.compile(r"step +(\d+) loss=(\d+\.\d{4}) grad_norm=(\d+\.\d{3}) \d+ ms/step")


def _f32(arch, **kw):
    return dataclasses.replace(get_config(arch, reduced=True), dtype="float32", **kw)


def _hold_params(got, want, bound, what):
    """Phase 18's float32 rule: within 1e-5·(1 + |x|) at all but 0.1 % of
    a leaf's elements (2 in a small leaf) and within ``bound`` (2·lr a
    step) everywhere."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i)
        diff = np.abs(a - b)
        off = int((diff > PARAM_RTOL * (1 + np.abs(b))).sum())
        assert off <= max(2, PARAM_OUTLIERS * diff.size), (what, i, off, diff.size)
        assert diff.max() <= bound, (what, i, diff.max())


def _hold_grads(got, want, what, tol=GRAD_TOL):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= tol * scale, (what, i, np.abs(a - b).max() / scale)


def _hold_state(got, want, lr, steps, what):
    """``(params, opt_state)`` leaf lists: params, the step, m (an average
    of gradients: 1e-4 of its max), v (of squared gradients: 2e-4)."""
    n = (len(want) - 1) // 3
    _hold_params(got[:n], want[:n], 2 * lr * steps, f"{what} params")
    assert int(got[n]) == int(want[n]) == steps
    _hold_grads(got[n + 1:2 * n + 1], want[n + 1:2 * n + 1], f"{what} m")
    _hold_grads(got[2 * n + 1:], want[2 * n + 1:], f"{what} v", 2 * GRAD_TOL)


def _last_state(ckpt_dir):
    ckpt = CheckpointManager(str(ckpt_dir))
    step = ckpt.list_steps()[-1]
    path = os.path.join(str(ckpt_dir), f"step_{step:09d}")
    files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    return [np.load(os.path.join(path, f)) for f in files]


def _losses(text):
    return [float(m.group(2)) for m in map(STEP_LINE.fullmatch, text.splitlines()) if m]


# ---------------------------------------------------------------------------
# The entry point under torchrun
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,args", [
    ("llama3.2-1b", ["--steps", "3", "--batch", "4", "--seq", "32"]),
    ("llama3.2-1b", ["--steps", "3", "--batch", "4", "--seq", "32", "--microbatch", "2"]),
    ("falcon-mamba-7b", ["--steps", "1", "--batch", "2", "--seq", "16"]),
], ids=["llama", "llama-microbatch", "falcon-mamba"])
def test_torchrun_two_ranks_match_one_process(arch, args, tmp_path, capsys, monkeypatch):
    script = tmp_path / "train_f32.py"
    script.write_text(FLOAT32_MAIN)
    steps = args[args.index("--steps") + 1]
    common_args = ["--arch", arch, "--device", "cpu", "--log-every", "1", "--lr", str(LR),
                   "--ckpt-every", steps] + args
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(script)] + common_args + ["--ckpt-dir", str(tmp_path / "two")],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    two_losses = _losses(proc.stdout)
    assert len(two_losses) == int(steps), proc.stdout       # rank 0 alone prints

    monkeypatch.setattr(ttrain, "get_config", lambda *a, **k: _f32(a[0]))
    assert ttrain.main(common_args + ["--ckpt-dir", str(tmp_path / "one")]) == 0
    assert not dist.is_initialized()                         # main's own group is gone
    one_losses = _losses(capsys.readouterr().out)
    np.testing.assert_allclose(two_losses, one_losses, atol=1.5e-4)
    _hold_state(_last_state(tmp_path / "two"), _last_state(tmp_path / "one"), LR, int(steps),
                arch)


# ---------------------------------------------------------------------------
# The functions launch.train calls, in 2 processes over a FileStore
# ---------------------------------------------------------------------------


def _masked_batch(cfg, b, s, seed):
    pipe = SyntheticPipeline(DataConfig(b, s, cfg.vocab_size, seed=seed), cfg)
    batch = next(pipe)
    pipe.close()
    rng = np.random.default_rng(seed)
    keep = rng.random((b, s)) < np.linspace(0.3, 0.95, b)[:, None]   # counts differ by row
    batch["mask"] = keep.astype(np.float32)
    return batch


def _train(cfg, batches, rank=0, n_ranks=1, microbatch=0, compress=False):
    """``len(batches)`` steps; returns (metrics of each step, whole state
    leaves as numpy).  With ``n_ranks`` > 1 it runs on the group's mesh."""
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=LR, warmup_steps=1,
                                                 total_steps=len(batches),
                                                 compress_grads=compress),
                       microbatch=microbatch)
    dev = torch.device("cpu")
    layout = transformer.model_layout(cfg)
    if n_ranks == 1:
        params = common.init_params(torch.Generator().manual_seed(0), layout)
        from repro_torch.optim import adamw_init
        opt = adamw_init(params, cfg.moment_dtype)
        step_fn, out = make_train_step(cfg, tcfg), []
        for batch in batches:
            params, opt, m = step_fn(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
            out.append({k: float(v) for k, v in m.items()})
        return out, [x.numpy() for x in tree_flatten((params, opt))]
    mesh = mesh_mod.make_host_mesh(device=dev)
    rules = shd.default_rules(mesh, fsdp=cfg.fsdp)
    assert mesh.size(0) == n_ranks and mesh.get_local_rank("data") == rank
    with shd.use_rules(rules):
        params, opt = ttrain.init_state(cfg, rules, dev)
        step_fn, out = make_train_step(cfg, tcfg), []
        for batch in batches:
            mine = local_rows(batch, rank, n_ranks, microbatch)
            params, opt, m = step_fn(params, opt, {k: torch.from_numpy(v) for k, v in mine.items()})
            out.append({k: float(v) for k, v in m.items()})
    shardings = ttrain.state_shardings(layout, rules)
    whole = [sh.gather(x).numpy() for x, sh in zip(tree_flatten((params, opt)),
                                                  tree_flatten(shardings))]
    return out, whole, {"gathers": shd.collective_calls["all_gather"],
                        "reduce_scatters": shd.collective_calls["reduce_scatter"],
                        "shapes": [tuple(x.shape) for x in tree_flatten(params)]}


def _rank_main(rank, n_ranks, store_path, out_path, cfg, batches, microbatch, compress):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n_ranks), rank=rank,
                            world_size=n_ranks)
    try:
        got = _train(cfg, batches, rank, n_ranks, microbatch, compress)
        if rank == 0:
            torch.save(got, out_path)
    finally:
        dist.destroy_process_group()


def _two_ranks(tmp_path, cfg, batches, microbatch=0, compress=False):
    out = tmp_path / "rank0.pt"
    mp.start_processes(_rank_main, nprocs=2, start_method="spawn",
                       args=(2, str(tmp_path / "store"), str(out), cfg, batches, microbatch,
                             compress))
    return torch.load(out, weights_only=False)


def _hold_run(two, one, what):
    (m2, s2), (m1, s1) = two[:2], one
    for a, b in zip(m2, m1):
        assert a.keys() == b.keys()
        for k in b:
            assert (abs(a[k] - b[k]) <= METRIC_RTOL * abs(b[k])
                    or (k == "accuracy" and a[k] == b[k])), (what, k, a[k], b[k])
    _hold_state(s2, s1, LR, len(m1), what)


def test_moe_with_a_mask_on_two_ranks_matches_one_process(tmp_path):
    cfg = _f32("qwen3-moe-235b-a22b")
    b, s = 4, 32          # 128 tokens: 2 routing groups of 64, one a rank
    assert ttrain.split_refusal(cfg, b, s, 2) is None
    batches = [_masked_batch(cfg, b, s, seed) for seed in (0, 1)]
    mask = batches[0]["mask"]
    assert mask[:2].sum() != mask[2:].sum()                 # the ranks' token counts differ
    two = _two_ranks(tmp_path, cfg, batches)
    one = _train(cfg, batches)
    assert {"moe_load_balance", "moe_router_z", "moe_dropped"} <= set(one[0][0])
    _hold_run(two, one, "qwen3-moe")


def test_fsdp_on_two_ranks_matches_one_process(tmp_path):
    cfg = _f32("llama3.2-1b", fsdp=True)
    assert cfg.remat
    pipe = SyntheticPipeline(DataConfig(4, 32, cfg.vocab_size), cfg)
    batches = [next(pipe) for _ in range(2)]
    pipe.close()
    two = _two_ranks(tmp_path, cfg, batches)
    _hold_run(two, _train(cfg, batches), "fsdp llama")
    counts = two[2]
    # masters held as shards: every leaf with an embed axis is half its size
    layout = dict(common.tree_leaves(transformer.model_layout(cfg)))
    halved = [tuple(d.shape) != shape for d, shape in zip(layout.values(), counts["shapes"])]
    assert sum(halved) == sum("embed" in d.axes for d in layout.values()) > 0
    # a layer's leaves are gathered in its forward and again in its recompute
    assert counts["reduce_scatters"] > 0 and counts["gathers"] > counts["reduce_scatters"]


def test_compressed_fsdp_on_two_ranks_matches_one_process(tmp_path):
    """Int8 compression of FSDP shards: each shard's scale takes its whole
    leaf's max|g| over the data group, so it quantizes as one process's."""
    cfg = _f32("llama3.2-1b", fsdp=True)
    pipe = SyntheticPipeline(DataConfig(4, 32, cfg.vocab_size), cfg)
    batches = [next(pipe)]
    pipe.close()
    two = _two_ranks(tmp_path, cfg, batches, compress=True)
    _hold_run(two, _train(cfg, batches, compress=True), "compressed fsdp llama")


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_a_split_that_breaks_a_routing_group_is_refused(capsys):
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)     # groups of 64 tokens
    assert ttrain.split_refusal(cfg, 4, 32, 2) is None
    why = ttrain.split_refusal(cfg, 4, 16, 2)                 # a rank holds 32 tokens
    assert "not a whole number of the global batch's 64-token routing groups" in why
    assert "batch 6 does not split" in ttrain.split_refusal(cfg, 6, 32, 4)
    assert ttrain.split_refusal(get_config("llama3.2-1b", True), 4, 16, 2) is None
    assert "microbatch" in ttrain.split_refusal(get_config("llama3.2-1b", True), 4, 16, 2, 4)


def test_refusal_prices_one_ranks_share(monkeypatch):
    """A leaf the rules shard over data counts 1/data of its bytes; the
    message names the ranks that would fit."""
    cfg = get_config("llama3-405b")
    layout = dict(common.tree_leaves(transformer.model_layout(cfg)))
    total = sum(int(np.prod(d.shape)) for d in layout.values())
    rules = shd.default_rules(shd.ShapeMesh({"data": 8, "model": 1}), fsdp=True)
    held = sum(int(np.prod(d.shape)) // (8 if "embed" in d.axes else 1)
               for d in layout.values())
    assert ttrain.rank_share(cfg, rules) == pytest.approx(held / total, rel=1e-12)
    assert ttrain.rank_share(cfg, None) == 1.0
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * 10**9))
    need = ttrain.train_state_bytes(cfg)
    fit = ttrain.ranks_to_fit(cfg, 80 * 10**9)
    assert fit is not None and fit & (fit - 1) == 0
    for d, fits in ((fit // 2, False), (fit, True)):
        r = shd.default_rules(shd.ShapeMesh({"data": d, "model": 1}), fsdp=True)
        assert (need * ttrain.rank_share(cfg, r) <= 80 * 10**9) == fits
        assert (ttrain.refusal(cfg, torch.device("cuda"), r) is None) == fits
    why = ttrain.refusal(cfg, torch.device("cuda"))
    assert f"one of 1 rank(s)" in why and f"one of {fit} data-parallel ranks" in why
    mamba = ttrain.refusal(get_config("falcon-mamba-7b"), torch.device("cuda"))
    assert "no number of data-parallel ranks fits it" in mamba
