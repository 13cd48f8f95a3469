"""Dry run: every (architecture × input shape × mesh) cell reckoned for
one rank on fake tensors (port of ``repro.launch.dryrun``).

Usage (from the repository root; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --single-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --reduced

The reference lowers and compiles each cell on its production meshes and
reads memory, FLOPs, bytes and collective bytes out of the compiled
program.  The port has no compiler: one rank's step runs through the
port's own entry points (``train.step.make_train_step``,
``serving.engine.make_prefill`` / ``make_decode_step``,
``transformer.forward`` for the encoder-only arch) on tensors that hold
no data (``FakeTensorMode``), inside a ``fake`` process group of the
mesh's ranks whose collectives move nothing.  ``analysis.op_cost``
counts what runs: FLOPs, bytes, collective bytes per device, and the
peak of live tensor bytes, the training state and the batch included.
The kernel entries report the card's work on fake tensors and launch
nothing.

**Meshes.**  The reference's chip counts with its model axis at 1:
``("data", "model") = (256, 1)`` (``"256x1"``) and ``("pod", "data",
"model") = (2, 128, 1)`` (``"2x128x1"``).  The port executes data
parallelism and FSDP only (``parallel.sharding``): a dry run that
invented tensor-parallel collectives would price a program the port does
not run.  The rules are the reference's (``default_rules(mesh,
fsdp=cfg.fsdp, split_kv=..., seq_shard=...)``), as are its training
overrides; ``seq_shard`` on a 1-wide model axis changes nothing.  A rank
holds ``global_batch / data`` rows (1 on 256 ranks), so a microbatch
count the rows do not split is cut to the largest that does, and the
record names both (``overrides``, ``applied``).  A cell the port cannot
run is reported with status ``"error"`` and the exception, as the
reference reports a cell that fails to lower; none is dropped.

**The record** keeps the reference's keys where the meaning is the same
(``status``, ``chips``, ``seq_shard``, ``split_kv``, ``fsdp``,
``memory``, ``collectives``, ``top_flops``, ``top_bytes``,
``top_sites``, ``roofline``, the last against ``HW_H100``), and adds
``mesh``, ``device`` (the fake tensors' device), ``trace_s`` (in place of
``lower_s`` / ``compile_s``) and ``applied``.  ``serving_rows`` turns the
single-pod ``decode_32k`` and ``train_4k`` cells into the reference's
``tpu_serving`` rows for the card (``gpu_serving/<arch>/<shape>``).
Results go to ``dryrun_results_torch.jsonl`` (appended; rendered by
``scripts/roofline_table.py``), never under ``benchmarks/``, whose
``dryrun_results.jsonl`` is the JAX package's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import op_cost
from repro_torch.analysis.roofline import HW_H100, model_flops_for, roofline_terms
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import workload as wl
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common, transformer
from repro_torch.optim.adamw import AdamWState, opt_state_layout
from repro_torch.parallel import sharding as shd
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.autoscale import RooflineTerms, compare_techniques
from repro_torch.serving.kvcache import cache_dtype, split_kv_needed
from repro_torch.train.step import make_train_step

#: Per-arch step tuning for train_4k, the reference's (its 16 GB chips'):
#: microbatch count, sequence-parallel residual stream, accumulator dtype.
TRAIN_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "gemma2-2b": dict(microbatch=8),
    "llama3-405b": dict(microbatch=8, seq_shard=True,
                        grad_accum_dtype="bfloat16"),
    "gemma3-27b": dict(microbatch=8, seq_shard=True),
    "llama3.2-1b": dict(microbatch=4),
    "internvl2-1b": dict(microbatch=4),
    "qwen3-moe-235b-a22b": dict(microbatch=8, seq_shard=True,
                                grad_accum_dtype="bfloat16"),
    "deepseek-v2-236b": dict(microbatch=8, seq_shard=True,
                             grad_accum_dtype="bfloat16"),
    "falcon-mamba-7b": dict(microbatch=8, seq_shard=True),
    "zamba2-2.7b": dict(microbatch=8),
    "hubert-xlarge": dict(microbatch=4),
}

#: mesh name → (shape, axes), by ``multi_pod``.
MESHES: Dict[bool, Tuple[str, Tuple[int, ...], Tuple[str, ...]]] = {
    False: ("256x1", (256, 1), ("data", "model")),
    True: ("2x128x1", (2, 128, 1), ("pod", "data", "model")),
}

DEFAULT_OUT = "dryrun_results_torch.jsonl"


def fake_device() -> str:
    """The device the fake tensors stand on: ``cuda`` where the host has a
    card, else ``cpu``.  Both reckon the same counts: the kernel entries
    report the card's work and check a fake tensor as a card tensor on
    either device, and no other code of a step reads the device."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks in this process (this
    one rank 0); its collectives move nothing.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a dry-run cell sets up its own process group; one is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_shape(shape, spec, rules: shd.ShardingRules) -> Tuple[int, ...]:
    """One rank's piece of a leaf of ``shape`` whose spec is ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in shd.entry_axes(entry):
            out[i] //= rules.mesh_axis_size(a) if rules.mesh is not None else 1
    return tuple(out)


def leaf_shards(layout: Any, rules: shd.ShardingRules) -> Dict[str, Tuple[int, ...]]:
    """Each leaf's shard shape on one rank, by path."""
    specs = dict(common.tree_leaves(shd.param_specs(layout, rules)))
    return {path: shard_shape(d.shape, specs[path], rules)
            for path, d in common.tree_leaves(layout)}


def serving_dtype(cfg: ModelConfig, path: str) -> torch.dtype:
    """A leaf's dtype in the serving engine's copy of the weights."""
    if path.rsplit("/", 1)[-1] in engine_mod.FP32_LEAVES:
        return torch.float32
    return getattr(torch, cfg.dtype)


def _empty_tree(layout: Any, rules: shd.ShardingRules, dtype_of: Callable[[str], torch.dtype],
                device) -> Any:
    shapes = leaf_shards(layout, rules)
    return common.place_leaves(layout, {
        path: torch.empty(shapes[path], dtype=dtype_of(path), device=device)
        for path in shapes})


def state_bytes(cfg: ModelConfig, kind: str, rules: shd.ShardingRules, global_batch: int,
                seq_len: int) -> Dict[str, float]:
    """Per-device bytes of params, m, v (training) or params and cache
    (serving) under ``rules``, from the layouts: no tensor is made."""
    layout = transformer.model_layout(cfg)
    shapes = leaf_shards(layout, rules)
    n = lambda shape: float(np.prod(shape, dtype=np.float64))
    if kind == "train":
        mom = getattr(torch, cfg.moment_dtype).itemsize
        p = sum(n(s) for s in shapes.values())
        return {"params": 4 * p, "m": mom * p, "v": mom * p}
    out = {"params": sum(n(s) * serving_dtype(cfg, path).itemsize
                         for path, s in shapes.items())}
    if kind == "decode":
        c_layout = transformer.cache_layout(cfg, global_batch, seq_len)
        out["cache"] = cache_dtype(cfg).itemsize * sum(
            n(s) for s in leaf_shards(c_layout, rules).values())
    return out


def _rows(rules: shd.ShardingRules, global_batch: int) -> int:
    """A rank's rows of the global batch: split over the mesh axes the
    rules put ``batch`` on (none where they do not divide it)."""
    spec = rules.resolve(("batch",), (global_batch,))
    return shard_shape((global_batch,), spec, rules)[0]


def reckon(kind: str, cfg: ModelConfig, global_batch: int, seq_len: int,
           rules: shd.ShardingRules, tcfg: Optional[TrainConfig] = None,
           device: Optional[str] = None) -> op_cost.OpCounter:
    """One rank's step of ``kind`` ("train", "prefill", "decode") of a
    global batch of ``global_batch`` rows of ``seq_len`` tokens, on fake
    tensors on ``device`` under ``rules`` (the rank's rows and shards are
    the rules'): the counter, its cost and its peak bytes with the state
    and the batch."""
    device = device or fake_device()
    rows = _rows(rules, global_batch)
    shd.data_group(rules)    # a pod mesh's group is cut on real tensors, before the fakes
    layout = transformer.model_layout(cfg)
    with FakeTensorMode(), shd.use_rules(rules), op_cost.OpCounter() as counter:
        if kind == "train":
            mdt = getattr(torch, cfg.moment_dtype)
            params = _empty_tree(layout, rules, lambda p: torch.float32, device)
            o_layout = opt_state_layout(layout)
            opt = AdamWState(step=torch.empty((), dtype=torch.int32, device=device),
                             m=_empty_tree(o_layout.m, rules, lambda p: mdt, device),
                             v=_empty_tree(o_layout.v, rules, lambda p: mdt, device))
            batch = make_batch_specs(cfg, rows, seq_len, "train", device)
            step = make_train_step(cfg, tcfg or TrainConfig())
            params, opt, _ = step(params, opt, batch)
        else:
            params = _empty_tree(layout, rules, lambda p: serving_dtype(cfg, p), device)
            with torch.inference_mode():
                if kind == "prefill":
                    batch = make_batch_specs(cfg, rows, seq_len, "prefill", device)
                    if cfg.is_encoder_only:
                        transformer.forward(params, cfg, batch)
                    else:
                        engine_mod.make_prefill(cfg, capacity=seq_len)(params, batch)
                else:
                    c_layout = transformer.cache_layout(cfg, global_batch, seq_len)
                    cache = _empty_tree(c_layout, rules, lambda p: cache_dtype(cfg), device)
                    tok = make_batch_specs(cfg, rows, seq_len, "decode", device)["tokens"]
                    pos = torch.empty((rows,), dtype=torch.int32, device=device)
                    engine_mod.make_decode_step(cfg)(params, cache, tok, pos)
    return counter


def _applied_microbatch(requested: int, rows: int) -> int:
    """The largest count up to ``requested`` that splits ``rows``."""
    return max(n for n in range(1, max(requested, 1) + 1) if rows % n == 0)


def parse_mesh(name: str) -> Tuple[str, Tuple[int, ...], Tuple[str, ...]]:
    """``"DxM"`` → ("data", "model"), ``"PxDxM"`` → ("pod", "data", "model")."""
    shape = tuple(int(x) for x in name.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None or shape[-1] != 1:
        raise ValueError(f"a mesh is DATAx1 or PODxDATAx1 (the port executes no model "
                         f"axis), got {name!r}")
    return name, shape, axes


def run_cell(arch: str, shape_name: str, multi_pod: bool, reduced: bool = False,
             device: Optional[str] = None,
             mesh: Optional[Tuple[str, Tuple[int, ...], Tuple[str, ...]]] = None,
             global_batch: Optional[int] = None, seq_len: Optional[int] = None
             ) -> Dict[str, Any]:
    """One cell's record (see the module docstring); ``mesh`` replaces
    the cell's mesh by ``(name, shape, axes)``, ``global_batch`` and
    ``seq_len`` the shape's (the record then names both)."""
    cfg = get_config(arch, reduced=reduced)
    shape = SHAPES[shape_name]
    if global_batch or seq_len:
        shape = dataclasses.replace(shape, global_batch=global_batch or shape.global_batch,
                                    seq_len=seq_len or shape.seq_len)
    ok, reason = shape_applicable(cfg, shape)
    mesh_name, mesh_shape, axes = mesh or MESHES[multi_pod]
    device = device or fake_device()
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if global_batch or seq_len:
        base.update(global_batch=shape.global_batch, seq_len=shape.seq_len)
    if not ok:
        return {**base, "status": "skipped", "reason": reason}

    chips = int(np.prod(mesh_shape))
    over = TRAIN_OVERRIDES.get(arch, {}) if shape.kind == "train" else {}
    seq_shard = bool(over.get("seq_shard", False))
    split_kv = shape.kind in ("decode", "prefill") and split_kv_needed(cfg, mesh_shape[-1])
    t0 = time.time()
    try:
        with fake_group(chips):
            rules = shd.default_rules(mesh_mod.make_mesh(mesh_shape, axes), fsdp=cfg.fsdp,
                                      split_kv=split_kv,
                                      seq_shard=seq_shard)
            rows = _rows(rules, shape.global_batch)
            applied: Dict[str, Any] = {}
            tcfg = None
            if shape.kind == "train":
                mb = _applied_microbatch(int(over.get("microbatch", 0)), rows)
                acc = over.get("grad_accum_dtype", "float32") if mb > 1 else None
                applied = {"rows_per_rank": rows, "microbatch": mb, "grad_accum_dtype": acc,
                           "seq_shard": "no effect: the model axis is 1 wide"}
                tcfg = TrainConfig(microbatch=mb if mb > 1 else 0,
                                   grad_accum_dtype=acc or "float32")
            else:
                applied = {"rows_per_rank": rows}
            counter = reckon(shape.kind, cfg, shape.global_batch, shape.seq_len, rules, tcfg,
                             device)
            parts = state_bytes(cfg, shape.kind, rules, shape.global_batch, shape.seq_len)
        trace_s = time.time() - t0
        hc = counter.cost
        colls = hc.collective_bytes()
        mf = model_flops_for(cfg, shape, cfg.active_params())
        rep = roofline_terms(hc.flops, hc.bytes, hc.coll_total(), mf, chips, hw=HW_H100)
        peak = counter.peak_bytes
        memory = {"peak_live_bytes_per_device": peak, "hbm_fraction": peak / HW_H100.hbm_bytes}
        memory.update({f"{k}_bytes_per_device": v for k, v in parts.items()})
        top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
        return {**base, "status": "ok", "chips": chips, "seq_shard": seq_shard,
                "split_kv": split_kv, "fsdp": cfg.fsdp, "device": device,
                "trace_s": round(trace_s, 1), "overrides": over, "applied": applied,
                "memory": memory, "collectives": colls,
                "top_flops": top(hc.flops_by_name, 8), "top_bytes": top(hc.by_op, 10),
                "top_sites": top(hc.bytes_by_name, 12), "roofline": rep.as_dict()}
    except Exception as e:  # noqa: BLE001 — a cell the port cannot run is a record
        return {**base, "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def serving_rows(records: List[Dict[str, Any]], device=None) -> List[Dict[str, Any]]:
    """The reference's ``tpu_serving`` rows for the card: each ok
    single-pod ``decode_32k`` / ``train_4k`` cell's roofline terms through
    ``compare_techniques`` (on ``device``) over the serving trace (512
    steps, seed 3).  Each row: ``name`` (``gpu_serving/<arch>/<shape>``),
    ``gains`` by technique, ``alpha_tpu`` and the reference's ``row``
    text, ``prop``, ``core``, ``hbm``, ``pg`` and ``alpha_tpu``."""
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=512, seed=3))
    rows, seen = [], set()
    for r in records:
        if (r["status"] != "ok" or r["mesh"] != MESHES[False][0]
                or r["shape"] not in ("decode_32k", "train_4k")):
            continue
        key = (r["arch"], r["shape"])
        if key in seen:
            continue
        seen.add(key)
        rf = r["roofline"]
        terms = RooflineTerms(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
        g = {k: v.power_gain for k, v in compare_techniques(terms, trace, device=device).items()}
        rows.append({"name": f"gpu_serving/{r['arch']}/{r['shape']}", "gains": g,
                     "alpha_tpu": terms.alpha_tpu,
                     "row": (f"prop={g['proposed']:.2f}x;core={g['core_only']:.2f}x"
                             f";hbm={g['bram_only']:.2f}x;pg={g['power_gating']:.2f}x"
                             f";alpha_tpu={terms.alpha_tpu:.2f}")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs (CI-speed sanity run)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device: 'cuda' (the default where the host has a "
                         "card) or 'cpu'; nothing runs on either")
    ap.add_argument("--mesh", default=None,
                    help="reckon on this mesh instead (DATAx1 or PODxDATAx1, e.g. 4x1)")
    ap.add_argument("--batch", type=int, default=None, help="the shapes' global batch instead")
    ap.add_argument("--seq", type=int, default=None, help="the shapes' sequence length instead")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_NAMES
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    custom = parse_mesh(args.mesh) if args.mesh else None
    if custom:
        meshes = [False]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, mp, reduced=args.reduced, device=args.device,
                             mesh=custom, global_batch=args.batch, seq_len=args.seq)
                results.append(r)
                status = r["status"]
                if status == "ok":
                    rf = r["roofline"]
                    extra = (f"dom={rf['dominant']} "
                             f"t={rf['t_step_s']:.4f}s "
                             f"mfu={rf['mfu_at_roofline']:.2f} "
                             f"hbm={r['memory']['hbm_fraction']:.2f} "
                             f"[{r['trace_s']}s]")
                elif status == "error":
                    extra = r["error"][:160]
                else:
                    extra = r["reason"][:80]
                print(f"{arch:22s} {shape:12s} {r['mesh']:8s} {status:8s} "
                      f"{extra}", flush=True)
    with open(args.out, "a") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n{len(results)} cells, {n_err} errors → {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
