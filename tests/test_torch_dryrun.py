"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), which is read, never imported: its
import forces 512 host devices on every later JAX test of the process.

* the cell grid and the skip reasons equal the reference's
  ``shape_applicable``; the meshes' model axis is 1 wide;
* ``TRAIN_OVERRIDES`` equals the reference's, read through ``ast``;
* params, m, v and cache bytes per device equal those of the reference's
  rules on the same meshes, leaf by leaf, for all ten archs at full width;
* REDUCED train, prefill and decode cells on an 8-rank fake group come
  out ``ok`` (hubert's prefill through ``transformer.forward``), and a
  full-width multi-pod FSDP cell, whose leaves sit on ("data", "pod") against
  the mesh's order, comes out ``ok`` with the reference's state bytes per
  device, leaf by leaf;
* the CLI's JSONL renders through ``scripts/roofline_table.py``;
* a ``gpu_serving`` row equals the reference's ``compare_techniques`` on
  the same roofline terms within 0.006;
* a cell imports neither jax nor the JAX package.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import shape_applicable as jax_applicable
from repro.core import workload as jwl
from repro.models import transformer as jtf
from repro.models.common import ParamDef as JaxParamDef
from repro.parallel import sharding as jshd
from repro.serving import autoscale as jauto
from repro.serving.kvcache import split_kv_needed as jax_split_kv
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as shd

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
EIGHT = ("8x1", (8, 1), ("data", "model"))


def _reference_overrides():
    tree = ast.parse((REPO / "src" / "repro" / "launch" / "dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "TRAIN_OVERRIDES":
            call = node.value
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(call.keys, call.values)}
    raise AssertionError("TRAIN_OVERRIDES not found in the reference's dry run")


def test_train_overrides_are_the_references():
    assert dryrun.TRAIN_OVERRIDES == _reference_overrides()
    assert set(dryrun.TRAIN_OVERRIDES) == set(ARCH_NAMES)


def test_meshes_have_a_one_wide_model_axis_and_split_the_batch_whole():
    # the single pod holds the reference's 16 x 16 chips; the multi-pod mesh two pods of
    # 128, so that train_4k's 256 rows split one a rank on both
    for multi_pod, shape in ((False, (256, 1)), (True, (2, 128, 1))):
        name, got, axes = dryrun.MESHES[multi_pod]
        assert got == shape and axes[-1] == "model" and ("pod" in axes) == multi_pod
        assert name == "x".join(map(str, shape))
        rules = shd.default_rules(shd.ShapeMesh(dict(zip(axes, shape))))
        assert dryrun._rows(rules, SHAPES["train_4k"].global_batch) == 1


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_grid_and_skips_are_the_references(arch):
    for shape_name, shape in SHAPES.items():
        want = jax_applicable(jax_config(arch), shape)
        assert tuple(dryrun.shape_applicable(get_config(arch), shape)) == tuple(want)
        if not want[0]:
            for multi_pod in (False, True):
                r = dryrun.run_cell(arch, shape_name, multi_pod)
                assert r["status"] == "skipped" and r["reason"] == want[1]
                assert r["mesh"] == dryrun.MESHES[multi_pod][0]


def _ref_shards(layout, rules, sizes):
    leaves = jax.tree.leaves(layout, is_leaf=lambda x: isinstance(x, JaxParamDef))
    out = []
    for d in leaves:
        spec = rules.resolve(d.axes, d.shape)
        shape = list(d.shape)
        for i, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                shape[i] //= sizes[a]
        out.append(tuple(shape))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_state_bytes_per_device_are_the_references_leaf_by_leaf(arch, multi_pod):
    from repro_torch.models import transformer

    _, mesh_shape, axes = dryrun.MESHES[multi_pod]
    sizes = dict(zip(axes, mesh_shape))
    mesh = shd.ShapeMesh(sizes)
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape_name in ("train_4k", "decode_32k"):
        shape = SHAPES[shape_name]
        over = dryrun.TRAIN_OVERRIDES[arch] if shape.kind == "train" else {}
        split_kv = shape.kind == "decode" and jax_split_kv(jcfg, 1)
        kw = dict(fsdp=jcfg.fsdp, split_kv=split_kv, seq_shard=bool(over.get("seq_shard")))
        jrules, rules = jshd.default_rules(mesh, **kw), shd.default_rules(mesh, **kw)
        want = _ref_shards(jtf.model_layout(jcfg), jrules, sizes)
        got = dryrun.leaf_shards(transformer.model_layout(cfg), rules)
        assert list(got.values()) == want
        n = float(sum(np.prod(s, dtype=np.float64) for s in want))
        parts = dryrun.state_bytes(cfg, shape.kind, rules, shape.global_batch, shape.seq_len)
        if shape.kind == "train":
            mom = getattr(torch, jcfg.moment_dtype).itemsize
            assert parts == {"params": 4 * n, "m": mom * n, "v": mom * n}
            continue
        if not jcfg.is_encoder_only:
            cwant = _ref_shards(jtf.cache_layout(jcfg, shape.global_batch, shape.seq_len),
                                jrules, sizes)
            c_layout = transformer.cache_layout(cfg, shape.global_batch, shape.seq_len)
            assert list(dryrun.leaf_shards(c_layout, rules).values()) == cwant
            item = getattr(torch, jcfg.dtype).itemsize
            assert parts["cache"] == item * sum(np.prod(s, dtype=np.float64) for s in cwant)


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("llama3.2-1b", "prefill_32k"),
                                        ("llama3.2-1b", "decode_32k"),
                                        ("hubert-xlarge", "prefill_32k"),
                                        ("falcon-mamba-7b", "long_500k")])
def test_reduced_cells_on_eight_fake_ranks_come_out_ok(arch, shape):
    r = dryrun.run_cell(arch, shape, False, reduced=True, device="cpu", mesh=EIGHT)
    assert r["status"] == "ok", r.get("traceback")
    assert r["chips"] == 8 and r["mesh"] == "8x1" and r["device"] == "cpu"
    rf, mem = r["roofline"], r["memory"]
    assert rf["t_step_s"] > 0 and rf["dominant"] in ("compute", "memory", "collective")
    rows = SHAPES[shape].global_batch // 8 or SHAPES[shape].global_batch
    assert r["applied"]["rows_per_rank"] == rows
    assert mem["peak_live_bytes_per_device"] >= mem["params_bytes_per_device"] > 0
    assert mem["hbm_fraction"] == mem["peak_live_bytes_per_device"] / (80 * 1024 ** 3)
    if shape == "train_4k":
        # 32 rows a rank split into the reference's 4 microbatches; gradients all-reduced
        assert r["applied"]["microbatch"] == 4
        assert r["collectives"]["all-reduce"] > 3 * mem["params_bytes_per_device"] / 4
    else:
        assert r["collectives"] == {"total": 0.0}
    assert not shd.active_rules().mesh and not torch.distributed.is_initialized()


def test_a_multi_pod_fsdp_cell_reports_the_ports_exception():
    """Once refused by the port (its ("data", "pod") FSDP leaves against the
    mesh's (pod, data) order), gemma3-27b's multi-pod decode cell now reckons:
    ``ok``, with params and cache bytes per device equal to the reference's
    rules on the same mesh, leaf by leaf, and all-gathers of the FSDP
    leaves."""
    from repro_torch.models import common, transformer

    r = dryrun.run_cell("gemma3-27b", "decode_32k", True, device="cpu")
    assert r["status"] == "ok", r.get("traceback")
    assert not torch.distributed.is_initialized()
    _, mesh_shape, axes = dryrun.MESHES[True]
    sizes = dict(zip(axes, mesh_shape))
    jcfg, cfg, shape = jax_config("gemma3-27b"), get_config("gemma3-27b"), SHAPES["decode_32k"]
    kw = dict(fsdp=jcfg.fsdp, split_kv=r["split_kv"], seq_shard=False)
    mesh = shd.ShapeMesh(sizes)
    jrules, rules = jshd.default_rules(mesh, **kw), shd.default_rules(mesh, **kw)
    layout = transformer.model_layout(cfg)
    specs = [s for _, s in common.tree_leaves(shd.param_specs(layout, rules))]
    assert jcfg.fsdp and ("data", "pod") in [e for spec in specs for e in spec]
    want = _ref_shards(jtf.model_layout(jcfg), jrules, sizes)
    paths = [p for p, _ in common.tree_leaves(layout)]
    assert list(dryrun.leaf_shards(layout, rules).values()) == want
    params = sum(float(np.prod(w, dtype=np.float64)) * dryrun.serving_dtype(cfg, p).itemsize
                 for w, p in zip(want, paths))
    assert r["memory"]["params_bytes_per_device"] == params
    cwant = _ref_shards(jtf.cache_layout(jcfg, shape.global_batch, shape.seq_len), jrules,
                        sizes)
    cache = getattr(torch, jcfg.dtype).itemsize * sum(float(np.prod(w, dtype=np.float64))
                                                      for w in cwant)
    assert r["memory"]["cache_bytes_per_device"] == cache
    assert r["collectives"]["all-gather"] > 0


def test_microbatch_is_cut_to_what_the_rows_split():
    assert dryrun._applied_microbatch(8, 1) == 1
    assert dryrun._applied_microbatch(8, 12) == 6
    assert dryrun._applied_microbatch(0, 3) == 1


def _cli(tmp_path, *args):
    out = tmp_path / "cells.jsonl"
    code = dryrun.main(["--arch", "llama3.2-1b", "--reduced", "--single-pod", "--device",
                        "cpu", "--out", str(out), *args])
    return code, [json.loads(x) for x in out.read_text().splitlines()]


def test_cli_jsonl_renders_through_the_references_table(tmp_path):
    code, records = _cli(tmp_path, "--shape", "decode_32k")
    code2, more = _cli(tmp_path, "--shape", "long_500k")
    assert code == code2 == 0 and len(records) == 1 and len(more) == 2
    run = subprocess.run([sys.executable, str(REPO / "scripts" / "roofline_table.py"),
                          str(tmp_path / "cells.jsonl")], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert "llama3.2-1b" in lines[1] and "decode_32k" in lines[1] and "256x1" in lines[1]
    assert "skip: long_500k" in lines[2]


def test_gpu_serving_row_matches_the_references_compare_techniques():
    record = {"status": "ok", "arch": "llama3.2-1b", "shape": "decode_32k", "mesh": "256x1",
              "roofline": {"t_compute_s": 0.0021, "t_memory_s": 0.0117,
                           "t_collective_s": 0.0009}}
    (row,) = dryrun.serving_rows([record, dict(record, mesh="2x128x1")], device="cpu")
    rf = record["roofline"]
    terms = jauto.RooflineTerms(rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"])
    want = jauto.compare_techniques(terms, jwl.generate_trace(
        jwl.WorkloadConfig(n_steps=512, seed=3)))
    assert row["name"] == "gpu_serving/llama3.2-1b/decode_32k"
    for k, s in want.items():
        assert abs(row["gains"][k] - float(s.power_gain)) <= 0.006, k
    assert row["alpha_tpu"] == pytest.approx(terms.alpha_tpu)
    assert row["row"].startswith("prop=") and row["row"].endswith(f"alpha_tpu={terms.alpha_tpu:.2f}")


def test_a_cell_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.launch import dryrun\n"
            "r = dryrun.run_cell('llama3.2-1b', 'decode_32k', False, reduced=True,\n"
            "                    device='cpu', mesh=('8x1', (8, 1), ('data', 'model')))\n"
            "assert r['status'] == 'ok', r\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
