"""The port's op-level cost counter (``repro_torch.analysis.op_cost``)
held against the JAX package's HLO analysis (``repro.analysis.hlo_parse``).

* the cases of ``tests/test_hlo_analysis.py``, each counted by the port
  and analysed by ``analyze_hlo`` on the same function jitted on the CPU:
  a matmul's FLOPs exact in both, a 6-trip and a 3 × 4 nested loop within
  1 % of the reference, bytes growing with size, a backward ≈ 3× its
  forward, no collective on one device;
* each kernel entry's reported work equals its formula on the plain
  route, B2's 68.8 GFLOP at llama's serving shape (on fake tensors), and
  no op inside an entry is counted;
* a training step counts the same FLOPs on real CPU tensors and on fake
  ones (``launch.dryrun.reckon``);
* on 2 gloo ranks, the data-parallel step's all-reduce bytes are the
  gradient leaves' bytes plus its scalar statistics, and FSDP's gather and
  reduce-scatter bytes follow the shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis.hlo_parse import analyze_hlo
from repro_torch.analysis import op_cost
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline, local_rows
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.kernels.ssm_scan.backward import BOUNDARY_STEPS
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as ttrain
from repro_torch.models import common, transformer
from repro_torch.optim import adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.train import make_train_step

torch.set_num_threads(1)


def _hlo(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def _ours(fn, *shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return op_cost.analyze(fn, *(torch.randn(s, generator=gen) for s in shapes))


# ---------------------------------------------------------------------------
# The cases of test_hlo_analysis.py, beside the reference's analysis
# ---------------------------------------------------------------------------


def test_dot_flops_exact_in_both():
    want = 2 * 128 * 256 * 64
    ref = _hlo(lambda x, y: x @ y, (128, 256), (256, 64))
    ours = _ours(lambda x, y: x @ y, (128, 256), (256, 64))
    assert ours.flops == want and ref.flops == want
    assert ours.flops_by_name == {"mm": want}
    # result and operands once each, as the reference charges a dot
    assert ours.bytes == 4 * (128 * 64 + 128 * 256 + 256 * 64)


def test_loop_multiplies_its_body_as_the_reference_counts_a_scan():
    def jfn(w, x):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        return jax.lax.scan(body, x, w)[0]

    def tfn(w, x):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x

    ref = _hlo(jfn, (6, 64, 64), (8, 64))
    ours = _ours(tfn, (6, 64, 64), (8, 64))
    assert ours.flops == 6 * 2 * 8 * 64 * 64
    assert ours.flops == pytest.approx(ref.flops, rel=0.01)
    assert ours.transcendentals == 6 * 8 * 64


def test_nested_loop_multiplies_twice_as_the_reference():
    def jfn(w, x):
        def outer(c, wo):
            return jax.lax.scan(lambda ci, wi: (ci @ wi, None), c, wo)[0], None
        return jax.lax.scan(outer, x, w)[0]

    def tfn(w, x):
        for i in range(w.shape[0]):
            for j in range(w.shape[1]):
                x = x @ w[i, j]
        return x

    ref = _hlo(jfn, (3, 4, 32, 32), (8, 32))
    ours = _ours(tfn, (3, 4, 32, 32), (8, 32))
    assert ours.flops == 3 * 4 * 2 * 8 * 32 * 32
    assert ours.flops == pytest.approx(ref.flops, rel=0.01)


def test_bytes_scale_with_tensor_size_in_both():
    fn_j = lambda x: jnp.tanh(x) * 2.0
    fn_t = lambda x: torch.tanh(x) * 2.0
    r1, r2 = _hlo(fn_j, (256, 256)), _hlo(fn_j, (1024, 1024))
    o1, o2 = _ours(fn_t, (256, 256)), _ours(fn_t, (1024, 1024))
    assert r2.bytes > 10 * r1.bytes and o2.bytes > 10 * o1.bytes
    # two unfused elementwise ops: each reads and writes the tensor once
    assert o2.bytes == 2 * 2 * 4 * 1024 * 1024


def test_backward_flops_roughly_triple_forward_in_both():
    def jfwd(w, x):
        for _ in range(4):
            x = jnp.tanh(x @ w)
        return jnp.sum(x)

    def tfwd(w, x):
        for _ in range(4):
            x = torch.tanh(x @ w)
        return torch.sum(x)

    def tgrad(w, x):
        w = w.requires_grad_()
        return torch.autograd.grad(tfwd(w, x), w)

    rf, rg = _hlo(jfwd, (64, 64), (8, 64)), _hlo(jax.grad(jfwd), (64, 64), (8, 64))
    of, og = _ours(tfwd, (64, 64), (8, 64)), _ours(tgrad, (64, 64), (8, 64))
    assert 2.5 <= rg.flops / rf.flops <= 3.5
    assert 2.5 <= og.flops / of.flops <= 3.5
    # the first layer's input takes no gradient in either: 4 + 4 + 3 products
    assert og.flops == pytest.approx(rg.flops, rel=0.01)


def test_no_collective_on_one_device():
    cost = _ours(lambda x: x @ x, (64, 64))
    assert cost.coll_total() == 0.0 and cost.collective_bytes() == {"total": 0.0}


def test_views_cost_nothing_gathers_and_scatters_as_the_reference():
    x = torch.randn(64, 32)
    idx = torch.arange(0, 64, 2)
    assert op_cost.analyze(lambda: x.view(32, 64).t()[3:9].unsqueeze(0).expand(2, 6, 32)).bytes == 0
    assert op_cost.analyze(lambda: x[idx]).bytes == 2 * 4 * 32 * 32
    buf, upd = torch.zeros(64, 32), torch.ones(8, 32)

    def write():
        buf[4:12] = upd
    assert op_cost.analyze(write).bytes == 2 * 4 * 8 * 32
    assert op_cost.analyze(lambda: buf.index_add(0, idx[:8], upd)).bytes == 3 * 4 * 8 * 32


# ---------------------------------------------------------------------------
# Kernel entries: their own work, on every route
# ---------------------------------------------------------------------------


def _kept(sq, sk, causal, window):
    keep = np.ones((sq, sk), bool)
    qpos, kpos = np.arange(sq)[:, None] + (sk - sq), np.arange(sk)[None, :]
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= (qpos - kpos) < window
    return int(keep.sum())


@pytest.mark.parametrize("sq,sk,causal,window", [(48, 48, True, None), (48, 48, True, 16),
                                                 (32, 48, False, None), (40, 40, False, 8),
                                                 (24, 40, True, 4)])
def test_kept_scores_counts_the_plain_versions_mask(sq, sk, causal, window):
    assert fa_ops.kept_scores(sq, sk, causal, window) == _kept(sq, sk, causal, window)


def _flash_inputs(b=2, s=48, h=4, kv=2, d=16, grad=False):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((b, s, n, d), generator=gen) for n in (h, kv, kv))
    return [t.requires_grad_(grad) for t in (q, k, v)]


@pytest.mark.parametrize("window", [None, 12])
def test_flash_entries_report_their_formula_and_hide_their_ops(window):
    b, s, h, kv, d = 2, 48, 4, 2, 16
    q, k, v = _flash_inputs(b, s, h, kv, d)
    kept = b * h * _kept(s, s, True, window)
    fwd = op_cost.analyze(lambda: flash_attention(q, k, v, causal=True, window=window))
    assert fwd.flops == 2 * (d + d) * kept and fwd.transcendentals == kept
    assert fwd.bytes == 4 * (2 * b * s * h * d + 2 * b * s * kv * d)
    assert set(fwd.by_op) == {"flash_attention_fwd"}

    q, k, v = _flash_inputs(b, s, h, kv, d, grad=True)
    with op_cost.OpCounter() as c:
        out = flash_attention(q, k, v, causal=True, window=window)
        torch.autograd.grad(out.sum(), (q, k, v))
    f, bwd = c.cost.flops_by_name["flash_attention_fwd"], c.cost.flops_by_name["flash_attention_bwd"]
    assert f == 2 * (d + d) * kept and bwd == 2.5 * f
    # forward: q, k, v, out, m, l; backward: q, k, v, out, m, l, dout read, dq, dk, dv written
    qb, kb, stats = 4 * b * s * h * d, 4 * b * s * kv * d, 4 * b * h * s
    assert c.cost.bytes_by_name["flash_attention_fwd"] == 2 * qb + 2 * kb + 2 * stats
    assert c.cost.bytes_by_name["flash_attention_bwd"] == 4 * qb + 4 * kb + 2 * stats


def test_b2_at_llamas_serving_shape_reports_68_8_gflop_on_fake_tensors():
    with FakeTensorMode():
        q = torch.empty((4, 2048, 32, 64), dtype=torch.bfloat16)
        k = torch.empty((4, 2048, 8, 64), dtype=torch.bfloat16)
        v = torch.empty_like(k)
        cost = op_cost.analyze(lambda: flash_attention(q, k, v, causal=True))
    assert cost.flops == 68_753_031_168 and f"{cost.flops / 1e9:.1f}" == "68.8"
    assert cost.bytes == 2 * (2 * q.numel() + 2 * k.numel())


def test_a_fake_tensor_is_checked_as_a_card_tensor():
    """Past the widest tile a fake tensor takes the card's wide route and
    reports its work (``fa_ops.wide_flops_per_score``: the scores recomputed
    in each slab), which the CPU's plain version does not do; a check the
    card makes and the CPU does not (a windowed call with Sq != Sk) raises."""
    kept = 2 * fa_ops.kept_scores(64, 64, True, None)
    with FakeTensorMode():
        q = torch.empty((1, 64, 2, 320), dtype=torch.bfloat16)   # past every tile's width
        cost = op_cost.analyze(lambda: flash_attention(q, q, q))
        assert cost.flops == 2 * (320 * 2 + 320) * kept == fa_ops.wide_flops_per_score(
            320, 320, False) * kept
        with pytest.raises(ValueError, match="Sq == Sk"):
            flash_attention(q, q[:, :32], q[:, :32], causal=False, window=8)
    x = torch.zeros((1, 64, 2, 320))
    cost = op_cost.analyze(lambda: flash_attention(x, x, x))
    assert cost.flops == 2 * (320 + 320) * kept


def test_scan_entries_report_their_formula():
    b, s, d, n = 2, 40, 24, 4
    gen = torch.Generator().manual_seed(5)
    delta, x = (torch.rand((b, s, d), generator=gen) * 0.1 for _ in range(2))
    B, C = (torch.randn((b, s, n), generator=gen) for _ in range(2))
    A_log = torch.randn((d, n), generator=gen)
    ins = 4 * (2 * b * s * d + 2 * b * s * n + d * n)
    outs = 4 * (b * s * d + b * d * n)
    store = 4 * b * -(-s // BOUNDARY_STEPS) * d * n
    fwd = op_cost.analyze(lambda: selective_scan(delta, B, C, x, A_log))
    assert (fwd.flops, fwd.bytes, fwd.transcendentals) == (0.0, ins + outs, b * s * d * n)
    assert set(fwd.by_op) == {"selective_scan"}

    leaves = [t.requires_grad_() for t in (delta, B, C, x, A_log)]
    with op_cost.OpCounter() as c:
        y, _ = selective_scan(*leaves)
        torch.autograd.grad(y.sum(), leaves)
    # the boundary store counts on every route, as the card's kernels move it
    assert c.cost.bytes_by_name["selective_scan"] == ins + outs + store
    assert c.cost.bytes_by_name["selective_scan_bwd"] == 2 * ins + 4 * b * s * d + store


def test_grid_argmin_reports_its_bytes():
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.kernels.grid_argmin import grid_argmin

    plat = ctl.fpga_platform(ACCELERATORS["tabla"])
    params = char.stack_platform_params([plat.params])
    cg = torch.linspace(0.5, 0.85, 13)
    bg = torch.linspace(0.5, 0.95, 19)
    masks = torch.ones((2, 13, 19), dtype=torch.bool)
    levels = torch.linspace(0.2, 1.0, 5).repeat(2, 1)
    cost = op_cost.analyze(lambda: grid_argmin(params, masks, levels, cg, bg))
    ins = op_cost.tensor_bytes(*params, masks, levels, cg, bg)
    assert cost.flops == 0 and cost.bytes == ins + 13 * 1 * 2 * 5
    assert set(cost.by_op) == {"grid_argmin"}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
def test_a_step_counts_the_same_on_real_and_fake_tensors(arch):
    cfg = get_config(arch, reduced=True)
    b, s, tcfg = 2, 32, TrainConfig()
    params = common.init_params(torch.Generator().manual_seed(0), transformer.model_layout(cfg))
    opt = adamw_init(params, cfg.moment_dtype)
    pipe = SyntheticPipeline(DataConfig(b, s, cfg.vocab_size), cfg)
    batch = {k: torch.from_numpy(v) for k, v in next(pipe).items()}
    pipe.close()
    with op_cost.OpCounter() as real:
        real.hold((params, opt, batch))
        make_train_step(cfg, tcfg)(params, opt, batch)
    fake = dryrun.reckon("train", cfg, b, s, shd.default_rules(None), tcfg, device="cpu")
    assert real.cost.flops == fake.cost.flops > 0
    assert real.cost.bytes == pytest.approx(fake.cost.bytes, rel=0.01)
    assert real.peak_bytes == pytest.approx(fake.peak_bytes, rel=0.01)
    parts = dryrun.state_bytes(cfg, "train", shd.default_rules(None), b, s)
    assert parts["params"] == op_cost.tensor_bytes(*(t for _, t in common.tree_leaves(params)))
    assert parts["m"] == op_cost.tensor_bytes(*(t for _, t in common.tree_leaves(opt.m)))


# ---------------------------------------------------------------------------
# Collective bytes on 2 gloo ranks
# ---------------------------------------------------------------------------


def _counted_rank(rank, n_ranks, store_path, out_path, cfg, batch):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n_ranks), rank=rank,
                            world_size=n_ranks)
    try:
        mesh = mesh_mod.make_host_mesh(device="cpu")
        rules = shd.default_rules(mesh, fsdp=cfg.fsdp)
        tcfg = TrainConfig(optimizer=OptimizerConfig(warmup_steps=1, total_steps=1))
        with shd.use_rules(rules):
            params, opt = ttrain.init_state(cfg, rules, torch.device("cpu"))
            mine = {k: torch.from_numpy(v) for k, v in local_rows(batch, rank, n_ranks).items()}
            with op_cost.OpCounter() as c:
                _, _, metrics = make_train_step(cfg, tcfg)(params, opt, mine)
        specs = dict(common.tree_leaves(shd.param_specs(transformer.model_layout(cfg), rules)))
        shards = {p: (tuple(t.shape), t.numel() * 4, shd.over_data(specs[p]))
                  for p, t in common.tree_leaves(params)}
        if rank == 0:
            torch.save({"collectives": c.cost.collective_bytes(), "shards": shards,
                        "metrics": sorted(metrics)}, out_path)
    finally:
        dist.destroy_process_group()


def _two_ranks(tmp_path, cfg):
    pipe = SyntheticPipeline(DataConfig(4, 32, cfg.vocab_size), cfg)
    batch = next(pipe)
    pipe.close()
    out = tmp_path / "rank0.pt"
    mp.start_processes(_counted_rank, nprocs=2, start_method="spawn",
                       args=(2, str(tmp_path / "store"), str(out), cfg, batch))
    return torch.load(out, weights_only=False)


def test_data_parallel_all_reduces_the_gradient_leaves(tmp_path):
    cfg = get_config("llama3.2-1b", reduced=True)
    got = _two_ranks(tmp_path, cfg)
    grads = sum(n for _, n, _ in got["shards"].values())
    # the token denominator (one fp32) and the stacked metrics (one fp32 each)
    scalars = 4 * (1 + len(got["metrics"]) - 2)     # grad_norm and lr come after the sum
    assert got["collectives"] == {"all-reduce": grads + scalars, "total": grads + scalars}


def test_fsdp_gathers_and_reduce_scatters_follow_the_shards(tmp_path):
    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), fsdp=True)
    got = _two_ranks(tmp_path, cfg)
    held = {p: n for p, (_, n, sharded) in got["shards"].items() if sharded}
    assert held and cfg.remat
    per_layer = {p: n for p, n in held.items() if p.split("/")[0] in ("prefix", "slots", "rem")}
    top = sum(held.values()) - sum(per_layer.values())
    n_per = transformer.scanned_layers(cfg)[1]
    # a stacked leaf is gathered one layer at a time, twice under remat; the top once
    gathered = top + 2 * sum(per_layer.values())
    # each gather's reduce-scatter takes the whole (2-rank) gradient of what it gathered
    scattered = 2 * (top + sum(per_layer.values()))
    c = got["collectives"]
    assert c["all-gather"] == gathered and c["reduce-scatter"] == scattered
    assert n_per >= 1
