"""The fleet axis split over devices (``simulate_fleet_stream(shard=...)``,
``run_campaign(shard=...)``), on the CPU.

* K = 3 cells (padded to 4) on a fleet mesh of two and of four CPU slots,
  with an availability schedule, emitted fields and a three-tenant plane:
  against the port's unsharded run by the reference test's gate
  (``tests/test_scenarios.py::test_streaming_shards_fleet_axis_across_devices``)
  and, here, every field of the summary bit-equal;
* against JAX's own sharded run (a subprocess with two forced host
  devices) within the fleet parity tolerances of ``test_torch_stream.py``:
  1e-5 relative, misses and emitted bins equal;
* ``run_campaign`` on two scenarios through ``fleet_mesh(devices=[cpu,
  cpu])`` against the unsharded campaign;
* ``fleet_mesh()`` is None without two cards, ``shard_fleet``'s split,
  replication and pass-through;
* ``shard=True`` builds no fleet mesh and runs the unsharded path (a split
  is slower than one card while the loop is bound by host launches).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import scenarios as tscn
from repro_torch.core import scheduler as tsched
from repro_torch.core.accelerators import ACCELERATORS
from repro_torch.parallel import sharding as shd

S, CHUNK = 200, 64
TECHS = ("proposed", "core_only", "power_gating")          # K = 3: padded on 2 and 4
SPEC = ([2.0, 1.0, 0.0], [1.0, 8.0, 64.0], [0.5, 0.3, 0.2])
EMIT = ("power", "n_active", "predicted_bin")
RTOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

JAX_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.core import characterization as char, controller as ctl, scenarios as scn
from repro.core import scheduler as sched
from repro.core.accelerators import ACCELERATORS
from repro.parallel import sharding as shd
assert jax.local_device_count() == 2 and shd.fleet_mesh() is not None
d = np.load(sys.argv[1])
out = {}
for name in ("aggregate", "tenants"):
    cfg = ctl.ControllerConfig(gated_power_frac=0.05,
                               scheduler="priority" if name == "tenants" else "none")
    params = char.stack_platform_params([ctl.fpga_platform(ACCELERATORS["tabla"]).params])
    tables = ctl.fleet_bin_tables(params, cfg, tuple(d["techs"]))
    kw = {}
    if name == "tenants":
        kw["tenant_spec"] = sched.make_tenants(*d["spec"])
    for shard in (True, False):
        r = ctl.simulate_fleet_stream(tables, d[name], cfg, chunk_size=int(d["chunk"]),
                                      shard=shard, avail=d["avail"], emit=tuple(d["emit"]), **kw)
        key = name + ("" if shard else "-unsharded")
        for f in r._fields:
            x = getattr(r, f)
            if isinstance(x, (np.ndarray, jax.Array)):
                out[key + "/" + f] = np.asarray(x)
        for e, x in r.emitted.items():
            out[key + "/emit/" + e] = np.asarray(x)
np.savez(sys.argv[2], **out)
print("JAX_SHARDED_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    trace = tscn.get_scenario("burse").trace(S, seed=0)
    avail = np.where(np.arange(S) % 50 < 12, 5.0, 8.0).astype(np.float32)
    rng = np.random.default_rng(3)
    plane = rng.uniform(0.0, 0.45, (S, 3)).astype(np.float32)
    return trace, avail, plane


def _run(name, shard):
    trace, avail, plane = _inputs()
    cfg = tctl.ControllerConfig(gated_power_frac=0.05,
                                scheduler="priority" if name == "tenants" else "none")
    params = tchar.stack_platform_params([tctl.fpga_platform(ACCELERATORS["tabla"]).params])
    tables = tctl.fleet_bin_tables(params, cfg, TECHS, device="cpu")
    kw = {"tenant_spec": tsched.make_tenants(*SPEC)} if name == "tenants" else {}
    return tctl.simulate_fleet_stream(tables, plane if name == "tenants" else trace, cfg,
                                      chunk_size=CHUNK, shard=shard, avail=avail, emit=EMIT,
                                      device="cpu", **kw)


def _leaves(prefix, x):
    if hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(f"{prefix}/{f}", getattr(x, f))
    else:
        yield prefix, np.asarray(x)


def _fields(r):
    out = {f: getattr(r, f) for f in r._fields if isinstance(getattr(r, f), np.ndarray)}
    out.update(_leaves("final_predictor", r.final_predictor))
    out.update({f"emit/{e}": x for e, x in r.emitted.items()})
    return out


@pytest.mark.parametrize("name", ["aggregate", "tenants"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_stream_matches_unsharded(name, n_dev):
    a = _run(name, shd.fleet_mesh(devices=["cpu"] * n_dev))
    b = _run(name, False)
    # the reference test's gate
    np.testing.assert_allclose(a.mean_power_w, b.mean_power_w, rtol=1e-6)
    np.testing.assert_allclose(a.qos_violation_rate, b.qos_violation_rate)
    np.testing.assert_array_equal(a.mispredictions, b.mispredictions)
    # cells are independent and each runs the same ops: every field is equal
    fa, fb = _fields(a), _fields(b)
    assert sorted(fa) == sorted(fb) and a.n_steps == b.n_steps == S
    for f in fb:
        assert fa[f].shape == fb[f].shape and np.array_equal(fa[f], fb[f]), f
    assert a.mean_power_w.shape == (1, len(TECHS))


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_sharded")
    trace, avail, plane = _inputs()
    np.savez(tmp / "in.npz", aggregate=trace, tenants=plane, avail=avail, techs=np.array(TECHS),
             spec=np.array(SPEC, np.float32), chunk=CHUNK, emit=np.array(EMIT))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", JAX_SHARDED, str(tmp / "in.npz"),
                           str(tmp / "out.npz")], capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0 and "JAX_SHARDED_OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", ["aggregate", "tenants"])
def test_sharded_stream_matches_jax_sharded(name, jax_sharded):
    got = _run(name, shd.fleet_mesh(devices=["cpu", "cpu"]))
    want = {k.split("/", 1)[1]: v for k, v in jax_sharded.items() if k.startswith(name + "/")}
    alone = {k.split("/", 1)[1]: v for k, v in jax_sharded.items()
             if k.startswith(name + "-unsharded/")}
    assert sorted(alone) == sorted(want)
    for f, x in alone.items():                   # JAX's sharding moves nothing either
        np.testing.assert_allclose(want[f], x, rtol=1e-6, err_msg=f)
    exact = ("mispredictions", "margin_misses", "emit/predicted_bin", "emit/n_active")
    close = ("mean_power_w", "qos_violation_rate", "served_fraction", "mean_backlog",
             "final_backlog", "offered", "mean_avail_nodes", "tenant_qos_violation_rate",
             "emit/power")
    if name == "tenants":
        # Inside its compiled chunk scan the JAX package serves a tenant 1e-9..1.2e-8
        # of work where the port serves 0, so the port flags starvation at a few more
        # steps (bounded step by step in test_torch_stream.py); never at fewer.
        for f in ("tenant_served_fraction", "tenant_final_backlog"):
            np.testing.assert_allclose(getattr(got, f), want[f], rtol=0, atol=1e-5, err_msg=f)
        assert (got.tenant_starvation_rate >= want["tenant_starvation_rate"]).all()
    else:
        close += ("tenant_served_fraction", "tenant_final_backlog", "tenant_starvation_rate")
    fields = _fields(got)
    for f in exact:
        np.testing.assert_array_equal(fields[f], want[f], err_msg=f)
    for f in close:
        np.testing.assert_allclose(fields[f], want[f], rtol=RTOL, atol=1e-7, err_msg=f)


def test_run_campaign_through_a_fleet_mesh_matches_unsharded():
    kw = dict(scenario_names=("burse", "node_failure"), n_steps=256, chunk_size=100,
              device="cpu")
    platforms = [tctl.fpga_platform(ACCELERATORS[n]) for n in ("tabla", "stripes")]
    a = tscn.run_campaign(platforms, shard=shd.fleet_mesh(devices=["cpu", "cpu"]), **kw)
    b = tscn.run_campaign(platforms, shard=False, **kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert len(a["scenarios"]) == 2


def test_fleet_mesh_and_shard_fleet():
    if torch.cuda.device_count() < 2:
        assert shd.fleet_mesh() is None
        a = _run("aggregate", True)                   # shard=True on < 2 cards: unsharded
        b = _run("aggregate", False)
        assert all(np.array_equal(x, _fields(b)[f]) for f, x in _fields(a).items())
    mesh = shd.fleet_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"fleet": 2} and mesh.axis_names == ("fleet",)
    rules = shd.fleet_rules(mesh)
    tree = {"even": torch.arange(8.0).reshape(4, 2), "odd": torch.arange(3.0),
            "scalar": torch.tensor(5.0), "nt": tsched.make_tenants([1.0], [4.0], [1.0])}
    parts = shd.shard_fleet(tree, rules)
    assert len(parts) == 2
    assert torch.equal(parts[1]["even"], torch.tensor([[4.0, 5.0], [6.0, 7.0]]))
    assert all(torch.equal(p["odd"], tree["odd"]) for p in parts)     # 3 rows: replicated
    assert all(p["scalar"] is tree["scalar"] for p in parts)
    assert isinstance(parts[0]["nt"], tsched.TenantSpec)
    assert shd.shard_fleet(tree, shd.ShardingRules({"fleet": "fleet"})) is tree
    assert rules.resolve(("fleet", None), (3, 5)) == (None, None)
    assert rules.resolve(("fleet", None), (4, 5)) == ("fleet", None)


def test_shard_true_runs_on_one_device(monkeypatch):
    monkeypatch.setattr(shd, "fleet_mesh",
                        lambda *a, **k: pytest.fail("shard=True built a fleet mesh"))
    a, b = _run("aggregate", True), _run("aggregate", False)
    assert all(np.array_equal(x, _fields(b)[f]) for f, x in _fields(a).items())
