"""The port's scenario library and campaign runner against the JAX package's.

Every registered scenario's workload trace, tenant plane and node
schedule must be bit-equal (the same numpy draws in the same order), and
so must the stacked suites.  ``run_campaign`` on the CPU agrees with the
JAX package's cell by cell within 1e-5 relative (float32 sums in other
orders), with miss counts and Pareto fronts equal, both on the aggregate
path and on a three-tenant plane under the priority scheduler.
"""

import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core import scenarios as jscn
from repro.core import scheduler as jsched
from repro.core.accelerators import ACCELERATORS as JACC
from repro_torch.core import controller as tctl
from repro_torch.core import scenarios as tscn
from repro_torch.core import scheduler as tsched
from repro_torch.core.accelerators import ACCELERATORS as TACC

RTOL = 1e-5
MISS_KEYS = ("misprediction_rate", "margin_misprediction_rate")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BUILT_IN = sorted(jscn.SCENARIOS)


def test_the_same_library_is_registered():
    assert sorted(tscn.SCENARIOS) == BUILT_IN
    assert len(BUILT_IN) == 15   # ten synthetic, two replays, three compositions
    for name in BUILT_IN:
        t, j = tscn.get_scenario(name), jscn.get_scenario(name)
        assert (t.description, t.seed_name, t.n_tenants()) == \
            (j.description, j.seed_name, j.n_tenants()), name
    assert sorted(tscn.FAILURE_MODELS) == sorted(jscn.FAILURE_MODELS)


@pytest.mark.parametrize("name", BUILT_IN)
@pytest.mark.parametrize("seed", [0, 1])
def test_scenario_bit_equal(name, seed):
    t, j = tscn.get_scenario(name), jscn.get_scenario(name)
    np.testing.assert_array_equal(t.trace(512, seed), j.trace(512, seed))
    for n_nodes in (8, 6):
        a, b = t.node_schedule(512, n_nodes, seed), j.node_schedule(512, n_nodes, seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for width in (None, 4):
        (tp, ts), (jp, js) = t.tenant_plane(512, seed, width), j.tenant_plane(512, seed, width)
        np.testing.assert_array_equal(tp, jp)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_suites_bit_equal():
    names = ("burse", "flash_crowd", "multi_tenant", "rack_failure", "cloud_mix")
    for got, want in ((tscn.build_suite(names, 300, 8, 1), jscn.build_suite(names, 300, 8, 1)),
                      (tscn.build_suite(None, 64), jscn.build_suite(None, 64))):
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
    for width in (None, 5):
        got = tscn.build_tenant_suite(names, 300, 8, 2, width)
        want = jscn.build_tenant_suite(names, 300, 8, 2, width)
        assert got[0] == want[0]
        for a, b in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[3], want[3]):
            np.testing.assert_array_equal(a, np.asarray(b))
    for mod in (tscn, jscn):
        with pytest.raises(ValueError, match="cannot hold 'multi_tenant'"):
            mod.build_tenant_suite(names, 32, n_tenants=2)


def test_pad_tenants_and_as_config_match():
    spec = tsched.make_tenants([2.0, 1.0], [0.0, 16.0], [0.3, 0.7])
    jspec = jsched.make_tenants([2.0, 1.0], [0.0, 16.0], [0.3, 0.7])
    for width in (2, 3, 6):
        for a, b in zip(tsched.pad_tenants(spec, width), jsched.pad_tenants(jspec, width)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="cannot pad 2 tenants down to 1"):
            mod.pad_tenants(mod.make_tenants([1, 1], [0, 0], [1, 1]), 1)
        assert mod.as_config(None).name == "none"
        assert mod.as_config("priority").policy == "priority"
        with pytest.raises(TypeError, match="cannot use int as a scheduler"):
            mod.as_config(3)
    cfg = tsched.SchedulerConfig(name="x", enabled=True, migration_cost=0.5)
    assert tsched.as_config(cfg) is cfg


def test_pareto_front_matches():
    rng = np.random.default_rng(0)
    for trial in range(50):
        n = int(rng.integers(1, 7))
        cells = {f"t{i}": {"power_gain": float(rng.choice([1.0, 2.0, 3.0])),
                           "qos_violation_rate": float(rng.choice([0.0, 0.1, 0.5]))}
                 for i in range(n)}
        assert tscn.pareto_front(cells) == jscn.pareto_front(cells), cells


def test_registry_helpers_match():
    for mod in (tscn, jscn):
        with pytest.raises(KeyError, match="unknown scenario"):
            mod.get_scenario("nope")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_scenario(mod.get_scenario("burse"))
        with pytest.raises(KeyError, match="unknown failure model"):
            mod.with_failure_model("burse", "meteor")
    t = tscn.with_failure_model("diurnal", "cascade")
    j = jscn.with_failure_model("diurnal", "cascade")
    assert (t.name, t.description, t.seed_name) == (j.name, j.description, j.seed_name)
    np.testing.assert_array_equal(t.trace(256, 3), j.trace(256, 3))
    np.testing.assert_array_equal(t.node_schedule(256, 8, 3), j.node_schedule(256, 8, 3))
    np.testing.assert_array_equal(t.trace(256, 3), tscn.get_scenario("diurnal").trace(256, 3))
    src = tscn.traces.load_bundled("google_cluster")
    r = tscn.register_replay(src, name="replay_test_tau", tau_s=600.0, overwrite=True)
    rj = jscn.register_replay(jscn.traces.load_bundled("google_cluster"),
                              name="replay_test_tau", tau_s=600.0, overwrite=True)
    assert r.description == rj.description
    np.testing.assert_array_equal(r.trace(100, 1), rj.trace(100, 1))
    for mod in (tscn, jscn):
        del mod.SCENARIOS["replay_test_tau"], mod.SCENARIOS["diurnal+cascade"]


CAMPAIGN = dict(scenario_names=("burse", "node_failure", "cloud_mix"),
                techniques=("proposed", "power_gating", "hybrid", "headroom"),
                n_steps=256)


def _assert_campaigns_match(got, want):
    assert tuple(got["scenarios"]) == tuple(want["scenarios"])
    assert tuple(got["techniques"]) == tuple(want["techniques"])
    assert (got["n_steps"], got["scheduler"], got["tenants"]) == \
        (want["n_steps"], want["scheduler"], want["tenants"])
    assert got["pareto"] == want["pareto"]
    for plat, per_tech in want["table"].items():
        for tech, per_scen in per_tech.items():
            for scen, cell in per_scen.items():
                out = got["table"][plat][tech][scen]
                assert sorted(out) == sorted(cell)
                for key, ref in cell.items():
                    msg = f"{plat}/{tech}/{scen}: {key}"
                    if key in MISS_KEYS:
                        assert out[key] == ref, msg
                    else:
                        np.testing.assert_allclose(out[key], ref, rtol=RTOL, atol=0,
                                                   err_msg=msg)


@pytest.mark.parametrize("tenants", [None, 3])
def test_run_campaign_matches(tenants):
    names = ("tabla", "stripes")
    extra = {} if tenants is None else dict(tenants=tenants, scheduler="priority")
    want = jscn.run_campaign([jctl.fpga_platform(JACC[n]) for n in names],
                             **CAMPAIGN, **extra)
    got = tscn.run_campaign([tctl.fpga_platform(TACC[n]) for n in names],
                            **CAMPAIGN, **extra, device="cpu")
    _assert_campaigns_match(got, want)
    cell = got["table"]["fpga:tabla"]["headroom"]["node_failure"]
    assert cell["mean_avail_nodes"] < 8.0
    if tenants is not None:
        assert got["tenants"] == 3 and len(cell["tenant_qos_violation_rate"]) == 3


def test_run_campaign_validates_tenants():
    with pytest.raises(ValueError, match="tenants must be None"):
        tscn.run_campaign([tctl.fpga_platform(TACC["tabla"])], tenants=0, device="cpu")
