"""The port's fleet-composition search against the JAX package's.

``search_fleet_composition`` on the CPU at 8 to 12 candidates and 256
steps: every per-candidate array within 1e-5 relative of the JAX search
(float32 step sums in other orders), Pareto sets and rejections equal,
nothing second-half built, loaded or launched.  Candidates with a zero
count for a platform give sub-fleets with no nodes; they must stay finite
and weigh nothing.  An odd batch repeats its last candidate and drops
it.  Then the three ``composition/*`` rows of ``BENCH_fleet.json`` as
``benchmarks/run.py`` builds them (48 candidates, 1024 steps).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import composition as jcomp
from repro.core import controller as jctl
from repro.core.accelerators import ACCELERATORS as JACC
from repro_torch.core import composition as tcomp
from repro_torch.core import controller as tctl
from repro_torch.core.accelerators import ACCELERATORS as TACC
from repro_torch.kernels import _build
from repro_torch.kernels.grid_argmin import grid_argmin

RTOL = 1e-5
STEPS, CHUNK = 256, 96
BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_fleet.json")
ARRAYS = ("candidates", "cost", "nominal_power_w", "total_power_w",
          "qos_violation_rate", "served_fraction")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plats(pkg, names):
    ctl, acc = (jctl, JACC) if pkg == "jax" else (tctl, TACC)
    return [ctl.fpga_platform(acc[n]) for n in names]


def _both(names, cand, scenarios, budget=None, **kw):
    jb = None if budget is None else jcomp.CompositionBudget(**budget)
    tb = None if budget is None else tcomp.CompositionBudget(**budget)
    want = jcomp.search_fleet_composition(_plats("jax", names), cand, scenarios, jb, **kw)
    got = tcomp.search_fleet_composition(_plats("torch", names), cand, scenarios, tb,
                                         device="cpu", **kw)
    return got, want


def _assert_same(got, want):
    assert got.platform_names == want.platform_names
    assert got.scenario_names == want.scenario_names
    for f in ARRAYS:
        x, y = getattr(got, f), np.asarray(getattr(want, f))
        assert x.shape == y.shape and x.dtype == y.dtype, f
        assert np.isfinite(x).all(), f
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-12, err_msg=f)
    assert {k: v.tolist() for k, v in got.pareto.items()} == \
        {k: v.tolist() for k, v in want.pareto.items()}
    assert got.n_rejected == want.n_rejected
    assert got.retraces_second_half == 0


SEARCHES = {
    # 4 × 3 lattice minus the empty fleet: counts of zero on either side
    "lattice_zero_counts": (("tabla", "stripes"), dict(lattice=(2, 3, 12)),
                            ("burse", "node_failure"), None, {}),
    # 9 sampled candidates: an odd batch, padded then trimmed
    "odd_batch_three_platforms": (("tabla", "stripes", "diannao"),
                                  dict(lattice=(3, 4, 9)), ("diurnal",), None,
                                  dict(technique="core_only")),
    # a cost budget rejects some; throughputs and costs per platform
    "budget_gates": (("dnnweaver", "proteus"), dict(lattice=(2, 5, 10)),
                     ("flash_crowd", "burse"),
                     dict(max_cost=9.0, max_power_w=140.0, reference_nodes=6.0),
                     dict(node_cost=(1.0, 1.5), node_throughput=(1.0, 0.8))),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_matches_jax(name):
    names, cand_kw, scenarios, budget, kw = SEARCHES[name]
    n_plat, max_nodes, n_cand = cand_kw["lattice"]
    cand = tcomp.enumerate_candidates(n_plat, max_nodes, n_cand, seed=3)
    np.testing.assert_array_equal(cand, jcomp.enumerate_candidates(n_plat, max_nodes,
                                                                   n_cand, seed=3))
    assert 8 <= len(cand) <= 12
    got, want = _both(names, cand, scenarios, budget, n_steps=STEPS,
                      chunk_size=CHUNK, **kw)
    _assert_same(got, want)
    if name == "lattice_zero_counts":
        assert (cand == 0).any()
    if name == "budget_gates":
        assert 0 < got.n_rejected < len(cand)


def test_zero_count_sub_fleets_weigh_nothing():
    """A candidate with no stripes nodes scores as its tabla sub-fleet
    alone: the empty sub-fleet draws no power and its QoS rate, though
    finite, has weight 0."""
    cand = np.array([[3, 0], [3, 2]])
    got = tcomp.search_fleet_composition(_plats("torch", ("tabla", "stripes")), cand,
                                         ("burse",), n_steps=128, chunk_size=64,
                                         device="cpu")
    alone = tcomp.search_fleet_composition(_plats("torch", ("tabla",)), cand[:1, :1],
                                           ("burse",), n_steps=128, chunk_size=64,
                                           device="cpu")
    for f in ("total_power_w", "qos_violation_rate", "served_fraction"):
        assert np.isfinite(getattr(got, f)).all()
        np.testing.assert_allclose(getattr(got, f)[0], getattr(alone, f)[0], rtol=1e-6)


def test_odd_batch_drops_its_padding():
    cand = tcomp.enumerate_candidates(2, 2, 64)[:5]
    got = tcomp.search_fleet_composition(_plats("torch", ("tabla", "stripes")), cand,
                                         ("diurnal",), n_steps=64, chunk_size=32,
                                         device="cpu")
    assert got.candidates.shape == (5, 2)
    assert got.total_power_w.shape == got.qos_violation_rate.shape == (5, 1)
    np.testing.assert_array_equal(got.candidates, cand)


def test_one_table_build_and_nothing_in_the_second_half(monkeypatch):
    """One table build; the second half builds, loads and launches no
    kernel.  On the CPU the op runs its plain version, so the witness is
    held with a counter the table build is made to bump."""
    calls = []
    real = tctl.fleet_bin_tables
    monkeypatch.setattr(grid_argmin, "launches", 0)

    def counted(*a, **k):
        calls.append(1)
        grid_argmin.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(tctl, "fleet_bin_tables", counted)
    res = tcomp.search_fleet_composition(
        _plats("torch", ("tabla", "stripes")), tcomp.enumerate_candidates(2, 2, 8),
        ("burse",), n_steps=32, chunk_size=32, device="cpu")
    assert len(calls) == 1
    assert res.retraces_second_half == 0
    assert _build.loaded() == ()


@pytest.mark.parametrize("bad, message", [
    (dict(technique="hybrid"), "not composition-safe"),
    (dict(technique="power_gating"), "not composition-safe"),
    (dict(candidates=np.array([[1, 2, 3]])), r"candidates must be \[N, 2\]"),
    (dict(candidates=np.array([[0, 0], [1, 0]])), "at least one node"),
    (dict(budget=tcomp.CompositionBudget(max_cost=0.5)), "no candidate passed"),
])
def test_errors_match_jax(bad, message):
    kw = dict(candidates=np.array([[1, 1], [2, 0]]), budget=None, technique="proposed")
    kw.update(bad)
    jbudget = (None if kw["budget"] is None
               else jcomp.CompositionBudget(**vars(kw["budget"])))
    with pytest.raises(ValueError, match=message):
        jcomp.search_fleet_composition(_plats("jax", ("tabla", "stripes")), kw["candidates"],
                                       ("burse",), jbudget, technique=kw["technique"],
                                       n_steps=16)
    with pytest.raises(ValueError, match=message):
        tcomp.search_fleet_composition(_plats("torch", ("tabla", "stripes")),
                                       kw["candidates"], ("burse",), kw["budget"],
                                       technique=kw["technique"], n_steps=16, device="cpu")


def test_pareto_front_and_sampling_match_jax():
    rng = np.random.default_rng(0)
    obj = np.round(rng.uniform(0, 4, (40, 3)))
    np.testing.assert_array_equal(tcomp.pareto_front(obj), jcomp.pareto_front(obj))
    np.testing.assert_array_equal(tcomp.enumerate_candidates(3, 8, 50, seed=1),
                                  jcomp.enumerate_candidates(3, 8, 50, seed=1))
    assert tcomp.COMPOSABLE_TECHNIQUES == jcomp.COMPOSABLE_TECHNIQUES


def test_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcomp.search_fleet_composition(_plats("torch", ("tabla",)), np.array([[1]]),
                                       ("burse",), n_steps=8)


def test_composition_rows_match_bench():
    """``composition/sweep`` and both ``composition/knee/*`` rows: counts,
    Pareto sizes and knee mixes equal, power within 0.06 W (one printed
    decimal), QoS rates within 2/S."""
    with open(BENCH) as fh:
        bench = {k: v["derived"] for k, v in json.load(fh)["benches"].items()
                 if k.startswith("composition/")}
    scenarios = ("burse", "diurnal")
    cand = tcomp.enumerate_candidates(2, 6, 48)
    res = tcomp.search_fleet_composition(_plats("torch", ("tabla", "stripes")), cand,
                                         scenarios, n_steps=1024, chunk_size=512,
                                         device="cpu")
    pareto = ";".join(f"pareto_{s}={len(res.pareto[s])}" for s in scenarios)
    assert bench["composition/sweep"] == (f"cands={cand.shape[0]};{pareto}"
                                          f";retraces={res.retraces_second_half}")
    for i, s in enumerate(scenarios):
        idx = res.pareto[s]
        ok = [j for j in idx if res.qos_violation_rate[j, i] <= 0.25]
        j = ok[0] if ok else min(idx, key=lambda j: res.qos_violation_rate[j, i])
        want = dict(item.split("=") for item in bench[f"composition/knee/{s}"].split(";"))
        assert want["mix"] == "x".join(str(int(v)) for v in res.candidates[j])
        assert abs(res.total_power_w[j, i] - float(want["power_w"])) <= 0.06
        assert abs(res.qos_violation_rate[j, i] - float(want["qos_viol"])) <= 2 / 1024
    assert len(bench) == 3
