"""The port's §V fleet path against the JAX package's, on the CPU.

Tables (every technique, with the hybrid gear argmin and the closed
forms), the step loop under node failures and the headroom bump, the
scheduler slice, and the whole ``compare_all_batched`` at a small size
and at full Table II size.  Summary fields agree within 1e-5 relative
(float32 sums taken in other orders), miss counts and bins exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import pll as jpll
from repro.core import scheduler as jsched
from repro.core.accelerators import ACCELERATORS as JACC
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import pll as tpll
from repro_torch.core import scheduler as tsched
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC

RTOL = 1e-5
MISS_FIELDS = ("misprediction_rate", "margin_misprediction_rate")


def _platforms(names):
    return ([jctl.fpga_platform(JACC[n]) for n in names],
            [tctl.fpga_platform(TACC[n]) for n in names])


def _assert_summaries_match(ref, out):
    assert list(ref) == list(out)
    for plat in ref:
        assert list(ref[plat]) == list(out[plat])
        for tech, r in ref[plat].items():
            o = out[plat][tech]
            for f in dataclasses.fields(r):
                a, b = getattr(r, f.name), getattr(o, f.name)
                msg = f"{plat}/{tech}: {f.name}"
                if f.name == "technique":
                    assert a == b, msg
                elif f.name in MISS_FIELDS:
                    assert a == b, msg
                else:
                    np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=msg)


def test_compare_all_batched_small_fleet():
    """2 accelerators × 6 techniques × 256 steps."""
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=256, seed=3))
    jp, tp = _platforms(["tabla", "stripes"])
    ref = jctl.compare_all_batched(jp, trace)
    out = tctl.compare_all_batched(tp, trace, device="cpu")
    _assert_summaries_match(ref, out)


def test_compare_all_batched_table2_full_size():
    """The paper's experiment: 5 accelerators × 6 techniques, 8 nodes,
    25 bins, 1024 steps of the seed-0 BURSE-like trace."""
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=1024, seed=0))
    jp, tp = _platforms(sorted(JACC))
    ref = jctl.compare_all_batched(jp, trace)
    out = tctl.compare_all_batched(tp, trace, device="cpu")
    _assert_summaries_match(ref, out)
    gains = [out[p.name]["proposed"].power_gain for p in tp]
    assert np.mean(gains) > 3.0  # Table II: DVFS on both rails wins


CONFIGS = {
    "failures_headroom": dict(gated_power_frac=0.05, headroom_frac=0.25),
    "oracle_single_pll": dict(use_oracle=True, gated_power_frac=0.1,
                              n_nodes=6, n_bins=12, margin=0.1),
}


def _cfgs(name):
    """The same ControllerConfig in both packages (a single slow-locking
    PLL for the oracle case, so the stall term is live)."""
    jcfg, tcfg = jctl.ControllerConfig(**CONFIGS[name]), \
        tctl.ControllerConfig(**CONFIGS[name])
    if name == "oracle_single_pll":
        jcfg = dataclasses.replace(jcfg, pll=jpll.PllConfig(dual=False, t_lock=0.05))
        tcfg = dataclasses.replace(tcfg, pll=tpll.PllConfig(dual=False, t_lock=0.05))
    return jcfg, tcfg


def _stacked(jp, tp):
    return (jchar.stack_platform_params([p.params for p in jp]),
            tchar.stack_platform_params([p.params for p in tp]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fleet_bin_tables_match(name):
    jcfg, tcfg = _cfgs(name)
    jparams, tparams = _stacked(*_platforms(["dnnweaver", "proteus"]))
    ref = jctl.fleet_bin_tables(jparams, jcfg, jctl.TECHNIQUES)
    out = tctl.fleet_bin_tables(tparams, tcfg, tctl.TECHNIQUES, device="cpu")
    assert tctl.TECHNIQUES == jctl.TECHNIQUES
    assert tctl.DEFAULT_TECHNIQUES == jctl.DEFAULT_TECHNIQUES
    for f in jctl.BinTables._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert a.shape == b.shape, f
        if f in ("v_core", "v_bram", "f_rel", "n_active", "capacity"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6, err_msg=f)


def _avail_schedule(n_steps, n_nodes, seed):
    """Per-cell usable nodes with outages of random depth and length."""
    rng = np.random.default_rng(seed)
    avail = np.full((2, 1, n_steps), float(n_nodes), np.float32)
    for cell in range(2):
        for start in rng.integers(40, n_steps - 20, 4):
            avail[cell, 0, start:start + rng.integers(5, 20)] = rng.integers(1, n_nodes)
    return avail


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulate_fleet_step_fields_match(name):
    """Every per-step field of the loop, with node failures on a headroom
    fleet (and the oracle with a single PLL)."""
    jcfg, tcfg = _cfgs(name)
    techs = ("proposed", "hybrid", "headroom", "power_gating", "nominal")
    jparams, tparams = _stacked(*_platforms(["tabla", "diannao"]))
    jt = jctl.fleet_bin_tables(jparams, jcfg, techs)
    tt = tctl.fleet_bin_tables(tparams, tcfg, techs, device="cpu")
    n_steps = 200
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=n_steps, seed=5))
    traces = np.stack([trace, trace[::-1].copy()])[:, None, :]   # [P, 1, S]
    avail = _avail_schedule(n_steps, jcfg.n_nodes, seed=1)
    ref = jctl.simulate_fleet(jt, traces, jcfg, avail=avail)
    out = tctl.simulate_fleet(tt, traces, tcfg, avail=avail, device="cpu")
    for f in ("predicted_bin", "actual_bin", "n_active", "violations",
              "v_core", "v_bram", "f_rel", "mispredictions", "margin_misses"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("power", "capacity", "backlog"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=RTOL, atol=1e-6, err_msg=f)
    # the failures bit: fewer usable nodes than the table asked for
    assert (out.n_active.numpy() < tt.n_active.numpy().max()).any()


def _tenant_inputs(seed, k=16, t=4):
    rng = np.random.default_rng(seed)
    spec = jsched.make_tenants(rng.integers(0, 3, t).astype(float),
                               rng.integers(0, 4, t).astype(float),
                               rng.uniform(0.1, 1.0, t))
    active = np.ones(t, np.float32)
    active[-1] = 0.0                        # one padding slot
    spec = spec._replace(active=active)
    d = rng.uniform(0.0, 0.4, (k, t)).astype(np.float32)
    cap = rng.uniform(0.0, 1.2, k).astype(np.float32)
    n_act = rng.integers(1, 9, k).astype(np.float32)
    place = rng.uniform(0.0, 3.0, (k, t)).astype(np.float32)
    bins = rng.integers(0, 25, k)
    power_tab = np.sort(rng.uniform(10, 200, (k, 25)), -1).astype(np.float32)
    cap_tab = np.sort(rng.uniform(0.05, 1.0, (k, 25)), -1).astype(np.float32)
    return spec, d, cap, n_act, place, bins, power_tab, cap_tab


@pytest.mark.parametrize("sched_name", ["none", "priority", "fair_share"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_slice_matches(sched_name, seed):
    spec, d, cap, n_act, place, bins, power_tab, cap_tab = _tenant_inputs(seed)
    jspec = jsched.TenantSpec(*[jnp.asarray(x) for x in spec])
    tspec = tsched.TenantSpec(*spec).to("cpu")
    jvals = jsched.scheduler_values(jsched.get(sched_name))
    tvals = tsched.scheduler_values(tsched.get(sched_name), "cpu")
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))

    ref = jax.vmap(jsched.schedule_step, in_axes=(None, None, 0, 0, 0, 0))(
        jspec, jvals, d, cap, n_act, place)
    out = tsched.schedule_step(tspec, tvals, *map(torch.from_numpy, (d, cap, n_act, place)))
    for f in jsched.SchedStep._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6, err_msg=f)

    backlog = d * 0.5
    pb = jax.vmap(jsched.provision_bin, in_axes=(None, 0, 0, None))(
        jspec, jnp.asarray(bins, jnp.int32), backlog, 25)
    np.testing.assert_array_equal(
        tsched.provision_bin(tspec, torch.from_numpy(bins), torch.from_numpy(backlog),
                             25).numpy(), np.asarray(pb))
    ob = jax.vmap(jsched.opportunistic_bin)(power_tab, cap_tab, pb, backlog.sum(-1))
    np.testing.assert_array_equal(
        tsched.opportunistic_bin(torch.from_numpy(power_tab), torch.from_numpy(cap_tab),
                                 torch.from_numpy(np.array(pb)).long(),
                                 torch.from_numpy(backlog.sum(-1))).numpy(),
        np.asarray(ob))


def test_scheduler_off_reduces_to_aggregate_bit_for_bit():
    """One default tenant, scheduler off: served = min(cap, d) exactly."""
    rng = np.random.default_rng(2)
    d = torch.from_numpy(rng.uniform(0.0, 1.5, (64, 1)).astype(np.float32))
    cap = torch.from_numpy(rng.uniform(0.0, 1.0, 64).astype(np.float32))
    spec = tsched.default_tenants(1).to("cpu")
    out = tsched.schedule_step(spec, tsched.scheduler_values(tsched.get("none"), "cpu"),
                               d, cap, torch.full((64,), 8.0), torch.zeros(64, 1))
    served = torch.minimum(cap, d[:, 0])
    assert torch.equal(out.served[:, 0], served)
    assert torch.equal(out.backlog[:, 0], d[:, 0] - served)
    assert torch.equal(out.place, torch.zeros(64, 1))


@pytest.mark.parametrize("bad", [
    dict(technique="turbo"), dict(margin=0.04), dict(n_bins=10, margin=0.1),
    dict(headroom_frac=1.0), dict(headroom_frac=0.9, n_nodes=8),
    dict(scheduler="lottery"), dict(predictor="oracle"),
])
def test_controller_config_validation_matches(bad):
    with pytest.raises((ValueError, KeyError, TypeError)):
        jctl.ControllerConfig(**bad)
    with pytest.raises((ValueError, KeyError, TypeError)):
        tctl.ControllerConfig(**bad)


def test_controller_config_syncs_predictors():
    jcfg, tcfg = jctl.ControllerConfig(n_bins=20, margin=0.12, n_nodes=6), \
        tctl.ControllerConfig(n_bins=20, margin=0.12, n_nodes=6)
    for a, b in ((jcfg.predictor, tcfg.predictor),
                 (jcfg.avail_predictor, tcfg.avail_predictor)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tctl.pll_standing_watts(tcfg) == jctl.pll_standing_watts(jcfg)
    gj, fj, okj = jctl._hybrid_gears(jcfg)
    gt, ft, okt = tctl._hybrid_gears(tcfg)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_fleet_nominal_watts_match():
    jparams, tparams = _stacked(*_platforms(sorted(JACC)))
    a = jctl.fleet_nominal_watts(jparams, jctl.ControllerConfig())
    b = tctl.fleet_nominal_watts(tparams, tctl.ControllerConfig())
    np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6)


def test_traces_must_match_table_axes():
    _, tp = _platforms(["tabla", "stripes"])
    cfg = tctl.ControllerConfig()
    tables = tctl.fleet_bin_tables(tchar.stack_platform_params([p.params for p in tp]),
                                   cfg, ("proposed", "core_only"), device="cpu")
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=40, seed=0))
    with pytest.raises(ValueError, match="leading axes"):
        tctl.simulate_fleet(tables, np.stack([trace, trace]), cfg, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        tctl.compare_all_batched([tp[0], tp[0]], trace, device="cpu")
    res = tctl.simulate_fleet(tables, trace, cfg, device="cpu")
    assert res.power.shape == (2, 2, 40)
