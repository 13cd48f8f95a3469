"""The port's streaming fleet engine, on the CPU.

``simulate_fleet_stream`` against the port's own ``simulate_fleet`` (the
same ``_control_step``): reductions within 1e-5 relative (float32 sums
per chunk, float64 across chunks, against one float32 mean), miss counts
and emitted per-step fields exactly, at chunk sizes 1, 7, 64 and S; with
an availability schedule, headroom cells and tenant planes; the
broadcast helpers' errors; and against the JAX package's
``simulate_fleet_stream`` on one shared input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import scheduler as jsched
from repro.core.accelerators import ACCELERATORS as JACC
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import scheduler as tsched
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC

RTOL = 1e-5
S = 200
TECHS = ("proposed", "power_gating", "hybrid", "headroom")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every new port test file pins (ROADMAP C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet(cfg, techniques=TECHS):
    params = tchar.stack_platform_params(
        [tctl.fpga_platform(TACC[n]).params for n in ("tabla", "stripes")])
    return tctl.fleet_bin_tables(params, cfg, techniques, device="cpu")   # [2, T, M]


def _inputs():
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=S, seed=1))
    # per-platform availability: platform 0 loses nodes in windows, platform 1 healthy
    avail = np.stack([np.where(np.arange(S) % 50 < 12, 5.0, 8.0),
                      np.full(S, 8.0)]).astype(np.float32)[:, None]       # [2, 1, S]
    return trace, avail


@pytest.mark.parametrize("chunk", [1, 7, 64, S])
@pytest.mark.parametrize("with_avail", [False, True])
def test_stream_matches_materialized(chunk, with_avail):
    cfg = tctl.ControllerConfig(gated_power_frac=0.05)
    tables = _fleet(cfg)
    trace, avail = _inputs()
    avail = avail if with_avail else None
    ref = tctl.simulate_fleet(tables, trace, cfg, avail=avail, device="cpu")
    emit = tctl._EMITTABLE[:3] + ("violations",) + tctl._EMITTABLE[3:]
    emit = tuple(e for e in emit if e != "violation")
    out = tctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=chunk, emit=emit,
                                     avail=avail, device="cpu")
    assert out.n_steps == S and out.mean_power_w.shape == (2, len(TECHS))
    np.testing.assert_allclose(out.mean_power_w, ref.power.mean(-1).numpy(), rtol=RTOL)
    np.testing.assert_allclose(out.mean_backlog, ref.backlog.mean(-1).numpy(),
                               rtol=RTOL, atol=1e-9)
    np.testing.assert_array_equal(out.qos_violation_rate,
                                  ref.violations.double().mean(-1).numpy())
    np.testing.assert_array_equal(out.mispredictions, ref.mispredictions.numpy())
    np.testing.assert_array_equal(out.margin_misses, ref.margin_misses.numpy())
    np.testing.assert_array_equal(out.final_backlog, ref.backlog[..., -1].numpy())
    offered = float(np.sum(trace.astype(np.float32), dtype=np.float64))
    np.testing.assert_allclose(out.offered, offered, rtol=RTOL)
    np.testing.assert_allclose(out.served_fraction,
                               (offered - ref.backlog[..., -1].numpy()) / offered, rtol=RTOL)
    want_avail = 8.0 if avail is None else avail.astype(np.float64).mean(-1)
    np.testing.assert_allclose(out.mean_avail_nodes, np.broadcast_to(want_avail, (2, 4)),
                               rtol=1e-12)
    for e in emit:
        field = "violations" if e == "violations" else e
        np.testing.assert_array_equal(out.emitted[e], getattr(ref, field).numpy(), err_msg=e)
    np.testing.assert_array_equal(out.final_predictor.inner.counts,
                                  ref.final_predictor.inner.counts.numpy())
    # aggregate runs report one default tenant: its sums are the aggregate's
    np.testing.assert_array_equal(out.tenant_qos_violation_rate[..., 0],
                                  out.qos_violation_rate)
    np.testing.assert_array_equal(out.tenant_final_backlog[..., 0], out.final_backlog)


def test_stream_copies_one_chunk_at_a_time(monkeypatch):
    """Only [K, C] (here [K, C, 1]) arrays reach the device, never K·S;
    the tail chunk is zero-padded to C (one program for every chunk, as
    the JAX package pads it)."""
    cfg = tctl.ControllerConfig()
    tables = _fleet(cfg)
    trace, avail = _inputs()
    shapes = []
    real = torch.from_numpy

    def spy(x):
        shapes.append(x.shape)
        return real(x)

    monkeypatch.setattr(torch, "from_numpy", spy)
    tctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=64, avail=avail, device="cpu")
    k = 2 * len(TECHS)
    assert shapes == [(k, 64, 1), (k, 64)] * 4


def test_tenant_plane_of_one_default_tenant_is_the_aggregate_run():
    """A [S, 1] plane of one default tenant with the scheduler off is the
    aggregate run bit for bit, per-step fields and reductions."""
    cfg = tctl.ControllerConfig(scheduler="none")
    tables = _fleet(cfg)
    trace, avail = _inputs()
    agg = tctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=64, avail=avail,
                                     emit=("power", "backlog"), device="cpu")
    one = tctl.simulate_fleet_stream(tables, trace[:, None], cfg, chunk_size=64,
                                     avail=avail, emit=("power", "backlog"),
                                     tenant_spec=tsched.default_tenants(1), device="cpu")
    for f in ("mean_power_w", "qos_violation_rate", "served_fraction", "mean_backlog",
              "offered", "mispredictions", "tenant_qos_violation_rate",
              "tenant_final_backlog"):
        np.testing.assert_array_equal(getattr(one, f), getattr(agg, f), err_msg=f)
    for e in ("power", "backlog"):
        np.testing.assert_array_equal(one.emitted[e], agg.emitted[e], err_msg=e)


def _three_tenants():
    rng = np.random.default_rng(3)
    plane = rng.uniform(0.0, 0.45, (S, 3)).astype(np.float32)
    plane[S // 2:S // 2 + 20, 2] = 0.0           # tenant 2 idles a while
    spec = ([2.0, 1.0, 0.0], [1.0, 8.0, 64.0], [0.5, 0.3, 0.2])
    return plane, spec


#: Per-step fields the tenant comparison reads from both step loops.
STEP_FIELDS = ("predicted_bin", "capacity", "violation", "power", "tenant_served",
               "tenant_backlog", "tenant_violation", "tenant_starved")


def _tenant_steps(jtables, ttables, plane, avail, jspec, tspec, jcfg, tcfg, sched_name):
    """Every cell's per-step fields from both packages' chunk loops, one
    chunk of all S steps: the JAX package's compiled chunk scan and the
    port's stream program (``_StreamProgram``); ``[K, S]`` (tenant fields
    ``[K, T, S]``)."""
    from repro.core import predictors as jpred
    from repro_torch.core import predictors as tpred

    lead = jtables.capacity.shape[:-1]
    k, t = int(np.prod(lead)), plane.shape[-1]
    jflat = jctl.BinTables(*[np.reshape(np.asarray(x), (k,) + x.shape[len(lead):])
                             for x in jtables])
    tflat = tctl.BinTables(*[x.reshape((k,) + x.shape[len(lead):]) for x in ttables])
    rcfg = jctl._runtime_cfg(jcfg)
    jstate = [jax.tree.map(lambda x: np.broadcast_to(x, (k,) + x.shape),
                           jpred.init_state(c)) for c in (rcfg.predictor, rcfg.avail_predictor)]
    chunk = np.broadcast_to(plane, (k,) + plane.shape)
    av = np.ascontiguousarray(np.broadcast_to(avail, lead + avail.shape[-1:])).reshape(k, -1)
    _, ys = jctl._fleet_stream_chunk_jit(
        jflat, *jstate, np.zeros((k, t), np.float32), np.zeros((k, t), np.float32), chunk, av,
        np.ones(plane.shape[0], bool), jctl._flatten_tenant_spec(jspec, lead, k, k),
        jsched.scheduler_values(jsched.get(sched_name)), rcfg, STEP_FIELDS)
    zk, zt = torch.zeros(k), torch.zeros((k, t))
    acc = tctl._StreamAcc(tpred.init_state(tcfg.predictor, k, "cpu"),
                          tpred.init_state(tcfg.avail_predictor, k, "cpu"), zt, zt,
                          zk, zk, zk, zk, zk, zt, zt, zt, zt)
    ins = (tflat, acc, torch.tensor(chunk), torch.tensor(av))
    spec_sched = (tctl._flatten_tenant_spec(tspec, lead, k, "cpu"),
                  tsched.scheduler_values(tsched.get(sched_name)))
    prog = tctl._StreamProgram(tctl._runtime_cfg(tcfg), STEP_FIELDS, *ins, *spec_sched)
    _, port = prog(*ins, np.ones(plane.shape[0], bool), *spec_sched)
    ref = {f: np.moveaxis(np.asarray(y), 1, -1) for f, y in zip(STEP_FIELDS, ys)}
    return ref, {f: y.numpy() for f, y in port.items()}


@pytest.mark.parametrize("n_tenants", [1, 3])
@pytest.mark.parametrize("sched_name", ["priority", "fair_share"])
def test_tenant_plane_matches_jax(n_tenants, sched_name):
    """The same tenant plane, spec and availability through both packages'
    streaming engines.  Every aggregate reduction within 1e-5 relative,
    misses and every bin and QoS flag of every step equal.

    One divergence is bounded, not hidden (ROADMAP C): inside its compiled
    chunk scan the JAX package serves a tenant residues of 2e-9 to 1.2e-8
    work where its own step, run op by op or compiled alone, and the port
    serve exactly 0; ``starved`` tests ``served <= 1e-9``, so the flag
    differs at those steps only.  The residues carry into the tenants'
    backlog at ≤ 1e-5 absolute."""
    plane, (prio, lat, share) = _three_tenants()
    if n_tenants == 1:
        plane, prio, lat, share = plane.sum(-1, keepdims=True), [1.0], [4.0], [1.0]
    _, avail = _inputs()
    kw = dict(gated_power_frac=0.05, scheduler=sched_name)
    jcfg, tcfg = jctl.ControllerConfig(**kw), tctl.ControllerConfig(**kw)
    names = ("tabla", "stripes")
    jparams = jchar.stack_platform_params([jctl.fpga_platform(JACC[n]).params for n in names])
    jtables, ttables = jctl.fleet_bin_tables(jparams, jcfg, TECHS), _fleet(tcfg)
    jspec, tspec = jsched.make_tenants(prio, lat, share), tsched.make_tenants(prio, lat, share)
    want = jctl.simulate_fleet_stream(jtables, plane, jcfg, chunk_size=64, avail=avail,
                                      tenant_spec=jspec, emit=("power", "n_active"))
    got = tctl.simulate_fleet_stream(ttables, plane, tcfg, chunk_size=64, avail=avail,
                                     tenant_spec=tspec, emit=("power", "n_active"),
                                     device="cpu")
    _assert_stream_matches(got, want, tenant_atol=1e-5)
    assert got.tenant_qos_violation_rate.shape == (2, len(TECHS), n_tenants)

    ref, out = _tenant_steps(jtables, ttables, plane, avail, jspec, tspec, jcfg, tcfg,
                             sched_name)
    for f in ("predicted_bin", "capacity", "violation", "tenant_violation"):
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    np.testing.assert_allclose(out["power"], ref["power"], rtol=RTOL, err_msg="power")
    for f in ("tenant_served", "tenant_backlog"):
        np.testing.assert_allclose(out[f], ref[f], rtol=0, atol=1e-5, err_msg=f)
    flips = out["tenant_starved"] != ref["tenant_starved"]
    assert (out["tenant_served"][flips] == 0).all()
    assert ((ref["tenant_served"][flips] > 1e-9) & (ref["tenant_served"][flips] < 2e-8)).all()
    # the summaries' starvation rates are exactly these flags' means
    np.testing.assert_array_equal(
        got.tenant_starvation_rate, out["tenant_starved"].mean(-1).reshape(got.offered.shape
                                                                           + (n_tenants,)))
    np.testing.assert_array_equal(
        np.asarray(want.tenant_starvation_rate),
        ref["tenant_starved"].mean(-1).reshape(got.offered.shape + (n_tenants,)))


def test_provision_bin_rounds_as_compiled_jax():
    """At an integer bin edge the last bit of ``w_hat = (bin + 1) / M``
    decides the shaped bin.  XLA compiles ``/ 25`` as ``* 0.04f``; the port
    does the same (``scheduler.div_static``), so it follows the JAX
    package's compiled programs, not its op-by-op run (ROADMAP C)."""
    spec = ([1.0, 1.0], [0.0, 0.0], [0.6, 0.4])
    bins = np.array([9, 4, 14, 19], np.int32)      # (b + 1)·0.6 + (b + 1)·0.4 = b + 1 exactly
    backlog = np.zeros((4, 2), np.float32)
    jspec = jsched.TenantSpec(*map(jnp.asarray, jsched.make_tenants(*spec)))

    def provision(b, bl):
        return jsched.provision_bin(jspec, b, bl, 25)

    compiled = np.asarray(jax.jit(jax.vmap(provision))(bins, backlog))
    eager = np.asarray(jax.vmap(provision)(bins, backlog))
    got = tsched.provision_bin(tsched.make_tenants(*spec).to("cpu"), torch.from_numpy(bins),
                               torch.from_numpy(backlog), 25).numpy()
    np.testing.assert_array_equal(got, compiled)
    assert (eager != compiled).any()     # the edge case this test is about


def test_aggregate_stream_matches_jax():
    cfg_kw = dict(gated_power_frac=0.05, headroom_frac=0.25)
    jcfg, tcfg = jctl.ControllerConfig(**cfg_kw), tctl.ControllerConfig(**cfg_kw)
    trace, avail = _inputs()
    names = ("tabla", "stripes")
    jparams = jchar.stack_platform_params([jctl.fpga_platform(JACC[n]).params for n in names])
    want = jctl.simulate_fleet_stream(jctl.fleet_bin_tables(jparams, jcfg, TECHS), trace,
                                      jcfg, chunk_size=48, avail=avail,
                                      emit=("power", "violations", "f_rel"))
    got = tctl.simulate_fleet_stream(_fleet(tcfg), trace, tcfg, chunk_size=48, avail=avail,
                                     emit=("power", "violations", "f_rel"), device="cpu")
    _assert_stream_matches(got, want)


def _assert_stream_matches(got, want, tenant_atol=None):
    """Reductions within 1e-5 relative, misses and emitted fields; with
    ``tenant_atol`` the per-tenant served work and backlog within that
    absolute bound and starvation left to the caller."""
    assert got.n_steps == want.n_steps
    fields = ["mean_power_w", "qos_violation_rate", "served_fraction", "mean_backlog",
              "final_backlog", "offered", "mean_avail_nodes", "tenant_qos_violation_rate"]
    tenant = ["tenant_served_fraction", "tenant_final_backlog"]
    if tenant_atol is None:
        fields += tenant + ["tenant_starvation_rate"]
    for f in fields:
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=1e-7, err_msg=f)
    if tenant_atol is not None:
        for f in tenant:
            np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                       rtol=0, atol=tenant_atol, err_msg=f)
    for f in ("mispredictions", "margin_misses"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    assert sorted(got.emitted) == sorted(want.emitted)
    for e, ref in want.emitted.items():
        np.testing.assert_allclose(got.emitted[e], np.asarray(ref), rtol=RTOL, err_msg=e)


def test_broadcast_helpers_raise_as_jax_does():
    lead = (2, 3)
    bad_planes = [np.zeros((5,)), np.zeros((5, 2)), np.zeros((3, 5, 3)), np.zeros((2, 2, 5, 3))]
    for plane in bad_planes:
        with pytest.raises(ValueError) as te:
            tctl._broadcast_tenant_traces(plane, lead, 3)
        with pytest.raises(ValueError) as je:
            jctl._broadcast_tenant_traces(plane, lead, 3)
        assert str(te.value) == str(je.value)
    for shared in (np.zeros((5, 3)), np.zeros((2, 1, 5, 3))):
        a = tctl._broadcast_tenant_traces(shared, lead, 3)
        assert a.shape == (2, 3, 5, 3) and 0 in a.strides      # a stride-0 view
    spec = jsched.make_tenants([1, 2, 3], [0, 1, 2], [1, 1, 1])
    bad_specs = [spec._replace(latency_target=np.float32(1.0)),
                 spec._replace(share=np.zeros(2, np.float32)),
                 spec._replace(active=np.ones((3, 3), np.float32))]
    for s in bad_specs:
        with pytest.raises(ValueError) as te:
            tctl._flatten_tenant_spec(tsched.TenantSpec(*s), lead, 6, "cpu")
        with pytest.raises(ValueError) as je:
            jctl._flatten_tenant_spec(s, lead, 6, 6)
        assert str(te.value) == str(je.value)
    per_cell = spec._replace(priority=np.arange(6, dtype=np.float32).reshape(2, 1, 3))
    flat = tctl._flatten_tenant_spec(tsched.TenantSpec(*per_cell), lead, 6, "cpu")
    np.testing.assert_array_equal(
        flat.priority.numpy(), np.asarray(jctl._flatten_tenant_spec(per_cell, lead, 6, 6).priority))


def test_stream_errors():
    cfg = tctl.ControllerConfig()
    tables = _fleet(cfg, ("proposed",))
    trace, _ = _inputs()
    with pytest.raises(ValueError, match="unknown emit field 'mispredictions'"):
        tctl.simulate_fleet_stream(tables, trace, cfg, emit=("mispredictions",), device="cpu")
    with pytest.raises(ValueError, match="avail length 199 != trace length 200"):
        tctl.simulate_fleet_stream(tables, trace, cfg, avail=np.full(S - 1, 8.0),
                                   device="cpu")
    with pytest.raises(ValueError, match="must match the tables' leading axes"):
        tctl.simulate_fleet_stream(tables, np.stack([trace] * 3), cfg, device="cpu")
