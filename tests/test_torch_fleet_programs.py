"""The fleet's programs and their counter, on the CPU.

The JAX package compiles its three fleet programs (the table sweep, the
materializing loop, the streaming chunk) once per jit key and counts the
traces in ``controller.fleet_trace_counts()``.  The port builds one
program per key (on the card a captured CUDA graph of the control step;
here the same step run eagerly) and counts them the same way.  Held here:

* every sequence that a reference zero-retrace test runs
  (``tests/test_fleet.py``, ``test_failure_models.py``,
  ``test_scenarios.py``, ``test_scheduler.py``, ``test_traces.py``) and the
  five ``*/stream_reuse*`` rows of ``benchmarks/run.py``, through both
  packages: the port's counter deltas equal JAX's at every step of the
  sequence, and the rows' final deltas are ``BENCH_fleet.json``'s (0, 0,
  0, 1, 0).  Every sequence runs at 23 bins, which no other test uses, so
  that both process-long caches start cold for its keys whichever tests
  ran before in the worker;
* the weak flags of the tables' fields (``WeakLeaf``) against the JAX
  package's ``weak_type`` for every technique and some mixes;
* the keyed programs bit-equal to the eager step loop they replace (a
  copy of it is kept here), with a tail chunk, a healthy fleet and an
  availability schedule;
* ``aot.warm_fleet_programs`` leaving a following same-shaped campaign at
  0 new programs, and the composition search's ``retraces_second_half``
  at 0.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import scenarios as jscn
from repro.core import workload as jwl
from repro.core.accelerators import ACCELERATORS as JACC
from repro_torch.core import aot
from repro_torch.core import characterization as tchar
from repro_torch.core import composition as tcomp
from repro_torch.core import controller as tctl
from repro_torch.core import predictors as tpred
from repro_torch.core import scenarios as tscn
from repro_torch.core import scheduler as tsched
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC

BINS = 23              # no other test runs 23 bins: every key here starts cold
JAX = SimpleNamespace(ctl=jctl, scn=jscn, char=jchar, wl=jwl, acc=JACC, kw={})
PORT = SimpleNamespace(ctl=tctl, scn=tscn, char=tchar, wl=twl, acc=TACC,
                       kw={"device": "cpu"})
ZERO = {"tables": 0, "simulate": 0, "stream": 0}


def _plats(p, *names):
    return [p.ctl.fpga_platform(p.acc[n]) for n in names]


def _trace(p, n, seed):
    return np.asarray(p.wl.generate_trace(p.wl.WorkloadConfig(n_steps=n, seed=seed)),
                      np.float32)


def _campaign(p, plats, **kw):
    return p.scn.run_campaign(plats, n_bins=BINS, **kw, **p.kw)


# --- the reference's zero-retrace sequences, at their own shapes ------------------------


def _fleet_zero_retrace(p, mark):                     # test_fleet.py:85
    p.ctl.compare_all_batched(_plats(p, "tabla", "dnnweaver"), _trace(p, 136, 0),
                              n_bins=BINS, **p.kw)
    mark()
    p.ctl.compare_all_batched(_plats(p, "diannao", "proteus"), _trace(p, 136, 9),
                              n_bins=BINS, **p.kw)
    mark()


def _hybrid_acceptance(p, mark):                      # test_fleet.py:137
    trace = _trace(p, 144, 0)
    p.ctl.compare_all_batched(_plats(p, "tabla", "stripes"), trace, n_bins=BINS, **p.kw)
    mark()
    p.ctl.compare_all_batched(_plats(p, "diannao", "proteus"), trace, n_bins=BINS, **p.kw)
    mark()


def _predictor_sweep(p, mark):                        # test_fleet.py:316
    configs = [p.ctl.ControllerConfig(predictor=k, n_bins=BINS) for k in ("ewma", "hierarchy")]
    first = p.char.stack_platform_params([_plats(p, "tabla")[0].params])
    trace = _trace(p, 152, 0)
    for cfg in configs:
        tables = p.ctl.fleet_bin_tables(first, cfg, ("proposed", "hybrid"), **p.kw)
        p.ctl.simulate_fleet(tables, trace, cfg, **p.kw)
        p.ctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=44, **p.kw)
    mark()
    second = p.char.stack_platform_params([_plats(p, "stripes")[0].params])
    for seed, cfg in zip((21, 22), configs):
        trace2 = _trace(p, 152, seed)
        tables2 = p.ctl.fleet_bin_tables(second, cfg, ("proposed", "hybrid"), **p.kw)
        p.ctl.simulate_fleet(tables2, trace2, cfg, **p.kw)
        p.ctl.simulate_fleet_stream(tables2, trace2, cfg, chunk_size=44, **p.kw)
    mark()


def _failure_sweep(p, mark):                          # test_failure_models.py:284
    kw = dict(techniques=("proposed", "headroom"), n_steps=168, chunk_size=44)
    tabla = _plats(p, "tabla")
    _campaign(p, tabla, scenario_names=("burse", "diurnal", "ramp"), **kw)
    mark()
    _campaign(p, tabla, scenario_names=("rack_failure", "cascade", "flaky_fleet"), seed=3, **kw)
    overlay = p.scn.with_failure_model("ramp", "cascade")
    _campaign(p, tabla, scenario_names=("burse", "node_failure", overlay.name), seed=4, **kw)
    mark()


def _scenario_sweeps(p, mark):                        # test_scenarios.py:160
    kw = dict(techniques=("proposed", "power_gating"), n_steps=120, chunk_size=44)
    _campaign(p, _plats(p, "tabla"), scenario_names=("burse", "diurnal"), **kw)
    mark()
    _campaign(p, _plats(p, "tabla"), scenario_names=("ramp", "decay"), seed=5, **kw)
    mark()


def _availability(p, mark):                           # test_scenarios.py:180
    kw = dict(techniques=("proposed", "hybrid"), n_steps=168, chunk_size=44)
    tabla = _plats(p, "tabla")
    _campaign(p, tabla, scenario_names=("burse", "diurnal"), **kw)
    cfg = p.ctl.ControllerConfig(n_bins=BINS)
    params = p.char.stack_platform_params([x.params for x in tabla])
    tables = p.ctl.fleet_bin_tables(params, cfg, ("proposed", "hybrid"), **p.kw)
    trace = p.scn.get_scenario("node_failure").trace(168, seed=0)
    p.ctl.simulate_fleet(tables, trace, cfg, **p.kw)
    p.ctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=44, **p.kw)
    mark()
    _campaign(p, tabla, scenario_names=("burse", "node_failure"), seed=2, **kw)
    avail = p.scn.get_scenario("node_failure").node_schedule(168, cfg.n_nodes, seed=2)
    p.ctl.simulate_fleet(tables, trace, cfg, avail=avail, **p.kw)
    p.ctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=44, avail=avail, **p.kw)
    mark()


def _sched(p, **kw):                                  # test_scheduler.py's _campaign
    kw.setdefault("scenario_names", ("multi_tenant",))
    kw.setdefault("techniques", ("hybrid",))
    _campaign(p, _plats(p, "tabla"), n_steps=176, chunk_size=56, **kw)


def _scheduler_onoff(p, mark):                        # test_scheduler.py:140
    _sched(p, tenants=3, scheduler="priority")
    mark()
    _sched(p, tenants=3, scheduler="none")
    _sched(p, tenants=3, scheduler="fair_share")
    mark()


def _tenant_width(p, mark):                           # test_scheduler.py:150
    _sched(p, tenants=4, scheduler="priority")
    mark()
    _sched(p, scenario_names=("flash_crowd",), tenants=4, scheduler="priority")
    _sched(p, scenario_names=("burse",), tenants=4, scheduler="priority")
    mark()


def _replay(p, mark):                                 # test_traces.py:228
    kw = dict(techniques=("proposed", "hybrid"), n_steps=168, chunk_size=52)
    _campaign(p, _plats(p, "tabla"), scenario_names=("burse", "diurnal"), **kw)
    mark()
    _campaign(p, _plats(p, "tabla"),
              scenario_names=("replay_azure_vm_cpu", "replay_google_cluster"), **kw)
    mark()


REFERENCE_SEQUENCES = {
    "fleet_zero_retrace": _fleet_zero_retrace, "hybrid_acceptance": _hybrid_acceptance,
    "predictor_sweep": _predictor_sweep, "failure_sweep": _failure_sweep,
    "scenario_sweeps": _scenario_sweeps, "availability": _availability,
    "scheduler_onoff": _scheduler_onoff, "tenant_width": _tenant_width, "replay": _replay,
}


# --- benchmarks/run.py's five */stream_reuse* rows, at BENCH_STEPS steps --------------

BENCH_STEPS = 104       # chunk = min(steps, 512), as the benchmark sets it


def _bench_kw(techniques):
    return dict(techniques=techniques, n_steps=BENCH_STEPS, chunk_size=BENCH_STEPS)


def _campaign_reuse(p, mark):
    kw = dict(scenario_names=("burse", "diurnal", "flash_crowd", "node_failure"),
              **_bench_kw(("proposed", "power_gating", "hybrid")))
    _campaign(p, _plats(p, "tabla", "stripes"), **kw)
    mark()
    _campaign(p, _plats(p, "tabla", "stripes"), seed=1, **kw)
    mark()


def _failure_reuse(p, mark):
    kw = _bench_kw(("proposed", "power_gating", "hybrid", "headroom"))
    two = _plats(p, "tabla", "stripes")
    _campaign(p, two, scenario_names=("burse", "diurnal", "flash_crowd", "ramp", "decay"), **kw)
    mark()
    _campaign(p, two, scenario_names=("burse", "node_failure", "rack_failure", "cascade",
                                      "flaky_fleet"), **kw)
    mark()


def _replay_reuse(p, mark):
    kw = _bench_kw(("proposed", "power_gating", "hybrid"))
    _campaign(p, _plats(p, "tabla"), scenario_names=("burse", "diurnal", "ramp"), **kw)
    mark()
    _campaign(p, _plats(p, "tabla"), scenario_names=(
        "replay_azure_vm_cpu", "replay_google_cluster", "cloud_mix"), **kw)
    mark()


def _scheduler_reuse_onoff(p, mark):
    kw = dict(scenario_names=("multi_tenant",), tenants=3, n_steps=BENCH_STEPS,
              chunk_size=BENCH_STEPS)
    for i, (tech, sched) in enumerate((("hybrid", "priority"), ("hybrid", "none"),
                                       ("power_gating", "priority"))):
        _campaign(p, _plats(p, "tabla"), techniques=(tech,), scheduler=sched, **kw)
        if i == 0:
            mark()
    mark()


def _scheduler_reuse_width(p, mark):
    kw = dict(techniques=("hybrid",), tenants=4, scheduler="priority", n_steps=BENCH_STEPS,
              chunk_size=BENCH_STEPS)
    _campaign(p, _plats(p, "tabla"), scenario_names=("multi_tenant",), **kw)
    mark()
    _campaign(p, _plats(p, "tabla"), scenario_names=("flash_crowd",), **kw)
    mark()


#: row → (sequence, its stream delta in BENCH_fleet.json)
BENCH_ROWS = {
    "campaign/stream_reuse": (_campaign_reuse, 0),
    "failure/stream_reuse": (_failure_reuse, 0),
    "replay/stream_reuse": (_replay_reuse, 0),
    "scheduler/stream_reuse_onoff": (_scheduler_reuse_onoff, 1),
    "scheduler/stream_reuse_tenant_width": (_scheduler_reuse_width, 0),
}


def _deltas(p, seq):
    marks = [p.ctl.fleet_trace_counts()]
    seq(p, lambda: marks.append(p.ctl.fleet_trace_counts()))
    return [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]


@pytest.mark.parametrize("name", sorted(REFERENCE_SEQUENCES))
def test_port_builds_what_jax_traces_in_each_zero_retrace_sequence(name):
    want = _deltas(JAX, REFERENCE_SEQUENCES[name])
    got = _deltas(PORT, REFERENCE_SEQUENCES[name])
    assert got == want
    assert any(d != ZERO for d in got[:-1]), "the warm-up built nothing: not a cold key"
    assert got[-1] == ZERO


@pytest.mark.parametrize("row", sorted(BENCH_ROWS))
def test_stream_reuse_rows_count_as_the_benchmark(row):
    seq, bench = BENCH_ROWS[row]
    want = _deltas(JAX, seq)
    got = _deltas(PORT, seq)
    assert got == want
    assert got[-1]["stream"] == want[-1]["stream"] == bench


def test_runtime_cfg_ignores_technique_scheduler_and_headroom():
    a = tctl.ControllerConfig(technique="hybrid", scheduler="priority", headroom_frac=0.25)
    b = tctl.ControllerConfig(technique="proposed", scheduler="none")
    assert tctl._runtime_cfg(a) == tctl._runtime_cfg(b)
    assert hash(tctl._runtime_cfg(a)) == hash(tctl._runtime_cfg(b))
    assert tctl._runtime_cfg(a) != tctl._runtime_cfg(tctl.ControllerConfig(predictor="ewma"))


@pytest.mark.parametrize("techniques", [(t,) for t in tctl.TECHNIQUES] + [
    ("proposed", "power_gating", "hybrid"), ("hybrid", "headroom"), ("proposed", "nominal"),
    tctl.DEFAULT_TECHNIQUES])
def test_weak_fields_are_jaxs(techniques):
    """A jit key holds each input's weak type; the port's tables mark the
    fields JAX builds weakly typed, and views and ops keep the flag as JAX
    does (weak where every input is)."""
    jp = jchar.stack_platform_params([jctl.fpga_platform(JACC["tabla"]).params])
    tp = tchar.stack_platform_params([tctl.fpga_platform(TACC["tabla"]).params])
    j = jctl.fleet_bin_tables(jp, jctl.ControllerConfig(), techniques)
    t = tctl.fleet_bin_tables(tp, tctl.ControllerConfig(), techniques, device="cpu")
    assert ([f for f in j._fields if getattr(j, f).weak_type]
            == [f for f in t._fields if isinstance(getattr(t, f), tctl.WeakLeaf)])
    x = t.v_core[:, :, None].expand(1, len(techniques), 3, t.v_core.shape[-1])
    assert isinstance(x.reshape(-1, x.shape[-1]), tctl.WeakLeaf)
    assert isinstance(x * 2.0, tctl.WeakLeaf) and not isinstance(x * t.power[:, :, None],
                                                                 tctl.WeakLeaf)
    assert torch.equal(x.as_subclass(torch.Tensor)[:, :, 0], t.v_core.as_subclass(torch.Tensor))


# --- the keyed programs against the eager loop they replace ---------------------------


def _eager_simulate(tables, cfg, traces, avail):
    """The materializing loop as the port ran it before its programs:
    fields ``[K, S]``."""
    k, s = traces.shape
    spec = tsched.default_tenants(1).to("cpu")
    sched = tsched.scheduler_values(tsched.SCHEDULERS["none"])
    carry = (tpred.init_state(cfg.predictor, k, "cpu"),
             tpred.init_state(cfg.avail_predictor, k, "cpu"),
             torch.zeros((k, 1)), torch.zeros((k, 1)))
    outs = {e: [] for e in tctl._EMITTABLE}
    for t in range(s):
        carry, out = tctl._control_step(tables, cfg, carry, traces[:, t, None], avail[:, t],
                                        spec, sched)
        for e in outs:
            outs[e].append(getattr(out, e))
    return {e: torch.stack(x, -1) for e, x in outs.items()}, carry[0]


def _eager_stream(tables, cfg, trace, avail, chunk, emit):
    """The streaming loop as the port ran it before its programs (one
    aggregate tenant, the tail chunk only its steps long): the per-cell
    sums added in float64 and the emitted fields."""
    k, s = avail.shape
    spec = tsched.TenantSpec(*[x.expand(k, 1) for x in tsched.default_tenants(1).to("cpu")])
    sched = tsched.scheduler_values(tsched.SCHEDULERS["none"])
    carry = (tpred.init_state(cfg.predictor, k, "cpu"),
             tpred.init_state(cfg.avail_predictor, k, "cpu"),
             torch.zeros((k, 1)), torch.zeros((k, 1)))
    sums = {n: np.zeros(k) for n in ("power", "viol", "backlog", "offered", "avail")}
    ys = {e: [] for e in emit}
    for s0 in range(0, s, chunk):
        part = {n: torch.zeros(k) for n in sums}
        for i in range(s0, min(s0 + chunk, s)):
            w_t = torch.as_tensor(trace[None, i, None]).expand(k, 1)
            carry, out = tctl._control_step(tables, cfg, carry, w_t, avail[:, i], spec, sched)
            part["power"] = part["power"] + out.power
            part["viol"] = part["viol"] + out.violation.float()
            part["backlog"] = part["backlog"] + out.backlog
            part["offered"] = part["offered"] + (w_t * spec.active).sum(-1)
            part["avail"] = part["avail"] + avail[:, i]
            for e in emit:
                ys[e].append(getattr(out, e))
        for n in sums:
            sums[n] += part[n].numpy().astype(np.float64)
    return sums, carry, {e: torch.stack(y, -1).numpy() for e, y in ys.items()}


@pytest.mark.parametrize("predictor", ["ewma", "markov", "holt_winters"])
def test_simulate_program_is_the_eager_loop_bit_for_bit(predictor):
    cfg = tctl.ControllerConfig(predictor=predictor, n_bins=BINS)
    tp = tchar.stack_platform_params([p.params for p in _plats(PORT, "tabla", "stripes")])
    tables = tctl.fleet_bin_tables(tp, cfg, ("proposed", "hybrid", "headroom"), device="cpu")
    trace = _trace(PORT, 97, 4)
    avail = np.random.default_rng(5).integers(2, 9, 97).astype(np.float32)
    flat = tctl.BinTables(*[x.reshape((6,) + x.shape[2:]) for x in tables])
    for av in (None, avail):
        got = tctl.simulate_fleet(tables, trace, cfg, avail=av, device="cpu")
        av_k = torch.full((6, 97), float(cfg.n_nodes)) if av is None else \
            torch.tensor(np.broadcast_to(av, (6, 97)))
        want, mstate = _eager_simulate(flat, cfg, torch.tensor(np.broadcast_to(trace, (6, 97))),
                                       av_k)
        for e, x in want.items():
            name = "violations" if e == "violation" else e
            assert torch.equal(getattr(got, name).reshape(6, 97), x), e
        assert torch.equal(got.mispredictions.reshape(6), mstate.mispredictions)
        assert torch.equal(got.margin_misses.reshape(6), mstate.margin_misses)


@pytest.mark.parametrize("chunk", [32, 97])
@pytest.mark.parametrize("healthy", [True, False])
def test_stream_program_is_the_eager_loop_bit_for_bit(chunk, healthy):
    """A tail chunk of 1 (97 = 3·32 + 1) or none, a healthy fleet's
    constant ``[K, C]`` availability or a schedule: every sum, the final
    state and the emitted fields equal the eager loop's."""
    cfg = tctl.ControllerConfig(n_bins=BINS, predictor="hierarchy")
    tp = tchar.stack_platform_params([p.params for p in _plats(PORT, "tabla", "stripes")])
    tables = tctl.fleet_bin_tables(tp, cfg, ("proposed", "hybrid", "headroom"), device="cpu")
    trace = _trace(PORT, 97, 6)
    sched = None if healthy else np.random.default_rng(7).integers(2, 9, 97).astype(np.float32)
    emit = ("power", "predicted_bin", "violation")
    got = tctl.simulate_fleet_stream(tables, trace, cfg, chunk_size=chunk, avail=sched,
                                     emit=("power", "predicted_bin", "violations"), device="cpu")
    flat = tctl.BinTables(*[x.reshape((6,) + x.shape[2:]) for x in tables])
    av = torch.full((6, 97), float(cfg.n_nodes)) if healthy else \
        torch.tensor(np.broadcast_to(sched, (6, 97)))
    sums, carry, ys = _eager_stream(flat, cfg, trace, av, chunk, emit)
    np.testing.assert_array_equal(got.mean_power_w.reshape(6), sums["power"] / 97)
    np.testing.assert_array_equal(got.qos_violation_rate.reshape(6), sums["viol"] / 97)
    np.testing.assert_array_equal(got.mean_backlog.reshape(6), sums["backlog"] / 97)
    np.testing.assert_array_equal(got.offered.reshape(6), sums["offered"])
    np.testing.assert_array_equal(got.mean_avail_nodes.reshape(6), sums["avail"] / 97)
    np.testing.assert_array_equal(got.final_backlog.reshape(6), carry[2].sum(-1).numpy())
    np.testing.assert_array_equal(got.mispredictions.reshape(6), carry[0].mispredictions.numpy())
    for e, want in zip(("power", "predicted_bin", "violations"), ys.values()):
        np.testing.assert_array_equal(got.emitted[e].reshape(6, 97), want, err_msg=e)


def test_a_tail_chunk_reuses_the_program():
    """S = 3·C + 5: the tail is padded to C under the valid mask and runs the
    same program; a second trace length at the same C builds nothing."""
    cfg = tctl.ControllerConfig(n_bins=BINS)
    tp = tchar.stack_platform_params([_plats(PORT, "tabla")[0].params])
    tables = tctl.fleet_bin_tables(tp, cfg, ("proposed", "power_gating"), device="cpu")
    before = tctl.fleet_trace_counts()
    tctl.simulate_fleet_stream(tables, _trace(PORT, 3 * 36 + 5, 1), cfg, chunk_size=36,
                               device="cpu")
    mid = tctl.fleet_trace_counts()
    assert mid["stream"] - before["stream"] == 1
    tctl.simulate_fleet_stream(tables, _trace(PORT, 7 * 36 + 30, 2), cfg, chunk_size=36,
                               device="cpu")
    assert tctl.fleet_trace_counts() == mid


def test_warm_fleet_programs_leave_a_same_shaped_campaign_nothing_to_build():
    plats = _plats(PORT, "tabla", "stripes")
    params = tchar.stack_platform_params([p.params for p in plats])
    techniques = ("proposed", "hybrid")
    names = ("burse", "diurnal", "ramp")
    cfg = tctl.ControllerConfig(n_bins=BINS)
    for tenants in (None, 2):
        before = tctl.fleet_trace_counts()
        aot.warm_fleet_programs(params, cfg, techniques, fleet_shape=(2, 2, 3),
                                chunk_size=60, n_tenants=tenants or 1, device="cpu")
        warmed = tctl.fleet_trace_counts()
        assert warmed["stream"] > before["stream"]
        tscn.run_campaign(plats, scenario_names=names, techniques=techniques, n_steps=150,
                          chunk_size=60, n_bins=BINS, tenants=tenants, device="cpu")
        assert tctl.fleet_trace_counts() == warmed, tenants


def test_composition_second_half_builds_nothing():
    plats = _plats(PORT, "tabla", "stripes")
    cand = tcomp.enumerate_candidates(2, 3, 10, seed=1)
    res = tcomp.search_fleet_composition(plats, cand, ("burse", "node_failure"), n_steps=88,
                                         chunk_size=40, n_bins=BINS, device="cpu")
    assert res.retraces_second_half == 0


def test_a_warmed_composition_search_builds_nothing():
    """The compose CLI's ``--warm``: the warmer builds the search's table and
    stream programs (its fleet at the candidate half's shape), so the
    search itself adds nothing to the counter."""
    plats = _plats(PORT, "tabla", "stripes")
    cand = tcomp.enumerate_candidates(2, 3, 14, seed=2)
    params = tchar.stack_platform_params([p.params for p in plats])
    aot.warm_fleet_programs(params, tctl.ControllerConfig(n_bins=BINS), ("proposed",),
                            fleet_shape=(7, 2, 2), chunk_size=48, device="cpu")
    before = tctl.fleet_trace_counts()
    tcomp.search_fleet_composition(plats, cand, ("burse", "diurnal"), n_steps=96,
                                   chunk_size=48, n_bins=BINS, device="cpu")
    assert tctl.fleet_trace_counts() == before
