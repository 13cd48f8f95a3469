"""Named workload scenario library and the campaign runner.

Port of ``repro.core.scenarios``; every trace, tenant plane and node
schedule is bit-identical to it (the same ``np.random.default_rng`` draws
in the same order, salted by the same ``zlib.crc32`` of the name).

Each scenario is a named, seeded generator of workload fractions
``w_t ∈ [0, 1]``: the paper's BURSE trace, diurnal cycles, flash crowds,
ramps, decays, tenant mixes, and node-failure shapes that carry a per-step
usable-nodes schedule beside the workload (alive fractions quantized
through :func:`repro_torch.runtime.elastic.shrink_mesh_plan`).  Replayed
traces (:mod:`repro_torch.core.traces`) register as scenarios too: the
bundled samples as ``replay_azure_vm_cpu`` / ``replay_google_cluster``,
plus the composed ``cloud_mix`` / ``cloud_splice`` / ``cloud_overlay``.

:func:`build_suite` stacks scenarios into ``[N, S]`` workload and
availability arrays (:func:`build_tenant_suite` into ``[N, S, T]`` tenant
planes), and :func:`run_campaign` sweeps platforms × techniques ×
scenarios: one table build (one ``grid_argmin`` launch), then every cell
through ``controller.simulate_fleet_stream``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import characterization as char
from repro_torch.core import controller as ctl
from repro_torch.core import scheduler as sched_mod
from repro_torch.core import traces
from repro_torch.core import workload as wl
from repro_torch.runtime import elastic
from repro_torch.runtime import fault as fault_mod

#: (n_steps, rng) → raw trace (clipped to [0, 1] by Scenario.trace)
TraceFn = Callable[[int, np.random.Generator], np.ndarray]

#: (n_steps, rng) → (per-tenant component traces [T, S], TenantSpec [T])
#: — the tenant-resolved twin of ``TraceFn``; the parts must sum to the
#: scenario's aggregate ``build`` output (same generator draw order).
TenantsFn = Callable[[int, np.random.Generator],
                     Tuple[np.ndarray, sched_mod.TenantSpec]]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded workload shape (and optional node-failure track)."""

    name: str
    description: str
    build: TraceFn
    #: alive-node *fraction* schedule — only for node-failure scenarios
    nodes: Optional[TraceFn] = None
    #: tenant decomposition — only for scenarios with named QoS classes;
    #: mixtures (``traces.mix`` builders) decompose automatically and
    #: everything else rides as a single default tenant.
    tenants: Optional[TenantsFn] = None
    #: RNG-salting name (defaults to ``name``) — derived overlay
    #: scenarios (:func:`with_failure_model`) pass their base's name so
    #: the workload realization is literally the base's, per seed.
    seed_name: Optional[str] = None

    def _rng(self, seed: int, salt: str = "") -> np.random.Generator:
        base = self.seed_name if self.seed_name is not None else self.name
        return np.random.default_rng(
            [seed, zlib.crc32((base + salt).encode())])

    def trace(self, n_steps: int, seed: int = 0) -> np.ndarray:
        """Workload fractions w_t ∈ [0, 1], deterministic per seed."""
        t = np.asarray(self.build(n_steps, self._rng(seed)), np.float32)
        assert t.shape == (n_steps,), (self.name, t.shape)
        return np.clip(t, 0.0, 1.0)

    def n_tenants(self) -> int:
        """Natural tenant count of this scenario's decomposition."""
        if self.tenants is not None:
            parts, _ = self.tenants(2, self._rng(0))
            return int(np.asarray(parts).shape[0])
        if isinstance(self.build, traces.MixedTrace):
            return len(self.build.fns)
        return 1

    def tenant_plane(self, n_steps: int, seed: int = 0,
                     n_tenants: Optional[int] = None
                     ) -> Tuple[np.ndarray, sched_mod.TenantSpec]:
        """Tenant-resolved workload plane ``([S, T], TenantSpec [T])``.

        Resolution order: an explicit ``tenants`` decomposition; a
        ``traces.mix`` builder (its weighted components become equal-
        priority tenants with the mix weights as shares); otherwise the
        aggregate trace as one default tenant.  Per-tenant demands are
        clipped at zero and jointly rescaled where their sum exceeds
        the fleet peak, so the plane's aggregate equals the clipped
        :meth:`trace` (to float precision) — disabling the scheduler on
        a tenant plane reproduces the aggregate campaign.  ``n_tenants``
        pads the tenant axis with inert slots
        (:func:`~repro_torch.core.scheduler.pad_tenants`) so mixed-width
        suites stack into one plane.
        """
        if self.tenants is not None:
            parts, spec = self.tenants(n_steps, self._rng(seed))
            parts = np.asarray(parts, np.float64)
        elif isinstance(self.build, traces.MixedTrace):
            parts = self.build.components(n_steps, self._rng(seed))
            t = parts.shape[0]
            spec = sched_mod.make_tenants([1.0] * t, [0.0] * t,
                                          self.build.weights)
        else:
            parts = np.asarray(self.trace(n_steps, seed), np.float64)[None]
            spec = sched_mod.default_tenants(1)
        assert parts.shape[-1] == n_steps, (self.name, parts.shape)
        # Joint rescale where the tenants together exceed the fleet
        # peak: total offered demand stays the clipped aggregate trace.
        parts = np.clip(parts, 0.0, None)
        tot = parts.sum(0)
        parts = parts * np.where(tot > 1.0, 1.0 / np.maximum(tot, 1e-9),
                                 1.0)
        plane = parts.T.astype(np.float32)                    # [S, T]
        if n_tenants is not None:
            t = plane.shape[1]
            if t > n_tenants:
                raise ValueError(
                    f"scenario {self.name!r} has {t} tenants; cannot fit "
                    f"a width-{n_tenants} plane — raise n_tenants")
            if t < n_tenants:
                spec = sched_mod.pad_tenants(spec, n_tenants)
                plane = np.pad(plane, ((0, 0), (0, n_tenants - t)))
        return plane, spec

    def node_schedule(self, n_steps: int, n_nodes: int,
                      seed: int = 0) -> np.ndarray:
        """Per-step usable-node counts ``[S]`` — the availability trace
        that feeds the §V control loop alongside the workload.

        A failure-free step always yields the full ``n_nodes`` (also for
        fleets that are not a power of two).  A *degraded* step is
        quantized through :func:`elastic.shrink_mesh_plan`: a failed
        fleet can only run the largest (data × model) grid that fits the
        survivors, so e.g. 7 of 8 alive nodes still only yield a 4-node
        usable mesh.
        """
        if self.nodes is None:
            return np.full(n_steps, n_nodes, np.int32)
        frac = np.clip(self.nodes(n_steps, self._rng(seed, "/nodes")),
                       0.0, 1.0)
        alive = np.minimum(n_nodes, np.maximum(
            1, np.round(frac * n_nodes))).astype(np.int64)
        prefer = 1 << (max(n_nodes, 1).bit_length() - 1)
        usable = {a: (int(a) if a >= n_nodes else
                      int(np.prod(elastic.shrink_mesh_plan(int(a), prefer))))
                  for a in np.unique(alive)}
        return np.asarray([usable[a] for a in alive], np.int32)


# ---------------------------------------------------------------------------
# Scenario builders
# ---------------------------------------------------------------------------


def _sub_seed(rng: np.random.Generator) -> int:
    return int(rng.integers(2 ** 31))


def _burse(n: int, rng: np.random.Generator) -> np.ndarray:
    """The paper's §VI-B trace: bursty self-similar, 40 % mean load."""
    return wl.generate_trace(wl.WorkloadConfig(n_steps=n,
                                               seed=_sub_seed(rng)))


def _diurnal(n: int, rng: np.random.Generator) -> np.ndarray:
    """Day/night user cycle with sporadic bursts (arXiv:2304.04488)."""
    period = max(min(n, 96), 2)
    return wl.generate_periodic_trace(n, period=period, mean_load=0.40,
                                      burst=0.25, seed=_sub_seed(rng))


def _flash_crowd_parts(n: int, rng: np.random.Generator
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Flash-crowd components, same draw order as the aggregate ever
    used: a steady interactive base (diurnal + noise) and the crowd
    spikes with their decay tails."""
    t = np.arange(n)
    base = 0.25 * (1.0 + 0.5 * np.sin(2 * np.pi * t / max(n // 4, 2)))
    steady = base + 0.02 * rng.standard_normal(n)
    crowd = np.zeros(n)
    for _ in range(max(1, n // 512)):
        t0 = int(rng.integers(0, n))
        amp = rng.uniform(0.5, 0.75)
        dur = max(8, n // 64)
        crowd[t0:] += amp * np.exp(-np.arange(n - t0) / dur)
    return steady, crowd


def _flash_crowd(n: int, rng: np.random.Generator) -> np.ndarray:
    """Moderate diurnal base + sudden near-peak spikes with decay tails."""
    steady, crowd = _flash_crowd_parts(n, rng)
    return steady + crowd


def _flash_crowd_tenants(n: int, rng: np.random.Generator
                         ) -> Tuple[np.ndarray, sched_mod.TenantSpec]:
    """Two QoS classes: the steady interactive base (high priority, no
    latency slack) vs the crowd surge (lower priority, may ride as
    backlog for up to 16 steps of its share) — the interactive-vs-burst
    split of arXiv:2304.04488.  Shares come from the realized demand."""
    steady, crowd = _flash_crowd_parts(n, rng)
    parts = np.stack([steady, crowd])
    means = np.maximum(np.clip(parts, 0.0, None).mean(-1), 1e-6)
    spec = sched_mod.make_tenants(priority=[2.0, 1.0],
                                  latency_target=[0.0, 16.0],
                                  share=means / means.sum())
    return parts, spec


def _ramp(n: int, rng: np.random.Generator) -> np.ndarray:
    """Slow capacity ramp 5 % → 95 % (a service gaining traffic)."""
    return (np.linspace(0.05, 0.95, n)
            + 0.03 * rng.standard_normal(n))


def _decay(n: int, rng: np.random.Generator) -> np.ndarray:
    """Exponential traffic decay from near peak (post-event cooldown)."""
    return (0.9 * np.exp(-np.arange(n) / max(n / 3.0, 1.0)) + 0.05
            + 0.03 * rng.standard_normal(n))


def _multi_tenant_parts(n: int, rng: np.random.Generator):
    """Weighted per-tenant component traces of the ``multi_tenant`` mix.

    Returns ``(parts, weights)`` with ``parts`` a list of the three
    weighted tenant traces (bursty / periodic / batch).  The generator
    draw order is exactly the pre-tenant aggregate's, so
    ``sum(parts)`` is bit-for-bit the historical trace.
    """
    streams = [
        wl.generate_trace(wl.WorkloadConfig(n_steps=n, mean_load=0.5,
                                            hurst=0.8, seed=_sub_seed(rng))),
        wl.generate_periodic_trace(n, period=max(n // 8, 2), mean_load=0.35,
                                   burst=0.2, seed=_sub_seed(rng)),
        np.clip(0.2 + 0.05 * rng.standard_normal(n), 0.0, 1.0),
    ]
    weights = rng.dirichlet(np.full(len(streams), 2.0))
    return [w * t for w, t in zip(weights, streams)], weights


def _multi_tenant(n: int, rng: np.random.Generator) -> np.ndarray:
    """Heterogeneous tenant mix (arXiv:2311.11015): one bursty
    long-range-dependent tenant, one periodic, one flat batch floor —
    Dirichlet-weighted so every seed draws a different mix."""
    parts, _ = _multi_tenant_parts(n, rng)
    return sum(parts)


def _multi_tenant_tenants(n: int, rng: np.random.Generator
                          ) -> Tuple[np.ndarray, sched_mod.TenantSpec]:
    """The mix's three QoS classes: bursty interactive traffic (high
    priority, one step of latency tolerance — zero would charge a
    violation for any epsilon of carried backlog, which no predictive
    controller can meet), a periodic service with modest latency
    headroom, and deferrable batch work — demand shares are the seed's
    Dirichlet mix weights."""
    parts, weights = _multi_tenant_parts(n, rng)
    spec = sched_mod.make_tenants(priority=[2.0, 1.0, 0.0],
                                  latency_target=[1.0, 8.0, 64.0],
                                  share=weights)
    return np.stack([np.asarray(p, np.float64) for p in parts]), spec


def _failure_nodes(n: int, rng: np.random.Generator) -> np.ndarray:
    """Alive fraction: a few failure windows dropping 20–50 % of nodes."""
    frac = np.ones(n)
    for _ in range(max(1, n // 256)):
        t0 = int(rng.integers(0, n))
        dur = int(rng.integers(max(n // 32, 2), max(n // 8, 4)))
        frac[t0:t0 + dur] -= rng.uniform(0.2, 0.5)
    return np.clip(frac, 0.1, 1.0)


# Correlated failure models (runtime.fault.FailureModel): every model's
# MTTF rescales to a fraction of the requested trace length (nodes_fn
# mttf_frac), so 64-step CI smokes and million-step campaigns both see a
# handful of failure windows.  The models carry their own reference
# fleet size and emit alive *fractions*; Scenario.node_schedule
# re-quantizes to the campaign's n_nodes through elastic.shrink_mesh_plan.

#: Rack-blast regime: most of the failure rate lands on whole racks
#: (a rack event kills every member node), wear-out hazard, ~12-step
#: lognormal repairs.
RACK_FAILURE_MODEL = fault_mod.FailureModel(
    n_nodes=8, n_racks=4, weibull_k=1.5, rack_fraction=0.9,
    repair_mu=2.5, repair_sigma=0.6)

#: Cascade regime: exponential MTTF but a pending repair quadruples
#: every hazard — failures cluster into correlated bursts that can
#: stack racks on top of nodes.
CASCADE_MODEL = fault_mod.FailureModel(
    n_nodes=8, n_racks=4, weibull_k=1.0, rack_fraction=0.5,
    cascade_factor=4.0, repair_mu=2.8, repair_sigma=0.5)

#: Flaky-fleet regime: frequent independent single-node failures with
#: quick repairs — churn, not blast radius.
FLAKY_FLEET_MODEL = fault_mod.FailureModel(
    n_nodes=8, n_racks=8, weibull_k=1.0, rack_fraction=0.0,
    repair_mu=1.2, repair_sigma=0.5)

FAILURE_MODELS: Dict[str, fault_mod.FailureModel] = {
    "rack_failure": RACK_FAILURE_MODEL,
    "cascade": CASCADE_MODEL,
    "flaky_fleet": FLAKY_FLEET_MODEL,
}


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario("burse", "paper §VI-B bursty self-similar (H=0.76, IDC=500)",
             _burse),
    Scenario("diurnal", "day/night periodic cycle with sporadic bursts",
             _diurnal),
    Scenario("flash_crowd", "diurnal base + sudden near-peak crowd spikes",
             _flash_crowd, tenants=_flash_crowd_tenants),
    Scenario("ramp", "slow load ramp 5% → 95%", _ramp),
    Scenario("decay", "exponential cooldown from near peak", _decay),
    Scenario("multi_tenant", "heterogeneous bursty/periodic/batch tenant mix",
             _multi_tenant, tenants=_multi_tenant_tenants),
    Scenario("node_failure", "bursty load + node-failure windows "
             "(per-step usable-nodes schedule clamps controller capacity)",
             _burse, nodes=_failure_nodes),
    Scenario("rack_failure", "bursty load + correlated rack-blast "
             "failures (Weibull wear-out, lognormal repairs)",
             _burse, nodes=RACK_FAILURE_MODEL.nodes_fn(mttf_frac=1 / 3)),
    Scenario("cascade", "bursty load + cascading failures (a pending "
             "repair multiplies every hazard — correlated bursts)",
             _burse, nodes=CASCADE_MODEL.nodes_fn(mttf_frac=1 / 3)),
    Scenario("flaky_fleet", "bursty load + frequent independent "
             "single-node failures with quick repairs (churn)",
             _burse, nodes=FLAKY_FLEET_MODEL.nodes_fn(mttf_frac=1 / 8)),
)}


def with_failure_model(name: str,
                       model: str | fault_mod.FailureModel,
                       mttf_frac: Optional[float] = 1 / 3,
                       suffix: Optional[str] = None,
                       overwrite: bool = True) -> Scenario:
    """Overlay a correlated failure model onto any registered scenario.

    Registers (and returns) a derived scenario ``<name>+<model>`` whose
    workload is ``name``'s and whose node schedule comes from ``model``
    (a :data:`FAILURE_MODELS` key or a
    :class:`~repro_torch.runtime.fault.FailureModel`) — the campaign CLI's
    ``--failure-model`` path: stress any workload shape under rack
    blasts, cascades, or churn without touching its trace.
    """
    base = get_scenario(name)
    if isinstance(model, str):
        if model not in FAILURE_MODELS:
            raise KeyError(f"unknown failure model {model!r}; "
                           f"available: {sorted(FAILURE_MODELS)}")
        suffix = suffix or model
        model = FAILURE_MODELS[model]
    return register_scenario(Scenario(
        f"{name}+{suffix or 'failures'}",
        f"{base.description} + correlated failures ({suffix or 'model'})",
        base.build, nodes=model.nodes_fn(mttf_frac=mttf_frac),
        tenants=base.tenants,
        seed_name=base.seed_name if base.seed_name is not None
        else base.name), overwrite=overwrite)


def pareto_front(cells: Dict[str, Dict[str, float]]) -> Tuple[str, ...]:
    """Non-dominated techniques over (power_gain ↑, qos_violation ↓).

    ``cells`` maps technique → campaign cell dict; a technique is kept
    iff no other strictly beats it on one axis while matching-or-beating
    it on the other.  Returned in descending power-gain order — the
    power-vs-robustness trade campaigns report per (platform, scenario).
    """
    def dominated(t: str) -> bool:
        g, q = cells[t]["power_gain"], cells[t]["qos_violation_rate"]
        for o, c in cells.items():
            if o == t:
                continue
            og, oq = c["power_gain"], c["qos_violation_rate"]
            if og >= g - 1e-12 and oq <= q + 1e-12 and (og > g + 1e-12
                                                       or oq < q - 1e-12):
                return True
        return False

    front = [t for t in cells if not dominated(t)]
    return tuple(sorted(front, key=lambda t: -cells[t]["power_gain"]))


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario by name (KeyError lists what exists)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def register_scenario(scenario: Scenario,
                      overwrite: bool = False) -> Scenario:
    """Add a scenario to the named library.

    Registered scenarios are swept by every campaign entry point
    (:func:`build_suite` / :func:`run_campaign` /
    ``python -m repro_torch.launch.campaign``)
    exactly like the built-in shapes.  Re-registering an existing name
    raises unless ``overwrite=True``.
    """
    if scenario.name in SCENARIOS and not overwrite:
        raise ValueError(f"scenario {scenario.name!r} already registered "
                         "(pass overwrite=True to replace it)")
    SCENARIOS[scenario.name] = scenario
    return scenario


def register_replay(source: traces.TraceSource, name: Optional[str] = None,
                    tau_s: Optional[float] = None, method: str = "auto",
                    jitter: str = "phase",
                    description: Optional[str] = None,
                    overwrite: bool = False) -> Scenario:
    """Register a replayed :class:`~repro_torch.core.traces.TraceSource` as a
    first-class named scenario (default name ``replay_<source.name>``).

    ``tau_s`` resamples the recording to that many seconds per control
    step (``None`` replays one source sample per step); ``jitter="phase"``
    starts each seeded build at a random offset into the looped series so
    suites stay seed-diverse.  The builder tiles/pads to any requested
    step count, so replays stream through a campaign exactly like the
    synthetic scenarios.
    """
    name = name or f"replay_{source.name}"
    if description is None:
        description = (f"replayed {source.provenance or source.name} "
                       f"({source.n_samples} samples @ "
                       f"{source.interval_s:g}s"
                       + (f", resampled to {tau_s:g}s/step"
                          if tau_s is not None else "") + ")")
    return register_scenario(
        Scenario(name, description, source.builder(tau_s, method, jitter)),
        overwrite=overwrite)


def _register_bundled_replays() -> None:
    """Auto-register the vendored ``data/traces`` samples (and two
    composed replay × synthetic shapes) at import time.  A checkout
    without the data directory simply gets the synthetic library, and a
    file that fails to load (e.g. a user-dropped CSV without a
    ``timestamp_s`` column) is warned about and skipped — importing
    this module must never break on trace data."""
    srcs: Dict[str, traces.TraceSource] = {}
    for name, path in traces.list_bundled().items():
        try:
            srcs[name] = traces.load(path)
        except Exception as e:  # noqa: BLE001 — skip, never break import
            import warnings
            warnings.warn(f"skipping unloadable bundled trace {path!r}: "
                          f"{type(e).__name__}: {e}")
    for src in srcs.values():
        register_replay(src, overwrite=True)
    azure = srcs.get("azure_vm_cpu")
    if azure is not None:
        register_scenario(Scenario(
            "cloud_mix",
            "replayed Azure-style day blended 60/40 with synthetic "
            "flash crowds (traces.mix)",
            traces.mix([azure, "flash_crowd"], [0.6, 0.4])),
            overwrite=True)
        register_scenario(Scenario(
            "cloud_splice",
            "replayed Azure-style day handing off to the paper's "
            "bursty BURSE tail (traces.splice)",
            traces.splice([azure, "burse"], [0.6, 0.4])),
            overwrite=True)
    google = srcs.get("google_cluster")
    if azure is not None and google is not None:
        # Pure-replay superposition: both components tile exactly, so
        # the blend tiles with the periods' lcm — the aggregate demand
        # a controller sees when two replayed clusters share a fleet.
        register_scenario(Scenario(
            "cloud_overlay",
            "both bundled cluster replays superposed 50/50 "
            "(traces.mix) — aggregate two-cluster demand",
            traces.mix([azure, google], [0.5, 0.5])),
            overwrite=True)


_register_bundled_replays()


def build_suite(names: Optional[Sequence[str]] = None, n_steps: int = 2048,
                n_nodes: int = 8, seed: int = 0
                ) -> Tuple[Tuple[str, ...], np.ndarray, np.ndarray]:
    """Stack named scenarios into ``(names, traces [N, S], avail [N, S])``.

    ``traces`` are the raw workload fractions (demand stays in
    configured-fleet units — failures no longer concentrate demand onto
    survivors); ``avail`` is the per-step usable-node schedule, a
    constant ``n_nodes`` row for healthy scenarios.  Both feed the fleet
    engines side by side: the controller clamps provisioning to
    ``avail`` so lost capacity surfaces as backlog/QoS, and dead nodes
    draw no power.
    """
    names = tuple(names) if names is not None else tuple(SCENARIOS)
    traces = np.stack([get_scenario(n).trace(n_steps, seed) for n in names])
    avail = np.stack([get_scenario(n).node_schedule(n_steps, n_nodes, seed)
                      for n in names]).astype(np.float32)
    return names, traces, avail


def build_tenant_suite(names: Optional[Sequence[str]] = None,
                       n_steps: int = 2048, n_nodes: int = 8, seed: int = 0,
                       n_tenants: Optional[int] = None
                       ) -> Tuple[Tuple[str, ...], np.ndarray, np.ndarray,
                                  sched_mod.TenantSpec]:
    """Tenant-resolved :func:`build_suite`: stacks named scenarios into
    ``(names, plane [N, S, T], avail [N, S], spec)`` with ``spec`` leaves
    ``[N, T]``.

    Every scenario's plane (:meth:`Scenario.tenant_plane`) is padded to
    a common tenant width — ``n_tenants`` when given (must cover the
    widest scenario), else the suite's natural maximum — with inert
    zero-share slots, so mixed-width suites stream as one ``[K, C, T]``
    plane.
    """
    names = tuple(names) if names is not None else tuple(SCENARIOS)
    built = [get_scenario(n).tenant_plane(n_steps, seed) for n in names]
    width = max(p.shape[1] for p, _ in built)
    if n_tenants is None:
        n_tenants = width
    elif n_tenants < width:
        widest = [n for n, (p, _) in zip(names, built)
                  if p.shape[1] == width]
        raise ValueError(
            f"n_tenants={n_tenants} cannot hold {widest[0]!r} "
            f"({width} tenants); pass n_tenants >= {width}")
    planes, specs = [], []
    for plane, spec in built:
        t = plane.shape[1]
        if t < n_tenants:
            spec = sched_mod.pad_tenants(spec, n_tenants)
            plane = np.pad(plane, ((0, 0), (0, n_tenants - t)))
        planes.append(plane)
        specs.append(spec)
    avail = np.stack([get_scenario(n).node_schedule(n_steps, n_nodes, seed)
                      for n in names]).astype(np.float32)
    spec = sched_mod.TenantSpec(
        *[np.stack([np.asarray(getattr(s, f), np.float32) for s in specs])
          for f in sched_mod.TenantSpec._fields])
    return names, np.stack(planes), avail, spec


# ---------------------------------------------------------------------------
# Campaign: platforms × techniques × scenarios in one streaming run
# ---------------------------------------------------------------------------


def run_campaign(platforms: Sequence[ctl.PlatformSpec],
                 scenario_names: Optional[Sequence[str]] = None,
                 techniques: Sequence[str] = ctl.DEFAULT_TECHNIQUES,
                 n_steps: int = 2048, seed: int = 0, chunk_size: int = 1024,
                 shard=True,
                 tenants: Optional[int | str] = None,
                 device=None, **cfg_kwargs) -> Dict[str, object]:
    """Sweep platforms × techniques × scenarios through the streaming
    fleet path.

    One masked grid sweep (``fleet_bin_tables``, one ``grid_argmin``
    launch on the card) builds every (platform × technique) table as
    ``[P, T, M]``; the scenario axis rides the tables as an ``expand`` view
    ``[P, T, N, M]``, and the whole fleet (``K = P·T·N`` cells) streams
    through :func:`controller.simulate_fleet_stream` in ``[K, C]`` chunks
    (``C = chunk_size``), so memory never grows with ``n_steps``.

    ``scenario_names`` may name any registered scenario (``None``: the
    whole library); ``**cfg_kwargs`` feed ``ControllerConfig``.
    Node-failure scenarios contribute their usable-nodes schedule beside
    the workload.  ``tenants`` switches to the tenant-resolved plane: an
    int pads every scenario's decomposition to that width (``"auto"``: the
    suite's widest), the ``scheduler=`` config splits capacity per step,
    and every cell also reports per-tenant QoS lists and
    ``worst_tenant_qos_violation``.  ``device`` follows the port's rule
    (``None`` is the card).  ``shard`` is
    :func:`controller.simulate_fleet_stream`'s: a ``FleetMesh`` splits the
    fleet axis over its devices; ``True`` runs on ``device`` for now.

    Returns ``{"scenarios", "techniques", "n_steps", "scheduler",
    "tenants", "table", "pareto"}`` where
    ``table[platform][technique][scenario]`` holds power_gain (vs the
    available fleet), power_gain_vs_configured, mean_power_w,
    mean_avail_nodes, qos_violation_rate, served_fraction, mean_backlog,
    misprediction_rate and margin_misprediction_rate, and
    ``pareto[platform][scenario]`` the non-dominated techniques.
    """
    cfg = ctl.ControllerConfig(**cfg_kwargs)
    if tenants is not None and not (tenants == "auto"
                                    or (isinstance(tenants, int)
                                        and tenants >= 1)):
        raise ValueError(f"tenants must be None, 'auto', or an int >= 1, "
                         f"got {tenants!r}")
    spec = None
    if tenants is None:
        names, traces, avail = build_suite(scenario_names, n_steps=n_steps,
                                           n_nodes=cfg.n_nodes, seed=seed)
    else:
        width = None if tenants == "auto" else int(tenants)
        names, traces, avail, spec = build_tenant_suite(
            scenario_names, n_steps=n_steps, n_nodes=cfg.n_nodes,
            seed=seed, n_tenants=width)
    params = char.stack_platform_params([p.params for p in platforms])
    tables = ctl.fleet_bin_tables(params, cfg, techniques,
                                  device=device)               # [P, T, M]
    n_scen = len(names)
    # The scenario axis rides the tables' leading axes as a view:
    # [P, T, M] → [P, T, N, M]; traces and availability go in as
    # [1, 1, N, S] (tenant planes [1, 1, N, S, T], spec leaves [1, 1, N, T]).
    tab_n = ctl.BinTables(*[x[:, :, None].expand(
        x.shape[:2] + (n_scen,) + x.shape[2:]) for x in tables])
    if spec is not None:
        spec = sched_mod.TenantSpec(*[x[None, None] for x in spec])
    summary = ctl.simulate_fleet_stream(tab_n, traces[None, None], cfg,
                                        chunk_size=chunk_size, shard=shard,
                                        avail=avail[None, None],
                                        tenant_spec=spec, device=device)
    node_nom_w = ctl.fleet_node_nominal_watts(params, cfg)     # [P]
    nominal_cfg_w = node_nom_w * cfg.n_nodes                   # [P]
    n_scored = max(n_steps - cfg.predictor.warmup_steps, 1)

    table: Dict[str, Dict[str, Dict[str, Dict[str, float]]]] = {}
    for i, plat in enumerate(platforms):
        table[plat.name] = {}
        for j, tech in enumerate(techniques):
            table[plat.name][tech] = {}
            for k, scen in enumerate(names):
                mean_w = float(summary.mean_power_w[i, j, k])
                mean_avail = float(summary.mean_avail_nodes[i, j, k])
                cell = {
                    "power_gain": float(node_nom_w[i]) * mean_avail / mean_w,
                    "power_gain_vs_configured":
                        float(nominal_cfg_w[i]) / mean_w,
                    "mean_power_w": mean_w,
                    "mean_avail_nodes": mean_avail,
                    "qos_violation_rate":
                        float(summary.qos_violation_rate[i, j, k]),
                    "served_fraction":
                        float(summary.served_fraction[i, j, k]),
                    "mean_backlog": float(summary.mean_backlog[i, j, k]),
                    "misprediction_rate":
                        float(summary.mispredictions[i, j, k]) / n_scored,
                    "margin_misprediction_rate":
                        float(summary.margin_misses[i, j, k]) / n_scored,
                }
                if spec is not None:
                    active = np.asarray(spec.active)[0, 0, k] > 0
                    t_viol = summary.tenant_qos_violation_rate[i, j, k]
                    cell["tenant_qos_violation_rate"] = [
                        float(x) for x in t_viol]
                    cell["tenant_starvation_rate"] = [
                        float(x) for x in
                        summary.tenant_starvation_rate[i, j, k]]
                    cell["tenant_served_fraction"] = [
                        float(x) for x in
                        summary.tenant_served_fraction[i, j, k]]
                    cell["worst_tenant_qos_violation"] = float(
                        t_viol[active].max()) if active.any() else 0.0
                table[plat.name][tech][scen] = cell
    # Pareto reporting: per (platform, scenario), the non-dominated
    # techniques over (power_gain ↑, qos_violation_rate ↓) — the
    # power-vs-robustness trade failure campaigns track in benchmarks.
    pareto: Dict[str, Dict[str, Tuple[str, ...]]] = {}
    for plat in platforms:
        pareto[plat.name] = {}
        for scen in names:
            pareto[plat.name][scen] = pareto_front(
                {t: table[plat.name][t][scen] for t in techniques})
    return {"scenarios": names, "techniques": tuple(techniques),
            "n_steps": n_steps, "scheduler": cfg.scheduler.name,
            "tenants": (None if spec is None
                        else int(np.asarray(spec.active).shape[-1])),
            "table": table, "pareto": pareto}
