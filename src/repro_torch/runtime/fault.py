"""Correlated fleet-failure models for the §V availability plane.

Port of the numpy half of ``repro.runtime.fault``, bit-identical to it:
:class:`FailureModel` — rack-level blast radius, Weibull or exponential
time to failure, lognormal repairs — samples per-node up/down matrices and
emits per-step usable-node schedules.  Failures never change workload
traces; they ride beside them into the control loop
(:mod:`repro_torch.core.scenarios` registers the ``rack_failure`` /
``cascade`` / ``flaky_fleet`` shapes on top of it).  The restart half
(``FaultInjector``, ``run_with_restarts``) belongs to training and is not
ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np


class FailureEvent(NamedTuple):
    """One failure event of the sampled process (for tests/inspection)."""

    step: int            # when the entity went down
    kind: str            # "rack" | "node"
    entity: int          # rack index or node index (within its kind)
    members: tuple       # node ids taken down by this event
    repair_end: int      # first step the entity is back up (exclusive end)


class FailureTrace(NamedTuple):
    """A sampled fleet-failure realization.

    ``alive`` is the raw per-node up/down matrix (``[S, n_nodes]`` bool,
    before the alive floor); ``events`` lists every failure with its
    blast radius and repair window, so properties like "a rack event
    never kills nodes outside its rack" are directly checkable.
    """

    alive: np.ndarray          # [S, n_nodes] bool
    events: List[FailureEvent]


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Correlated fleet-failure process (host-side generator).

    Nodes are striped into ``n_racks`` racks; failure *entities* are the
    racks plus the individual nodes.  Each up entity fails per step with
    a Weibull hazard of its age — ``weibull_k = 1`` is the memoryless
    exponential-MTTF special case, ``> 1`` models wear-out (hazard grows
    with uptime).  ``mttf_steps`` is the Weibull scale: the
    characteristic time-to-failure of one entity, in control steps.
    ``rack_fraction`` splits the failure rate between rack events (a
    whole-rack blast radius: every member node dies) and independent
    single-node events.  A downed entity repairs after a lognormal
    duration (``exp(N(repair_mu, repair_sigma))`` steps, floored at 1).
    While *any* repair is pending every hazard is multiplied by
    ``cascade_factor`` — > 1 clusters failures into correlated bursts
    (the cascade regime), 1.0 keeps entities independent.

    The emitted schedules honor the availability contract: per-step
    usable-node counts, integer, ``alive_floor ≤ avail ≤ n_nodes`` —
    failures never mutate workload traces.
    """

    n_nodes: int = 8
    n_racks: int = 4
    mttf_steps: float = 512.0
    weibull_k: float = 1.0        # 1.0 = exponential; > 1 = wear-out
    repair_mu: float = 2.5        # lognormal ln-mean, in steps (e^2.5 ≈ 12)
    repair_sigma: float = 0.6     # lognormal ln-std
    rack_fraction: float = 0.5    # share of the failure rate in rack events
    cascade_factor: float = 1.0   # hazard multiplier while repairs pend
    alive_floor: int = 1          # emitted schedules never drop below this

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes {self.n_nodes} must be ≥ 1")
        if not 1 <= self.n_racks <= self.n_nodes:
            raise ValueError(f"n_racks {self.n_racks} must be in "
                             f"[1, n_nodes={self.n_nodes}]")
        if self.mttf_steps <= 0:
            raise ValueError(f"mttf_steps {self.mttf_steps} must be > 0")
        if self.weibull_k <= 0:
            raise ValueError(f"weibull_k {self.weibull_k} must be > 0")
        if self.repair_sigma < 0:
            raise ValueError(f"repair_sigma {self.repair_sigma} must be ≥ 0")
        if not 0.0 <= self.rack_fraction <= 1.0:
            raise ValueError(f"rack_fraction {self.rack_fraction} must be "
                             "in [0, 1]")
        if self.cascade_factor < 1.0:
            raise ValueError(f"cascade_factor {self.cascade_factor} must "
                             "be ≥ 1 (1 = independent entities)")
        if not 1 <= self.alive_floor <= self.n_nodes:
            raise ValueError(f"alive_floor {self.alive_floor} must be in "
                             f"[1, n_nodes={self.n_nodes}]")

    def rack_members(self) -> List[np.ndarray]:
        """Node ids per rack (contiguous stripes, sizes differ by ≤ 1)."""
        return np.array_split(np.arange(self.n_nodes), self.n_racks)

    def _hazards(self) -> np.ndarray:
        """Per-entity Weibull scale λ: racks first, then nodes.

        The total failure rate ~ 1/mttf splits ``rack_fraction`` to the
        rack entities and the rest to node entities; a zero share makes
        that entity class immortal (λ = ∞ → hazard 0).
        """
        lam_rack = (self.mttf_steps / self.rack_fraction
                    if self.rack_fraction > 0 else math.inf)
        lam_node = (self.mttf_steps / (1.0 - self.rack_fraction)
                    if self.rack_fraction < 1 else math.inf)
        return np.asarray([lam_rack] * self.n_racks
                          + [lam_node] * self.n_nodes, np.float64)

    def sample(self, n_steps: int,
               rng: np.random.Generator | int = 0) -> FailureTrace:
        """Sample one realization: per-node alive matrix + event list.

        Deterministic per ``rng`` seed.  Discrete-time: each step every
        *up* entity draws against its Weibull hazard
        ``h(age) = (k/λ)·(age/λ)^(k-1)`` (cascade-scaled while any
        repair pends); a failing entity goes down for a lognormal
        duration and its age restarts at repair.
        """
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        k, lam = self.weibull_k, self._hazards()
        racks = self.rack_members()
        n_ent = self.n_racks + self.n_nodes
        members = ([tuple(int(i) for i in r) for r in racks]
                   + [(i,) for i in range(self.n_nodes)])
        age = np.zeros(n_ent, np.float64)
        down_until = np.zeros(n_ent, np.int64)   # exclusive repair end
        alive = np.ones((n_steps, self.n_nodes), bool)
        events: List[FailureEvent] = []
        for t in range(n_steps):
            down = down_until > t
            # Weibull hazard of the current age (age+1: the draw covers
            # surviving this step), zero for immortal (λ=∞) entities.
            with np.errstate(divide="ignore", invalid="ignore"):
                h = (k / lam) * ((age + 1.0) / lam) ** (k - 1.0)
            h = np.where(np.isfinite(h), h, 0.0)
            if down.any():
                h = h * self.cascade_factor
            fail = (~down) & (rng.random(n_ent) < -np.expm1(-h))
            for e in np.flatnonzero(fail):
                dur = max(1, int(round(float(
                    rng.lognormal(self.repair_mu, self.repair_sigma)))))
                down_until[e] = t + dur
                age[e] = 0.0
                events.append(FailureEvent(
                    step=t, kind="rack" if e < self.n_racks else "node",
                    entity=int(e if e < self.n_racks else e - self.n_racks),
                    members=members[e], repair_end=t + dur))
            down = down_until > t
            age[~down] += 1.0
            dead = np.zeros(self.n_nodes, bool)
            for e in np.flatnonzero(down):
                dead[list(members[e])] = True
            alive[t] = ~dead
        return FailureTrace(alive=alive, events=events)

    def alive_counts(self, n_steps: int,
                     rng: np.random.Generator | int = 0) -> np.ndarray:
        """Floored per-step alive-node counts ``[S]`` (int)."""
        counts = self.sample(n_steps, rng).alive.sum(-1)
        return np.maximum(counts, self.alive_floor).astype(np.int32)

    def alive_fraction(self, n_steps: int,
                       rng: np.random.Generator | int = 0) -> np.ndarray:
        """Floored alive fraction ``[S]`` in (0, 1] — the ``TraceFn``
        shape ``Scenario.nodes`` consumes (the scenario re-quantizes to
        its own fleet size through ``elastic.shrink_mesh_plan``)."""
        return self.alive_counts(n_steps, rng) / float(self.n_nodes)

    def node_schedule(self, n_steps: int,
                      rng: np.random.Generator | int = 0) -> np.ndarray:
        """Usable-node schedule ``[S]`` per the availability contract:
        ``int32``, ``alive_floor ≤ avail ≤ n_nodes`` — feed it straight
        to ``simulate_fleet_stream(avail=...)`` or a campaign cell."""
        return self.alive_counts(n_steps, rng)

    def nodes_fn(self, mttf_frac: Optional[float] = None
                 ) -> Callable[[int, np.random.Generator], np.ndarray]:
        """Wrap the model as a ``Scenario.nodes`` builder.

        ``mttf_frac`` optionally rescales ``mttf_steps`` to a fraction
        of the *requested* trace length, so short CI traces and long
        campaigns see comparably many failure windows.
        """
        def build(n: int, rng: np.random.Generator) -> np.ndarray:
            model = self
            if mttf_frac is not None:
                model = dataclasses.replace(
                    self, mttf_steps=max(n * mttf_frac, 2.0))
            return model.alive_fraction(n, rng)

        return build
