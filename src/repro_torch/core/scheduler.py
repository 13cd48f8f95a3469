"""Multi-tenant scheduling of the §V control step (port of
``repro.core.scheduler``): tenant classes, the scheduler registry and the
per-step scheduling math ``controller._control_step`` calls.

Every function takes tensors with a leading cell axis ``[K]`` and a
trailing tenant axis ``[..., T]``; the scheduler's knobs ride as the
``[3]`` value vector of :func:`scheduler_values`, and both branches are
computed and blended by value, as in the JAX package.  With the
scheduler off and one default tenant, :func:`schedule_step` reproduces
the aggregate controller bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

#: Guard for divisions by (possibly zero) demand/capacity totals.
EPS = 1e-9

_POLICIES = ("priority", "fair")


class TenantSpec(NamedTuple):
    """Per-tenant QoS classes along a trailing tenant axis ``[..., T]``.

    ``priority`` orders admission (higher first); ``latency_target`` is
    the backlog a tenant tolerates in steps of its own ``share`` of
    demand; ``active`` masks padding slots (1.0 real, 0.0 pad).
    """

    priority: torch.Tensor
    latency_target: torch.Tensor
    share: torch.Tensor
    active: torch.Tensor

    @property
    def n_tenants(self) -> int:
        return int(self.priority.shape[-1])

    def slack(self) -> torch.Tensor:
        """Tolerated backlog per tenant in work units (fleet-peak·τ)."""
        return self.latency_target * self.share

    def to(self, device) -> "TenantSpec":
        return TenantSpec(*[torch.as_tensor(x, dtype=torch.float32).to(device)
                            for x in self])


def make_tenants(priority: Sequence[float], latency_target: Sequence[float],
                 share: Sequence[float]) -> TenantSpec:
    """A validated ``[T]`` spec (numpy leaves); ``share`` is normalized."""
    pr = np.asarray(list(priority), np.float32)
    lt = np.asarray(list(latency_target), np.float32)
    sh = np.asarray(list(share), np.float64)
    if not (pr.shape == lt.shape == sh.shape) or pr.ndim != 1 or pr.size == 0:
        raise ValueError("priority/latency_target/share must be equal-length "
                         f"non-empty 1-D sequences, got {pr.shape}, "
                         f"{lt.shape}, {sh.shape}")
    if (lt < 0).any():
        raise ValueError("latency_target entries must be >= 0 steps")
    if (sh < 0).any() or sh.sum() <= 0:
        raise ValueError("share entries must be >= 0 with a positive sum")
    sh = (sh / sh.sum()).astype(np.float32)
    return TenantSpec(priority=pr, latency_target=lt, share=sh,
                      active=np.ones_like(pr))


def default_tenants(n: int = 1) -> TenantSpec:
    """``n`` interchangeable tenants: equal priority/share, no slack."""
    if n < 1:
        raise ValueError(f"need at least one tenant (got {n})")
    return make_tenants([1.0] * n, [0.0] * n, [1.0 / n] * n)


def pad_tenants(spec: TenantSpec, n_tenants: int) -> TenantSpec:
    """Pad a ``[T]`` spec with inert slots up to ``n_tenants``: zero share,
    priority −1, masked out of every QoS reduction (how tenant counts sweep
    at one width)."""
    t = spec.n_tenants
    if n_tenants < t:
        raise ValueError(f"cannot pad {t} tenants down to {n_tenants}")
    if n_tenants == t:
        return spec
    pad = n_tenants - t
    return TenantSpec(
        priority=np.concatenate([np.asarray(spec.priority, np.float32),
                                 np.full(pad, -1.0, np.float32)]),
        latency_target=np.concatenate(
            [np.asarray(spec.latency_target, np.float32),
             np.zeros(pad, np.float32)]),
        share=np.concatenate([np.asarray(spec.share, np.float32),
                              np.zeros(pad, np.float32)]),
        active=np.concatenate([np.asarray(spec.active, np.float32),
                               np.zeros(pad, np.float32)]))


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduler selection; its runtime knobs become a value vector."""

    name: str = "none"
    enabled: bool = False
    policy: str = "priority"     # admission order: "priority" | "fair"
    #: Capacity fraction lost when a tenant's node share grows by one node.
    migration_cost: float = 0.02

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown scheduler policy {self.policy!r}; "
                             f"choose from {_POLICIES}")
        if self.migration_cost < 0:
            raise ValueError(f"migration_cost {self.migration_cost} "
                             "must be >= 0")


SCHEDULERS: Dict[str, SchedulerConfig] = {
    "none": SchedulerConfig(name="none", enabled=False),
    "priority": SchedulerConfig(name="priority", enabled=True,
                                policy="priority"),
    "fair_share": SchedulerConfig(name="fair_share", enabled=True,
                                  policy="fair"),
}


def available() -> Tuple[str, ...]:
    return tuple(sorted(SCHEDULERS))


def get(name: str) -> SchedulerConfig:
    if name not in SCHEDULERS:
        raise KeyError(f"unknown scheduler {name!r}; "
                       f"registered: {available()}")
    return SCHEDULERS[name]


def as_config(scheduler: Union[str, SchedulerConfig, None]) -> SchedulerConfig:
    """Coerce a name / config / None to a :class:`SchedulerConfig`."""
    if scheduler is None:
        return SCHEDULERS["none"]
    if isinstance(scheduler, str):
        return get(scheduler)
    if isinstance(scheduler, SchedulerConfig):
        return scheduler
    raise TypeError(f"cannot use {type(scheduler).__name__} as a scheduler "
                    "(want a registered name or a SchedulerConfig)")


def scheduler_values(cfg: SchedulerConfig, device=None) -> torch.Tensor:
    """``[enabled, priority_policy, migration_cost]`` as a float32 tensor."""
    return torch.tensor([1.0 if cfg.enabled else 0.0,
                         1.0 if cfg.policy == "priority" else 0.0,
                         float(cfg.migration_cost)],
                        dtype=torch.float32, device=device)


def div_static(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` for a static ``n`` as the JAX package's compiled programs
    compute it: XLA rewrites a division by a constant into a multiplication
    by its float32 reciprocal (``(9 + 1) / 25`` gives 0.39999998, not 0.4).
    Where the quotient meets a floor or a threshold, that last bit decides
    a bin."""
    return x * float(np.float32(1.0) / np.float32(n))


def provision_bin(spec: TenantSpec, predicted_bin: torch.Tensor,
                  backlog_t: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Scheduler-shaped workload bin ``[K]``: defer slack-tolerant demand,
    pull forward backlog beyond a tenant's tolerance, re-bin."""
    w_hat = div_static(predicted_bin.float() + 1.0, n_bins)
    d_hat = (w_hat[..., None] * spec.share + backlog_t) * spec.active
    # Defer at most 80 % of each tenant's slack (a stable parking level
    # with 20 % headroom against workload noise).
    defer = torch.minimum(d_hat, 0.8 * spec.slack()) * spec.active
    target = torch.clamp((d_hat - defer).sum(-1), 0.0, 1.0)
    return torch.clamp(torch.floor(target * n_bins).long(), 0, n_bins - 1)


def opportunistic_bin(power_tab: torch.Tensor, capacity_tab: torch.Tensor,
                      shaped: torch.Tensor,
                      deferred_backlog: torch.Tensor) -> torch.Tensor:
    """Valley-fill: jump to the tables' cheapest watts-per-work bin when
    parked backlog fills the capacity gap.  Tables are ``[K, M]``."""
    eff = power_tab / torch.clamp(capacity_tab, min=EPS)
    b_star = eff.argmin(-1)
    cap_star = capacity_tab.gather(-1, b_star[:, None])[:, 0]
    cap_shaped = capacity_tab.gather(-1, shaped[:, None])[:, 0]
    take = (deferred_backlog >= cap_star - cap_shaped) & (b_star > shaped)
    return torch.where(take, b_star, shaped)


class SchedStep(NamedTuple):
    """Per-tenant outcome of one scheduling step (all ``[K, T]``)."""

    served: torch.Tensor
    backlog: torch.Tensor
    place: torch.Tensor
    violation: torch.Tensor
    starved: torch.Tensor


def _priority_fill(cap: torch.Tensor, d: torch.Tensor, order: torch.Tensor,
                   inverse: torch.Tensor) -> torch.Tensor:
    """Serve ``d`` in ``order`` until ``cap`` runs out (cumulative waterfill)."""
    d_sorted = d.gather(-1, order)
    cum_before = d_sorted.cumsum(-1) - d_sorted
    fill = torch.minimum(torch.clamp(cap[..., None] - cum_before, min=0.0),
                         d_sorted)
    return fill.gather(-1, inverse)


def schedule_step(spec: TenantSpec, sched: torch.Tensor, d: torch.Tensor,
                  cap: torch.Tensor, n_act: torch.Tensor,
                  place_prev: torch.Tensor) -> SchedStep:
    """Allocate one step's delivered capacity ``cap`` ``[K]`` across
    tenants with demand ``d`` ``[K, T]`` (offered work + backlog).

    Scheduler on: slack-deferred work parks as backlog, admitted demand
    goes through a priority waterfill (or a proportional ``fair`` split),
    spare capacity drains deferred work, and node-share growth pays a
    migration charge.  Scheduler off: each tenant gets its
    demand-proportional share of ``min(cap, Σd)`` — the identity for one
    tenant, so aggregate callers reproduce the plain loop bit for bit.
    """
    on, use_prio, mig = sched[0], sched[1], sched[2]
    cap_t = cap[..., None]
    d = d * spec.active
    total = d.sum(-1, keepdim=True)
    served_total = torch.minimum(cap_t, total)
    ratio = d / torch.clamp(total, min=EPS)
    prop = torch.where(total > EPS, served_total * ratio,
                       torch.minimum(cap_t, d))

    d_adm = d - torch.minimum(d, 0.8 * spec.slack()) * spec.active
    adm_total = d_adm.sum(-1, keepdim=True)

    prio_eff = spec.priority - 1e9 * (1.0 - spec.active)
    order = torch.argsort(-prio_eff, dim=-1, stable=True).expand_as(d)
    inverse = torch.argsort(order, dim=-1, stable=True)
    water = _priority_fill(cap, d_adm, order, inverse)
    fair = (torch.minimum(cap_t, adm_total) * d_adm
            / torch.clamp(adm_total, min=EPS))
    alloc = torch.where(use_prio > 0, water, fair)

    # Capacity left after every admitted demand flows to deferred work.
    deferred = d - d_adm
    spare = torch.clamp(cap - alloc.sum(-1), min=0.0)
    drain_prio = _priority_fill(spare, deferred, order, inverse)
    def_total = deferred.sum(-1, keepdim=True)
    drain_fair = (torch.minimum(spare[..., None], def_total) * deferred
                  / torch.clamp(def_total, min=EPS))
    alloc = alloc + torch.where(use_prio > 0, drain_prio, drain_fair)

    # Sticky capacity-proportional placement with a quarter-node deadband;
    # only growth beyond it pays migration.
    n_act_t = n_act[..., None]
    needed = n_act_t * alloc / torch.clamp(cap_t, min=EPS)
    grow = torch.clamp(needed - place_prev - 0.25, min=0.0)
    mig_loss = mig * grow * cap_t / torch.clamp(n_act_t, min=1.0)
    served_sched = torch.clamp(alloc - mig_loss, min=0.0)
    place = torch.maximum(needed, place_prev * 0.95)

    served = torch.where(on > 0, served_sched, prop)
    backlog = torch.where(on > 0, d - served_sched, d - prop)
    place_out = torch.where(on > 0, place, place_prev)
    violation = (backlog > spec.slack() + 1e-9) & (spec.active > 0)
    starved = (d > 1e-6) & (served <= 1e-9) & (spec.active > 0)
    return SchedStep(served=served, backlog=backlog, place=place_out,
                     violation=violation, starved=starved)
