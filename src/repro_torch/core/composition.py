"""Fleet-composition search: which platforms, how many nodes, under a
power or cost budget (port of ``repro.core.composition``).

A candidate is a node-count vector ``n`` over a platform catalog.  Demand
is a scenario trace ``w_t``, a fraction of a reference fleet's peak
(``budget.reference_nodes`` node-units).  The candidate serves it with
capacity ``cap = Σ_j n_j·thr_j`` split across its homogeneous sub-fleets
in proportion to their capacity, so every sub-fleet sees the utilization
``u_t = w_t·ref/cap`` of its own peak and runs the §V loop on it;
node-failure scenarios apply their availability fraction to every
sub-fleet.  The search returns per-scenario Pareto sets over (mean power,
QoS violation rate, cost).

On the device it is one table build (``fleet_bin_tables``: one
``grid_argmin`` launch on the card) and, for each half of the candidate
batch, one ``simulate_fleet_stream`` over ``[n, P, N_scen, M]`` tables.
Node counts enter as values: per-candidate tables differ only by
count-scaled power and count-valued ``n_active``, and each sub-fleet's
usable nodes are the scenario's availability fraction times its count.
Only the DVFS techniques qualify: their per-node operating points do not
depend on the fleet's node count (hybrid and power-gating gears quantize
on it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import characterization as char
from repro_torch.core import controller as ctl
from repro_torch.core import scenarios as scn
from repro_torch.device import resolve_device

#: Techniques whose per-node §V operating points do not depend on the
#: fleet's node count (no node-count gears, no active-set quantization).
COMPOSABLE_TECHNIQUES = ("proposed", "core_only", "bram_only", "freq_only")


@dataclasses.dataclass(frozen=True)
class CompositionBudget:
    """Feasibility gates and the demand reference of a search.

    ``w_t = 1.0`` means the full peak of ``reference_nodes`` reference
    nodes (throughput 1.0 each).  ``max_cost`` / ``max_power_w`` drop
    candidates whose build cost / nominal power exceed them before the
    sweep runs (``None``: unconstrained).
    """

    reference_nodes: float = 8.0
    max_cost: Optional[float] = None
    max_power_w: Optional[float] = None


class CompositionResult(NamedTuple):
    """Everything the Pareto report needs, all host numpy."""

    platform_names: Tuple[str, ...]
    scenario_names: Tuple[str, ...]
    candidates: np.ndarray          # [N, P] int node counts (budget-feasible)
    cost: np.ndarray                # [N] build cost (Σ n_j·cost_j)
    nominal_power_w: np.ndarray     # [N] nominal watts (Σ n_j·node_nom_j)
    total_power_w: np.ndarray       # [N, S] mean watts under each scenario
    qos_violation_rate: np.ndarray  # [N, S] capacity-weighted over sub-fleets
    served_fraction: np.ndarray     # [N, S]
    pareto: Dict[str, np.ndarray]   # scenario -> candidate indices of the
                                    #   Pareto set, sorted by mean power
    n_rejected: int                 # candidates dropped by the budget gates
    #: Fleet programs built during the second half of the batch (the sum
    #: of ``controller.fleet_trace_counts()``'s deltas), which reuses the
    #: first half's: must be 0.
    retraces_second_half: int


def enumerate_candidates(n_platforms: int, max_nodes: int,
                         n_candidates: int, seed: int = 0) -> np.ndarray:
    """``[N, P]`` node-count vectors in ``[0, max_nodes]``: the whole
    ``(max_nodes+1)^P`` lattice when it fits in ``n_candidates``, else
    unique random mixes; the all-zero fleet is excluded."""
    space = (max_nodes + 1) ** n_platforms
    if space <= n_candidates + 1:
        grid = np.indices((max_nodes + 1,) * n_platforms)
        cand = grid.reshape(n_platforms, -1).T
        return cand[cand.sum(axis=1) > 0].astype(np.int64)
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    while len(out) < n_candidates:
        draw = rng.integers(0, max_nodes + 1,
                            size=(n_candidates, n_platforms))
        for row in draw:
            key = tuple(int(x) for x in row)
            if sum(key) == 0 or key in seen:
                continue
            seen.add(key)
            out.append(key)
            if len(out) == n_candidates:
                break
    return np.asarray(out, np.int64)


def pareto_front(objectives: np.ndarray) -> np.ndarray:
    """Boolean mask of the non-dominated rows (every objective
    minimized): a row is dominated if another is ≤ on every objective and
    < on one."""
    a = objectives[:, None, :]
    b = objectives[None, :, :]
    dominated = ((b <= a).all(-1) & (b < a).any(-1)).any(axis=1)
    return ~dominated


def search_fleet_composition(
        platforms: Sequence[ctl.PlatformSpec],
        candidates: np.ndarray,
        scenarios: Optional[Sequence[str]] = None,
        budget: Optional[CompositionBudget] = None,
        *, technique: str = "proposed", n_steps: int = 2048,
        chunk_size: int = 512, seed: int = 0,
        node_cost: Optional[Sequence[float]] = None,
        node_throughput: Optional[Sequence[float]] = None,
        device=None, **cfg_kwargs) -> CompositionResult:
    """Sweep candidate fleet mixes × scenarios; return the Pareto sets.

    ``candidates`` is ``[N, P]`` node counts over ``platforms`` (see
    :func:`enumerate_candidates`); ``node_cost`` / ``node_throughput`` are
    per-platform vectors (1.0 a node by default).  The batch runs in two
    equal halves (an odd batch repeats its last candidate, dropped from
    the result); ``retraces_second_half`` counts the fleet programs the
    second half built (``controller.fleet_trace_counts()``'s deltas), as
    the JAX package counts its retraces, and is 0.  ``device`` follows the
    port's rule (``None`` is the card).
    """
    if technique not in COMPOSABLE_TECHNIQUES:
        raise ValueError(
            f"technique {technique!r} is not composition-safe: its "
            "per-node operating points depend on the fleet's node count "
            f"(choose from {COMPOSABLE_TECHNIQUES})")
    budget = CompositionBudget() if budget is None else budget
    counts = np.asarray(candidates, np.float32)
    if counts.ndim != 2 or counts.shape[1] != len(platforms):
        raise ValueError(f"candidates must be [N, {len(platforms)}] "
                         f"node counts; got {counts.shape}")
    if np.any(counts.sum(axis=1) <= 0):
        raise ValueError("candidates must keep at least one node")
    dev = resolve_device(device)

    n_plat = len(platforms)
    thr = (np.ones(n_plat, np.float32) if node_throughput is None
           else np.asarray(node_throughput, np.float32))
    cost_vec = (np.ones(n_plat, np.float32) if node_cost is None
                else np.asarray(node_cost, np.float32))
    params = char.stack_platform_params([p.params for p in platforms])
    cfg = ctl.ControllerConfig(technique=technique, **cfg_kwargs)
    node_nom_w = ctl.fleet_node_nominal_watts(params, cfg)     # [P]

    # Budget gates, on the host before anything reaches the device.
    cand_cost = counts @ cost_vec
    cand_nom_w = counts @ node_nom_w.astype(np.float32)
    keep = np.ones(counts.shape[0], bool)
    if budget.max_cost is not None:
        keep &= cand_cost <= budget.max_cost + 1e-9
    if budget.max_power_w is not None:
        keep &= cand_nom_w <= budget.max_power_w + 1e-9
    n_rejected = int((~keep).sum())
    counts, cand_cost, cand_nom_w = (counts[keep], cand_cost[keep],
                                     cand_nom_w[keep])
    if counts.shape[0] == 0:
        raise ValueError("no candidate passed the budget gates")

    # One table build gives every platform's per-node table [P, M].
    tabs = ctl.fleet_bin_tables(params, cfg, techniques=(technique,),
                                device=dev)
    per_node = {f: getattr(tabs, f)[:, 0] for f in tabs._fields}

    scen_names, scen_traces, scen_avail = scn.build_suite(
        scenarios, n_steps=n_steps, n_nodes=cfg.n_nodes, seed=seed)
    n_scen = len(scen_names)
    # Availability as a fraction of the configured fleet, so failure
    # scenarios hit every candidate's sub-fleets pro rata.
    frac_avail = (scen_avail / float(cfg.n_nodes)).astype(np.float32)

    # Each sub-fleet of candidate c sees utilization w_t·ref/cap_c.
    cap_c = counts @ thr                                       # [N]
    scale = (budget.reference_nodes / cap_c).astype(np.float32)

    n_real = counts.shape[0]
    if n_real % 2:
        counts = np.concatenate([counts, counts[-1:]])
        scale = np.concatenate([scale, scale[-1:]])
    half = counts.shape[0] // 2

    def run_half(counts_h: np.ndarray, scale_h: np.ndarray):
        n_h = counts_h.shape[0]
        cnt = torch.from_numpy(counts_h).to(dev)[:, :, None, None]
        shape = (n_h, n_plat, n_scen, cfg.n_bins)

        def cell(x):
            return x[None, :, None, :].expand(shape)

        cells = ctl.BinTables(
            capacity=cell(per_node["capacity"]),
            power=cell(per_node["node_power"]) * cnt,
            v_core=cell(per_node["v_core"]), v_bram=cell(per_node["v_bram"]),
            f_rel=cell(per_node["f_rel"]),
            # the tables' weak flag (controller.WeakLeaf), so that the
            # warmer's program, built from the tables' rows, is this one
            n_active=cnt.expand(shape).as_subclass(type(per_node["n_active"])),
            node_power=cell(per_node["node_power"]),
            gated_power=torch.zeros(shape, device=dev),
            headroom=torch.zeros(shape[:-1], device=dev))
        u = (scale_h[:, None, None, None]
             * scen_traces[None, None, :, :]).astype(np.float32)
        avail = (counts_h[:, :, None, None]
                 * frac_avail[None, None, :, :]).astype(np.float32)
        return ctl.simulate_fleet_stream(cells, u, cfg, chunk_size=chunk_size,
                                         avail=avail, device=dev)

    fs_a = run_half(counts[:half], scale[:half])
    before = ctl.fleet_trace_counts()
    fs_b = run_half(counts[half:], scale[half:])
    after = ctl.fleet_trace_counts()
    retraces = sum(after[k] - before[k] for k in after)

    def merge(field: str) -> np.ndarray:
        return np.concatenate([getattr(fs_a, field),
                               getattr(fs_b, field)])[:n_real]

    counts = counts[:n_real]
    mean_power = merge("mean_power_w")                  # [N, P, S]
    viol = merge("qos_violation_rate")
    served = merge("served_fraction")
    # Sub-fleet weights: capacity share (zero-count cells weigh nothing).
    w = (counts * thr[None, :]) / (counts @ thr)[:, None]      # [N, P]
    total_power = mean_power.sum(axis=1)                       # [N, S]
    qos = np.einsum("np,nps->ns", w, viol)
    served_w = np.einsum("np,nps->ns", w, served)

    pareto: Dict[str, np.ndarray] = {}
    for s, name in enumerate(scen_names):
        objs = np.stack([total_power[:, s], qos[:, s], cand_cost], axis=1)
        idx = np.flatnonzero(pareto_front(objs))
        pareto[name] = idx[np.argsort(total_power[idx, s])]

    return CompositionResult(
        platform_names=tuple(p.name for p in platforms),
        scenario_names=tuple(scen_names),
        candidates=counts.astype(np.int64), cost=cand_cost,
        nominal_power_w=cand_nom_w, total_power_w=total_power,
        qos_violation_rate=qos, served_fraction=served_w, pareto=pareto,
        n_rejected=n_rejected, retraces_second_half=int(retraces))
