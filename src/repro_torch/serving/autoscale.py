"""DVFS-integrated serving autoscaler — the paper's controller driving a
serving fleet (port of ``repro.serving.autoscale``).

Per control interval τ the simulator counts offered load, predicts the
next τ's load with the configured predictor, picks the frequency level
for the predicted bin plus the margin, and looks up the jointly optimal
(V_core, V_hbm) for it in the operating table built from the model's
roofline terms; it integrates modeled chip power and tracks QoS.  The
baselines (power gating, core-only, hbm-only, DFS, hybrid) share the loop,
exactly as in :mod:`repro_torch.core.controller`.  ``run_trace`` runs the
loop over a given occupancy trace; ``run_request_load`` closes it through
a :class:`~repro_torch.serving.batching.ContinuousBatcher`, whose
throughput the selected operating point sets, so occupancy and request
latency respond to the controller's decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import controller as ctl
from repro_torch.core import predictors as pred_mod
from repro_torch.core import scheduler as sched_mod
from repro_torch.device import resolve_device
from repro_torch.serving.batching import ContinuousBatcher, Request


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Seconds per step from the compiled dry-run (analysis.roofline)."""
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def alpha_tpu(self) -> float:
        """Memory-vs-compute share — the paper's α transplanted."""
        return self.t_memory / max(self.t_compute, 1e-12)


@dataclasses.dataclass
class DvfsServingSimulator:
    """Serving simulation with the paper's controller.

    ``device`` follows the port's rule and is resolved when a run starts:
    ``None`` is the CUDA card (and raises without one), ``"cpu"`` the
    plain path.
    """

    terms: RooflineTerms
    technique: str = "proposed"
    n_chips: int = 8
    steps_per_tau: int = 32
    controller_cfg: Optional[ctl.ControllerConfig] = None
    watts_nominal: float = 200.0
    device: Optional[str] = None

    def __post_init__(self):
        self.platform = ctl.tpu_platform(
            self.terms.t_compute, self.terms.t_memory,
            self.terms.t_collective, watts_nominal=self.watts_nominal)
        self.cfg = self.controller_cfg or ctl.ControllerConfig(
            technique=self.technique, n_nodes=self.n_chips)

    def run_trace(self, occupancy_trace: np.ndarray) -> ctl.Summary:
        """Run the §V loop over a per-τ occupancy trace."""
        res = ctl.simulate(self.platform, self.cfg, occupancy_trace,
                           device=self.device)
        return ctl.summarize(self.platform, self.cfg, occupancy_trace, res)

    def run_request_load(self, arrival_rate_per_step: np.ndarray,
                         batch_size: int = 64,
                         mean_new_tokens: int = 64,
                         seed: int = 0,
                         closed_loop: bool = True,
                         workload_signal: str = "occupancy",
                         node_schedule: Optional[np.ndarray] = None,
                         tenants: Optional[sched_mod.TenantSpec] = None
                         ) -> Dict[str, object]:
        """Drive a ContinuousBatcher from a Poisson request process with
        the §V controller in the loop.

        Each control interval τ (``steps_per_tau`` decode steps) the
        measured workload signal feeds the configured predictor, and the
        selected operating point's delivered throughput,
        ``f_rel · n_active/n_nodes``, sets ``ContinuousBatcher.step``'s
        throughput for the next interval.  ``closed_loop=False`` runs the
        batcher at nominal throughput (still capped at ``avail/n_chips``
        by dead chips) while integrating modeled power.

        ``workload_signal`` is what the controller bins each τ:
        ``"occupancy"`` (mean busy-slot fraction), ``"demand"``
        (occupancy plus queued requests per slot, clipped to 1) or
        ``"arrival"`` (tokens submitted this τ / peak decode tokens).

        ``node_schedule`` is an optional per-τ usable-chip count (entries
        in ``[1, n_chips]``; a total outage cannot drain the batcher and
        is refused): each τ the selected bin's ``n_active`` is clamped to
        the survivors through ``controller.availability_point``, the
        batcher's throughput scales by ``n_act/n_nodes`` and dead chips
        draw nothing.  The schedule holds its last value through the
        drain.

        When the arrivals end, the batcher drains at the final operating
        point, bounded by the remaining tokens at that throughput; the
        trailing partial τ is folded in at fractional weight.

        ``tenants`` assigns each request a tenant class with probability
        proportional to ``share`` (from a stream of its own, seeded
        ``seed + 0x7E4A47``, so the arrival process is the single-tenant
        run's), admits the highest ``priority`` first, and adds per-class
        latency percentiles and counts to the result.

        The predictor state is one cell on the simulator's device; each τ
        costs one predict, one observe and one readback.  Returns the
        :class:`~repro_torch.core.controller.Summary` (latency p50/p99 in
        decode steps, percentiles taken in float64 on the host) plus
        per-τ arrays, τ weights and token and drain accounting.
        """
        if workload_signal not in ("occupancy", "demand", "arrival"):
            raise ValueError(f"unknown workload_signal {workload_signal!r};"
                             " choose 'occupancy', 'demand', or 'arrival'")
        dev = resolve_device(self.device)
        rng = np.random.default_rng(seed)
        batcher = ContinuousBatcher(batch_size=batch_size)
        tenant_shares = None
        if tenants is not None:
            n_ten = tenants.n_tenants
            share = _host(tenants.share).reshape(n_ten)
            share = share * (_host(tenants.active).reshape(n_ten) > 0)
            if share.sum() <= 0:
                raise ValueError("tenants must have at least one active "
                                 "class with share > 0")
            tenant_shares = share / share.sum()
            prio = _host(tenants.priority).reshape(n_ten)
            batcher.tenant_priority = {t: float(prio[t])
                                       for t in range(n_ten)}
            # Class draws come from a stream of their own, so the arrival
            # process stays bit-identical to the single-tenant run.
            rng_tenant = np.random.default_rng(seed + 0x7E4A47)
        flat = ctl.build_bin_tables(self.platform, self.cfg, device=dev)
        tables = ctl.BinTables(*[x[None] for x in flat])   # one cell
        f_rel = flat.f_rel.cpu().numpy()
        pcfg = self.cfg.predictor
        n_nodes = self.cfg.n_nodes
        sched = None
        if node_schedule is not None:
            sched = np.asarray(node_schedule, np.float64)
            if sched.size == 0:
                raise ValueError("node_schedule must be non-empty")
            if (sched < 1.0).any():
                # A total outage cannot drain the batcher (throughput 0);
                # model full-fleet loss with the modeled loop's avail=.
                raise ValueError("node_schedule entries must be >= 1 "
                                 "usable chip (the serving co-simulation "
                                 "cannot drain a total outage)")
            sched = np.minimum(sched, n_nodes)

        def avail_at(i: int) -> float:
            """Usable chips during control interval ``i`` (the last
            schedule entry once the trace outlives the schedule)."""
            if sched is None:
                return float(n_nodes)
            return float(sched[min(i, len(sched) - 1)])

        def select(state, avail: float):
            """Predict the next τ's bin and price it at ``avail`` chips
            through ``controller.availability_point``: ``(bin,
            throughput, capacity, watts)`` after one readback."""
            pred = pred_mod.predict(pcfg, state)
            n_act, cap, pwr = ctl.availability_point(
                tables, pred, torch.tensor([avail], device=dev))
            p, n, c, w = torch.stack(
                [pred.to(cap.dtype), n_act, cap, pwr]).view(-1).tolist()
            thr = float(f_rel[int(p)]) * n / n_nodes
            return pred, int(p), thr, c, w

        mstate = pred_mod.init_state(pcfg, 1, dev)
        tau_idx = 0
        avail_now = avail_at(tau_idx)
        pred_t, predicted, thr_now, cap_now, pwr_now = select(mstate,
                                                               avail_now)

        def batcher_throughput() -> float:
            """Open loop ignores the controller's throttle but not dead
            chips, which cap throughput at avail/n_nodes."""
            return thr_now if closed_loop else avail_now / n_nodes

        f_now = batcher_throughput()
        occ_tau, f_tau, thr_tau, power_tau, viol_tau = [], [], [], [], []
        workload_tau, arrival_tau, avail_tau = [], [], []
        tau_weights = []  # 1.0 per full τ; < 1 for the trailing partial
        queued, interval_occ, interval_queue = [], [], []
        interval_tokens = [0]  # tokens submitted during the current τ
        n_ctrl_tau = 0    # τ intervals where the controller re-selected

        def step_once():
            stats = batcher.step(throughput=f_now)
            interval_occ.append(stats["occupancy"])
            interval_queue.append(stats["queued"])
            queued.append(stats["queued"])

        def close_interval(update_controller: bool) -> None:
            """τ boundary: fold the interval (full or partial) into the
            counters; optionally train the predictor, advance the node
            schedule and re-select the operating point."""
            nonlocal mstate, pred_t, predicted, f_now, n_ctrl_tau
            nonlocal tau_idx, avail_now, thr_now, cap_now, pwr_now
            occ = float(np.mean(interval_occ))
            # QoS is backlog-aware: busy slots plus queued requests per
            # slot against the delivered capacity.
            backlog_slots = float(np.mean(interval_queue)) / batch_size
            arrival_frac = min(interval_tokens[0]
                               / (len(interval_occ) * batch_size), 1.0)
            signal = {"occupancy": occ,
                      "demand": min(occ + backlog_slots, 1.0),
                      "arrival": arrival_frac}[workload_signal]
            occ_tau.append(occ)
            workload_tau.append(signal)
            arrival_tau.append(arrival_frac)
            avail_tau.append(avail_now)
            f_tau.append(float(f_rel[predicted]) if closed_loop else 1.0)
            thr_tau.append(f_now)
            power_tau.append(pwr_now)
            viol_tau.append(occ + backlog_slots > cap_now + 1e-9)
            tau_weights.append(len(interval_occ) / self.steps_per_tau)
            interval_occ.clear()
            interval_queue.clear()
            interval_tokens[0] = 0
            if update_controller:
                n_ctrl_tau += 1
                mstate = pred_mod.observe(
                    pcfg, mstate,
                    torch.tensor([signal], dtype=torch.float32, device=dev),
                    pred_t)
                tau_idx += 1
                avail_now = avail_at(tau_idx)
                pred_t, predicted, thr_now, cap_now, pwr_now = select(
                    mstate, avail_now)
                f_now = batcher_throughput()

        rid = 0
        offered_tokens = 0
        for lam in arrival_rate_per_step:
            for _ in range(rng.poisson(lam)):
                n_tok = max(1, int(rng.exponential(mean_new_tokens)))
                ten = (int(rng_tenant.choice(len(tenant_shares),
                                             p=tenant_shares))
                       if tenant_shares is not None else 0)
                batcher.submit(Request(rid=rid, prompt_len=128,
                                       max_new_tokens=n_tok, tenant=ten))
                offered_tokens += n_tok
                interval_tokens[0] += n_tok
                rid += 1
            step_once()
            if len(interval_occ) == self.steps_per_tau:
                close_interval(update_controller=True)

        # Drain at the final operating point: every submitted request
        # finishes, bounded by the remaining tokens at f_now (each step at
        # least one active slot decodes f_now tokens).
        pending = (sum(r.max_new_tokens - min(r.decoded, r.max_new_tokens)
                       for r in batcher.slots if r is not None)
                   + sum(r.max_new_tokens for r in batcher.queue))
        max_drain = (int(np.ceil(pending / max(f_now, 1e-6)))
                     + len(batcher.queue) + batch_size + 1)
        drain_steps = 0
        while not batcher.drained() and drain_steps < max_drain:
            step_once()
            drain_steps += 1
            if len(interval_occ) == self.steps_per_tau:
                close_interval(update_controller=False)
        if interval_occ:
            # Trailing partial τ, at fractional weight.
            close_interval(update_controller=False)

        lat = np.asarray([r.finished_step - r.arrived_step
                          for r in batcher.finished], np.float64)
        p50 = float(np.percentile(lat, 50)) if lat.size else float("nan")
        p99 = float(np.percentile(lat, 99)) if lat.size else float("nan")
        tenant_stats = None
        if tenants is not None:
            n_ten = tenants.n_tenants
            t_lat = [[] for _ in range(n_ten)]
            for r in batcher.finished:
                t_lat[r.tenant].append(r.finished_step - r.arrived_step)
            t_sub = [0] * n_ten
            for r in (list(batcher.finished) + list(batcher.queue)
                      + [s for s in batcher.slots if s is not None]):
                t_sub[r.tenant] += 1

            def pct(x, q):
                return (float(np.percentile(np.asarray(x, np.float64), q))
                        if x else float("nan"))

            tenant_stats = {
                "tenant_latency_p50": [pct(x, 50) for x in t_lat],
                "tenant_latency_p99": [pct(x, 99) for x in t_lat],
                "tenant_submitted": t_sub,
                "tenant_completed": [len(x) for x in t_lat],
            }
        served_tokens = (sum(min(r.decoded, r.max_new_tokens)
                             for r in batcher.finished)
                         + sum(min(s.decoded, s.max_new_tokens)
                               for s in batcher.slots if s is not None))
        node_nom_w = (ctl.nominal_node_watts(self.platform)
                      + ctl.pll_standing_watts(self.cfg))
        nominal_cfg_w = node_nom_w * self.cfg.n_nodes
        wts = np.asarray(tau_weights)
        mean_avail = (float(np.average(avail_tau, weights=wts)) if avail_tau
                      else float(n_nodes))
        nominal_w = node_nom_w * mean_avail
        mean_w = (float(np.average(power_tau, weights=wts)) if power_tau
                  else nominal_w)
        n_scored = max(n_ctrl_tau - pcfg.warmup_steps, 1)
        summary = ctl.Summary(
            technique=self.cfg.technique,
            mean_power_w=mean_w,
            nominal_power_w=nominal_w,
            power_gain=nominal_w / mean_w,
            qos_violation_rate=(float(np.average(viol_tau, weights=wts))
                                if viol_tau else 0.0),
            served_fraction=served_tokens / max(offered_tokens, 1),
            misprediction_rate=int(mstate.mispredictions[0]) / n_scored,
            mean_backlog=float(np.mean(queued)) / batch_size,
            margin_misprediction_rate=(int(mstate.margin_misses[0])
                                       / n_scored),
            latency_p50=p50,
            latency_p99=p99,
            nominal_power_configured_w=nominal_cfg_w,
            power_gain_vs_configured=nominal_cfg_w / mean_w,
        )
        out = {"summary": summary,
               "occupancy_tau": np.asarray(occ_tau),
               "workload_tau": np.asarray(workload_tau),
               "arrival_fraction_tau": np.asarray(arrival_tau),
               "avail_tau": np.asarray(avail_tau),
               "workload_signal": workload_signal,
               "f_rel_tau": np.asarray(f_tau),
               "throughput_tau": np.asarray(thr_tau),
               "power_tau": np.asarray(power_tau),
               "tau_weights": wts,
               "latency_p50": p50, "latency_p99": p99,
               "completed": len(batcher.finished),
               "submitted": rid,
               "offered_tokens": offered_tokens,
               "served_tokens": served_tokens,
               "drain_steps": drain_steps}
        if tenant_stats is not None:
            out.update(tenant_stats)
        return out

    def workload_trace_source(self, result: Dict[str, object],
                              name: str = "request_driven"):
        """A :meth:`run_request_load` result's measured per-τ workload as
        a replayable :class:`repro_torch.core.traces.TraceSource` sampled
        every ``cfg.tau`` seconds (register it with
        ``scenarios.register_replay`` or blend it with ``traces.mix``)."""
        from repro_torch.core import traces
        return traces.from_serving(result, name=name,
                                   interval_s=self.cfg.tau)


def _host(x) -> np.ndarray:
    """A tenant-spec leaf (numpy or tensor) as a float64 host array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float64)


def compare_techniques(terms: RooflineTerms, trace: np.ndarray,
                       n_chips: int = 8,
                       techniques=("proposed", "core_only", "bram_only",
                                   "freq_only", "power_gating", "hybrid"),
                       device=None) -> Dict[str, ctl.Summary]:
    """Paper Table II on the serving platform (modeled power), through the
    fused fleet path: one table sweep and one step loop for all
    techniques."""
    platform = ctl.tpu_platform(terms.t_compute, terms.t_memory,
                                terms.t_collective)
    out = ctl.compare_all_batched([platform], trace, techniques=techniques,
                                  n_nodes=n_chips, device=device)
    return out[platform.name]
