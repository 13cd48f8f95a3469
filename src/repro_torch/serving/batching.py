"""Continuous batching over a slotted decode batch (port of
``repro.serving.batching``, pure Python).

A fixed-size decode batch is treated as ``batch_size`` slots; finished
sequences free their slot, queued requests claim free slots (their prompt
is prefilled into the slot's cache region).  The batcher tracks per-step
*occupancy* — the platform workload signal that drives the DVFS
controller: occupancy == fraction of peak decode throughput in use.

This module is deliberately simulation-friendly: ``step()`` advances one
decode step and returns occupancy; the autoscaler aggregates occupancy
over the control interval τ and sets the modeled (V_core, V_hbm, f) for
the next interval — the paper's runtime loop on a serving engine.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrived_step: int = 0
    started_step: Optional[int] = None
    finished_step: Optional[int] = None
    decoded: int = 0
    #: Tenant class index (0 in single-tenant runs) — the serving twin
    #: of the fleet engine's tenant axis.
    tenant: int = 0


@dataclasses.dataclass
class ContinuousBatcher:
    batch_size: int
    queue: Deque[Request] = dataclasses.field(default_factory=deque)
    slots: List[Optional[Request]] = dataclasses.field(default_factory=list)
    step_idx: int = 0
    finished: List[Request] = dataclasses.field(default_factory=list)
    #: Optional tenant-class → priority map: when set, free slots admit
    #: the highest-priority queued request (FIFO within a class — the
    #: serving twin of the fleet scheduler's priority waterfill) instead
    #: of strict FIFO.  ``None`` keeps today's single-queue behavior.
    tenant_priority: Optional[Dict[int, float]] = None

    def __post_init__(self):
        if not self.slots:
            self.slots = [None] * self.batch_size

    def submit(self, req: Request):
        req.arrived_step = self.step_idx
        self.queue.append(req)

    def queued_by_tenant(self) -> Dict[int, int]:
        """Current queue depth per tenant class."""
        out: Dict[int, int] = {}
        for r in self.queue:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def _pop_next(self) -> Request:
        if not self.tenant_priority:
            return self.queue.popleft()
        best, best_p = 0, None
        for j, r in enumerate(self.queue):
            p = self.tenant_priority.get(r.tenant, 0.0)
            if best_p is None or p > best_p:
                best, best_p = j, p
        req = self.queue[best]
        del self.queue[best]
        return req

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                req = self._pop_next()
                req.started_step = self.step_idx
                self.slots[i] = req

    def step(self, throughput: float = 1.0) -> Dict[str, float]:
        """Advance one decode step at relative ``throughput`` ∈ (0, 1].

        With scaled frequency, a step completes ``throughput`` tokens per
        slot on average (modeled fractionally).
        """
        self._admit()
        active = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            active += 1
            req.decoded += throughput
            if req.decoded >= req.max_new_tokens:
                req.finished_step = self.step_idx
                self.finished.append(req)
                self.slots[i] = None
        # Slots freed by retirements are claimed immediately (continuous
        # batching): the queued request holds the slot from this step on
        # instead of idling until the next step's admission pass.
        self._admit()
        self.step_idx += 1
        return {
            "occupancy": active / self.batch_size,
            "queued": float(len(self.queue)),
            "active": float(active),
        }

    def drained(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
