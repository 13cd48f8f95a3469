"""Straggler mitigation — DVFS-aware weighted work rebalancing (port of
``repro.runtime.straggler``, numpy only, unchanged).

The paper's controller slows chips when load is low; conversely, a chip
that *must* run slow (thermal throttling, a failing HBM stack, a shared
host) drags every synchronous collective down to its pace.  The mitigator
keeps an EMA of per-node step times and recomputes each node's share of
the global batch so all nodes finish together; shares are quantized to
the microbatch granularity.  It also flags persistent stragglers for
eviction (feeding ``runtime.fault``/``elastic``).

This couples to the DVFS controller: a node ordered to (V_low, f_low) by
the energy policy reports its *intended* speed, so intentional slowdowns
re-balance work instead of tripping the eviction heuristic.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class StragglerMitigator:
    n_nodes: int
    ema: float = 0.8
    evict_threshold: float = 2.0   # ×median speed, sustained
    evict_patience: int = 5
    granularity: int = 1           # batch shares quantized to this

    def __post_init__(self):
        self._speed = np.ones(self.n_nodes)        # relative throughput
        self._slow_count = np.zeros(self.n_nodes, int)
        self._intended = np.ones(self.n_nodes)     # DVFS-ordered speed

    def set_intended_speed(self, node: int, f_rel: float):
        """DVFS controller hook: node is *meant* to run at f_rel."""
        self._intended[node] = max(f_rel, 1e-3)

    def observe(self, step_times: np.ndarray):
        """Fold one step's per-node wall times into the speed EMA."""
        speed = 1.0 / np.maximum(step_times, 1e-9)
        speed = speed / speed.max()
        self._speed = self.ema * self._speed + (1 - self.ema) * speed
        # normalize by intention: intentional slowness is not straggling
        effective = self._speed / self._intended
        med = np.median(effective)
        slow = effective < med / self.evict_threshold
        self._slow_count = np.where(slow, self._slow_count + 1, 0)

    def shares(self, global_batch: int) -> List[int]:
        """Per-node batch shares ∝ speed, quantized, summing exactly."""
        w = self._speed / self._speed.sum()
        g = self.granularity
        units = global_batch // g
        raw = w * units
        base = np.floor(raw).astype(int)
        rem = units - base.sum()
        order = np.argsort(-(raw - base))
        base[order[:rem]] += 1
        return list(base * g)

    def evictions(self) -> List[int]:
        return [int(i) for i in
                np.where(self._slow_count >= self.evict_patience)[0]]

    def speeds(self) -> np.ndarray:
        return self._speed.copy()
