"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Generates a learnable token stream — a noisy affine recurrence
``t_{i+1} = (a·t_i + b) mod V`` with replacement noise — so training
shows a falling loss without an external dataset.  numpy draws every
batch from one seeded generator in the reference's order, so a seed gives
the JAX package's batches bit for bit (``patches`` of the VLM family and
``features`` of the audio family included).  A background thread keeps
``prefetch`` batches ready.  Batches are host numpy arrays; the caller
moves them to its device.  ``make_batch_specs`` (dry-run tooling) stays
with the JAX package.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    noise: float = 0.05
    prefetch: int = 2


def _sample(rng: np.random.Generator, cfg: DataConfig) -> Dict[str, np.ndarray]:
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    a, c = 31, 17  # affine recurrence constants
    t0 = rng.integers(0, v, size=(b, 1))
    toks = [t0]
    for _ in range(s):
        nxt = (a * toks[-1] + c) % v
        noise = rng.integers(0, v, size=(b, 1))
        mask = rng.random((b, 1)) < cfg.noise
        toks.append(np.where(mask, noise, nxt))
    seq = np.concatenate(toks, axis=1).astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class SyntheticPipeline:
    """Iterator of host batches with background prefetch; ``close`` stops
    the thread."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self) -> Dict[str, np.ndarray]:
        batch = _sample(self._rng, self.cfg)
        mc = self.model_cfg
        if mc is not None and mc.family == "vlm":
            batch["patches"] = self._rng.standard_normal(
                (self.cfg.global_batch, mc.frontend_len, mc.frontend_dim)).astype(np.float32)
        if mc is not None and mc.family == "audio":
            feats = self._rng.standard_normal(
                (self.cfg.global_batch, self.cfg.seq_len, mc.frontend_dim)).astype(np.float32)
            batch = {"features": feats, "labels": batch["labels"]}
        return batch

    def _worker(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make(), timeout=0.5)
            except queue.Full:
                continue   # the queue's backpressure; the loop re-checks _stop

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
