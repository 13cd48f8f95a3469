"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Generates a learnable token stream — a noisy affine recurrence
``t_{i+1} = (a·t_i + b) mod V`` with replacement noise — so training
shows a falling loss without an external dataset.  numpy draws every
batch from one seeded generator in the reference's order, so a seed gives
the JAX package's batches bit for bit (``patches`` of the VLM family and
``features`` of the audio family included).  A background thread keeps
``prefetch`` batches ready; a batch the full queue does not take within
its 0.5 s wait is offered again, never dropped (the reference's worker
draws a new one, so its sequence skips batches whenever a step takes
longer than that).  Batches are host numpy arrays; the caller moves them
to its device.  A data-parallel rank draws the same global batch and
keeps its own rows of it (``local_rows``).  ``make_batch_specs`` gives
the dry run empty stand-ins of every model input (fake tensors under
``FakeTensorMode``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

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


def local_rows(batch: Dict[str, np.ndarray], rank: int, n_ranks: int,
               microbatch: int = 0) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of a global batch of B rows.

    With ``microbatch`` n > 1 the global batch is n microbatches of B / n
    rows, as the one-process step splits it, and the rank keeps its
    B / (n · ranks) rows of each, so that the rank's own i-th microbatch
    is its share of the global i-th one.  Otherwise it keeps the
    contiguous block ``[rank · B / ranks, (rank + 1) · B / ranks)``."""
    n = max(microbatch, 1)
    out = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % (n * n_ranks):
            raise ValueError(f"a global batch of {b} rows does not split into {n} "
                             f"microbatch(es) on each of {n_ranks} ranks")
        per = x.reshape((n, n_ranks, b // (n * n_ranks)) + x.shape[1:])[:, rank]
        out[key] = np.ascontiguousarray(per.reshape((b // n_ranks,) + x.shape[1:]))
    return out


class SyntheticPipeline:
    """Iterator of host batches with background prefetch; ``close`` stops
    the thread.  ``rank`` of ``n_ranks`` keeps its ``local_rows`` of each
    global batch (``microbatch`` as the train step splits it)."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None,
                 rank: int = 0, n_ranks: int = 1, microbatch: int = 0):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.rows = (rank, n_ranks, microbatch)
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
        if self.rows[1] > 1:
            batch = local_rows(batch, *self.rows)
        return batch

    def _worker(self):
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self._make()
            try:
                self._q.put(batch, timeout=0.5)
                batch = None
            except queue.Full:
                continue   # the queue's backpressure: re-check _stop, offer the same batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int, kind: str = "train",
                     device=None) -> Dict[str, torch.Tensor]:
    """Empty stand-ins for every model input of a step, with the
    reference's keys, shapes and dtypes: ``tokens`` [B, S] int32 (decode:
    [B, 1]), the audio family's ``features`` [B, S, frontend_dim] float32
    in place of tokens, the VLM family's ``patches`` [B, P, frontend_dim]
    float32, and ``labels`` [B, S] int32 for training.  On ``device``
    (the CPU by default); under ``FakeTensorMode`` they are fake."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "decode":
        return {"tokens": torch.empty((global_batch, 1), **i32)}
    if cfg.family == "audio":
        out = {"features": torch.empty((global_batch, seq_len, cfg.frontend_dim), **f32)}
    else:
        out = {"tokens": torch.empty((global_batch, seq_len), **i32)}
        if cfg.family == "vlm":
            out["patches"] = torch.empty((global_batch, cfg.frontend_len, cfg.frontend_dim),
                                         **f32)
    if kind == "train":
        out["labels"] = torch.empty((global_batch, seq_len), **i32)
    return out
