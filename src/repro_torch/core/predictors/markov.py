"""Markov-chain workload predictor (paper §IV-A, §V), batched over ``[K]``.

Port of ``repro.core.predictors.markov``: per cell, transition counts
over ``M`` workload bins are learned online and the current bin's row is
read under the configured policy (``argmax`` is the paper's;
``quantile`` and ``expected`` ride the same counts).  The chain's state
always follows the actual bin; ``threshold`` mode flushes edge counts
into the model only after ``mispred_threshold`` consecutive misses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.predictors.base import Predictor, PredictorConfig, register


class MarkovInner(NamedTuple):
    counts: torch.Tensor               # [K, M, M] transition counts (float32)
    pending: torch.Tensor              # [K, M, M] awaiting threshold flush
    current_bin: torch.Tensor          # [K] int64 — last observed bin
    consecutive_mispred: torch.Tensor  # [K] int64


class MarkovPredictor(Predictor):
    name = "markov"

    def init_inner(self, cfg: PredictorConfig, k: int,
                   device: torch.device) -> MarkovInner:
        m = cfg.n_bins
        # Diagonal-biased Laplace prior: self-transitions first, a small
        # uniform floor keeps every edge alive.
        prior = (0.01 * torch.ones((m, m), dtype=torch.float32, device=device)
                 + torch.eye(m, dtype=torch.float32, device=device))
        zero = torch.zeros(k, dtype=torch.long, device=device)
        return MarkovInner(
            counts=prior.expand(k, m, m).clone(),
            pending=torch.zeros((k, m, m), dtype=torch.float32, device=device),
            current_bin=zero, consecutive_mispred=zero)

    def predict_inner(self, cfg: PredictorConfig,
                      inner: MarkovInner) -> torch.Tensor:
        row = inner.counts.gather(
            1, inner.current_bin[:, None, None].expand(-1, 1, cfg.n_bins))[:, 0]
        probs = row / row.sum(-1, keepdim=True)
        if cfg.policy == "argmax":
            return probs.argmax(-1)
        if cfg.policy == "expected":
            bins = torch.arange(cfg.n_bins, device=row.device)
            return torch.ceil((probs * bins).sum(-1)).long()
        # "quantile": the first bin whose cumulative probability reaches q
        return (probs.cumsum(-1) >= cfg.quantile).int().argmax(-1)

    def observe_inner(self, cfg: PredictorConfig, inner: MarkovInner,
                      w: torch.Tensor, actual_bin: torch.Tensor,
                      predicted_bin: torch.Tensor) -> MarkovInner:
        m = cfg.n_bins
        edge = torch.zeros_like(inner.counts).flatten(1)
        edge.scatter_(1, (inner.current_bin * m + actual_bin)[:, None], 1.0)
        edge = edge.view_as(inner.counts)

        # The consecutive counter sees every disagreement, warmup included.
        mispred = predicted_bin != actual_bin
        consecutive = torch.where(mispred, inner.consecutive_mispred + 1, 0)

        if cfg.update_mode == "always":
            counts = inner.counts * cfg.count_decay + edge
            pending = inner.pending
        else:
            flush = (consecutive >= cfg.mispred_threshold)[:, None, None]
            pending_new = inner.pending + edge
            counts = torch.where(flush,
                                 inner.counts * cfg.count_decay + pending_new,
                                 inner.counts)
            pending = torch.where(flush, 0.0, pending_new)
            consecutive = torch.where(flush[:, 0, 0], 0, consecutive)

        return MarkovInner(counts=counts, pending=pending,
                           current_bin=actual_bin,
                           consecutive_mispred=consecutive)


register(MarkovPredictor())


def transition_matrix(state) -> torch.Tensor:
    """Row-stochastic transition probabilities ``P[k, i, j]`` of a
    ``PredictorState`` of kind ``markov`` or a bare :class:`MarkovInner`."""
    inner = getattr(state, "inner", state)
    return inner.counts / inner.counts.sum(-1, keepdim=True)
