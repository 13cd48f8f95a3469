"""Bursty, self-similar workload generation (paper §VI-B) — a numpy copy of
``repro.core.workload``, so both packages see bit-identical traces.

The paper evaluates on a synthetic trace from BURSE [47] with 40 % average
load, arrival rate λ=1000, Hurst exponent H=0.76 and index of dispersion
IDC=500.  We synthesize statistically equivalent traces with the standard
*circulant-embedding / Davies–Harte* construction of fractional Gaussian
noise (exact spectral method), then shift/scale to the requested mean rate
and index of dispersion and clip to [0, peak].

Host-side (numpy) since traces feed the simulation like a data pipeline;
a seeded generator keeps every experiment bit-reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_steps: int = 2048
    mean_load: float = 0.40    # mean / peak (paper: "40 % average load")
    lam: float = 1000.0        # mean arrivals per *arrival period* (λ)
    hurst: float = 0.76        # H — long-range dependence
    idc: float = 500.0         # index of dispersion for counts (var/mean)
    #: arrival periods per control step τ.  The paper's τ is "seconds to
    #: minutes" while λ counts per-second arrivals; the workload counter
    #: aggregates over τ, which smooths per-arrival burstiness by
    #: m^(H-1) while preserving self-similarity.
    aggregate: int = 32
    seed: int = 0

    @property
    def peak(self) -> float:
        return self.lam / self.mean_load


def fgn(n: int, hurst: float, rng: np.random.Generator) -> np.ndarray:
    """Exact fractional Gaussian noise via circulant embedding.

    Returns n samples of zero-mean, unit-variance fGn with Hurst ``hurst``.
    """
    if not 0.5 <= hurst <= 1.0:
        raise ValueError("Hurst exponent must be in [0.5, 1.0]")
    if hurst == 1.0:  # degenerate: perfectly correlated
        return np.full(n, rng.standard_normal())
    # H = 0.5 is the valid white-noise boundary: γ(k) = δ(k), so the
    # circulant embedding below degenerates to iid Gaussians and needs no
    # special-casing — only the (0.5, 1.0) long-range-dependent interior
    # has non-trivial correlations.

    k = np.arange(n)
    # Autocovariance of fGn: γ(k) = ½(|k+1|^2H − 2|k|^2H + |k−1|^2H)
    gamma = 0.5 * (np.abs(k + 1) ** (2 * hurst) - 2 * np.abs(k) ** (2 * hurst)
                   + np.abs(k - 1) ** (2 * hurst))
    # First row of the 2n-circulant embedding
    row = np.concatenate([gamma, [0.0], gamma[1:][::-1]])
    eig = np.fft.fft(row).real
    # Numerical floor: tiny negative eigenvalues can appear for large n
    eig = np.maximum(eig, 0.0)

    m = row.size
    z = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    coeff = np.sqrt(eig / (2.0 * m))
    x = np.fft.fft(coeff * z)
    out = np.sqrt(2.0) * x[:n].real
    # Normalize exactly to unit variance (finite-sample correction)
    std = out.std()
    return out / std if std > 0 else out


def generate_trace(cfg: WorkloadConfig) -> np.ndarray:
    """Workload fractions w_t ∈ [0, 1] (arrivals / peak capacity) per τ."""
    rng = np.random.default_rng(cfg.seed)
    n_fine = cfg.n_steps * cfg.aggregate
    z = fgn(n_fine, cfg.hurst, rng)
    # Counts: mean λ, variance IDC·λ  (IDC = var/mean for a count process)
    arrivals = cfg.lam + np.sqrt(cfg.idc * cfg.lam) * z
    arrivals = np.clip(arrivals, 0.0, cfg.peak)
    # clipping shifts the mean (most visible at high mean_load); one
    # multiplicative correction restores the configured average rate
    m = arrivals.mean()
    if m > 0:
        arrivals = np.clip(arrivals * (cfg.lam / m), 0.0, cfg.peak)
    if cfg.aggregate > 1:
        arrivals = arrivals.reshape(cfg.n_steps, cfg.aggregate).mean(axis=1)
    return arrivals / cfg.peak


def generate_periodic_trace(n_steps: int, period: int = 96,
                            mean_load: float = 0.4, burst: float = 0.25,
                            seed: int = 0) -> np.ndarray:
    """Diurnal-style periodic trace with additive bursts (for the periodic
    predictor mode)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_steps)
    base = mean_load * (1.0 + 0.8 * np.sin(2 * np.pi * t / period))
    noise = burst * rng.standard_normal(n_steps) * (rng.random(n_steps) < 0.1)
    return np.clip(base + noise, 0.0, 1.0)


def estimate_hurst(x: np.ndarray, min_block: int = 8) -> float:
    """Variance-of-aggregates Hurst estimator (for tests).

    For self-similar increments, Var[mean of blocks of size m] ~ m^(2H-2):
    the estimate is the log-log regression slope over block sizes
    ``min_block, 2·min_block, 4·min_block, …`` up to ``len(x) // 8``.

    Returns ``NaN`` — *no estimate*, rather than raising — when fewer
    than two block sizes survive, which happens for

    - **short traces**: the regression needs block sizes ``min_block``
      and ``2·min_block`` to both fit ``len(x) // 8``, so any trace
      shorter than ``16 * min_block`` samples (128 with the default
      ``min_block=8``) yields NaN;
    - **degenerate traces** (e.g. constant): zero block variance at
      every size, so no point survives the log.

    Callers must NaN-check before comparing against a target H (see
    ``tests/test_workload.py::test_estimate_hurst_threshold_length``).
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    sizes, variances = [], []
    m = min_block
    while m <= n // 8:
        k = n // m
        blocks = x[: k * m].reshape(k, m).mean(axis=1)
        v = blocks.var()
        if v > 0:
            sizes.append(m)
            variances.append(v)
        m *= 2
    if len(sizes) < 2:
        # Too short (or too degenerate — e.g. constant blocks) to regress
        # Var[m] on m: no estimate, rather than a np.polyfit crash.
        return float("nan")
    slope = np.polyfit(np.log(sizes), np.log(variances), 1)[0]
    return float(1.0 + slope / 2.0)
