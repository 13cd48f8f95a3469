"""Trace-replay workload sources: recorded cluster traces as controller input.

Port of ``repro.core.traces`` (host-side numpy, bit-identical to it):

- :class:`TraceSource` — a named, normalized utilization series with its
  sampling interval; :func:`load_csv` / :func:`load_npz` read
  cluster-trace-style files, :func:`load_bundled` the samples vendored
  under ``data/traces/``;
- :func:`resample` — re-grid a series to the controller's step τ: window
  means (demand-conserving), linear interpolation, or block maxima;
- :meth:`TraceSource.replay` — pad/tile a resampled series to any step
  count;
- :func:`mix` / :func:`splice` — blend or concatenate replayed and
  synthetic components into new workload builders;
- :func:`from_serving` — a serving run's measured per-τ workload as a
  replayable source.

:mod:`repro_torch.core.scenarios` registers the bundled replays as named
scenarios.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

#: (n_steps, rng) → raw trace; the same contract as ``scenarios.TraceFn``
#: (clipping to [0, 1] happens in ``Scenario.trace``).
TraceFn = Callable[[int, np.random.Generator], np.ndarray]

#: Anything :func:`mix`/:func:`splice` accept as a component: a replayable
#: source, a registered scenario name, or a raw builder callable.
Component = Union["TraceSource", str, TraceFn]

#: Repo-level directory holding the vendored sample traces.
BUNDLED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "data", "traces")

RESAMPLE_METHODS = ("auto", "mean", "interp", "peak")


def _normalize(util: np.ndarray, mode: str) -> np.ndarray:
    """Map a raw utilization series to fractions in [0, 1].

    ``"unit"`` — already fractional, just clip; ``"percent"`` — divide by
    100; ``"peak"`` — divide by the series max (relative utilization);
    ``"auto"`` — pick ``unit``/``percent``/``peak`` from the value range.
    """
    util = np.asarray(util, np.float64)
    if util.ndim != 1 or util.size == 0:
        raise ValueError(f"utilization must be a non-empty 1-D series, "
                         f"got shape {util.shape}")
    if not np.isfinite(util).all():
        raise ValueError("utilization contains non-finite samples")
    peak = float(util.max())
    if mode == "auto":
        mode = "unit" if peak <= 1.0 else ("percent" if peak <= 100.0
                                           else "peak")
    if mode == "percent":
        util = util / 100.0
    elif mode == "peak":
        util = util / max(peak, 1e-12)
    elif mode != "unit":
        raise ValueError(f"unknown normalize mode {mode!r}; choose from "
                         "('auto', 'unit', 'percent', 'peak')")
    return np.clip(util, 0.0, 1.0).astype(np.float32)


def resample(w: np.ndarray, src_interval_s: float, dst_interval_s: float,
             method: str = "auto") -> np.ndarray:
    """Re-grid a utilization series to a new sampling interval.

    The source is treated as piecewise-constant: sample ``i`` holds over
    ``[i·a, (i+1)·a)`` with ``a = src_interval_s``.  The output covers the
    same total span ``T = S·a`` with ``n_dst = round(T / dst_interval_s)``
    samples of effective interval ``T / n_dst`` (within half a bin of the
    request, so the span — and hence total demand — is preserved exactly).

    Methods:
      ``"mean"``   — exact window integral of the piecewise-constant
                     source: conserves total demand ``Σ w·τ`` to float
                     precision for *any* interval ratio (the right choice
                     for downsampling to a coarser controller τ).
      ``"interp"`` — linear interpolation between sample midpoints (the
                     right choice for upsampling to a finer τ; smooth but
                     not demand-exact).
      ``"peak"``   — per-window maximum over overlapping source samples:
                     keeps worst-case bursts visible when downsampling
                     (never under-provisions, over-states demand).
      ``"auto"``   — ``"mean"`` when coarsening, ``"interp"`` otherwise.
    """
    w = np.asarray(w, np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError(f"series must be 1-D and non-empty, got {w.shape}")
    if src_interval_s <= 0 or dst_interval_s <= 0:
        raise ValueError("intervals must be positive")
    if method not in RESAMPLE_METHODS:
        raise ValueError(f"unknown resample method {method!r}; choose from "
                         f"{RESAMPLE_METHODS}")
    if method == "auto":
        method = "mean" if dst_interval_s >= src_interval_s else "interp"
    a = float(src_interval_s)
    total = w.size * a
    n_dst = max(1, int(round(total / float(dst_interval_s))))
    if n_dst == w.size:
        return w.astype(np.float32)
    b = total / n_dst
    edges = np.arange(n_dst + 1) * b

    if method == "mean":
        # Exact integral of the piecewise-constant source between window
        # edges: the cumulative integral is piecewise linear through the
        # source boundaries, so np.interp evaluates it exactly.
        cum = np.concatenate([[0.0], np.cumsum(w) * a])
        boundaries = np.arange(w.size + 1) * a
        cum_at = np.interp(edges, boundaries, cum)
        return (np.diff(cum_at) / b).astype(np.float32)
    if method == "interp":
        t_src = (np.arange(w.size) + 0.5) * a
        t_dst = (np.arange(n_dst) + 0.5) * b
        return np.interp(t_dst, t_src, w).astype(np.float32)
    # "peak": max over every source sample whose interval overlaps the
    # destination window.
    i_lo = np.minimum((edges[:-1] / a).astype(np.int64), w.size - 1)
    i_hi = np.minimum(np.ceil(edges[1:] / a - 1e-12).astype(np.int64),
                      w.size)
    return np.asarray([w[lo:max(hi, lo + 1)].max()
                       for lo, hi in zip(i_lo, i_hi)], np.float32)


@dataclasses.dataclass(frozen=True)
class TraceSource:
    """A named, normalized utilization series with its sampling interval.

    ``utilization`` holds workload fractions in [0, 1] (one per
    ``interval_s`` seconds); construction normalizes/clips via
    ``normalize`` (see :func:`_normalize` modes).  Sources are immutable
    value objects: resampling and replay return new arrays.
    """

    name: str
    utilization: np.ndarray
    interval_s: float = 1.0
    provenance: str = ""
    normalize: dataclasses.InitVar[str] = "auto"

    def __post_init__(self, normalize: str):
        if self.interval_s <= 0:
            raise ValueError("interval_s must be positive")
        object.__setattr__(self, "utilization",
                           _normalize(self.utilization, normalize))

    @property
    def n_samples(self) -> int:
        return int(self.utilization.size)

    @property
    def duration_s(self) -> float:
        """Total covered span in seconds."""
        return self.n_samples * self.interval_s

    def resampled(self, tau_s: float, method: str = "auto") -> "TraceSource":
        """This source re-gridded to interval ``tau_s`` (see
        :func:`resample` for the method semantics; the effective interval
        is ``duration_s / n_new`` — within half a bin of ``tau_s``)."""
        w = resample(self.utilization, self.interval_s, tau_s, method)
        return TraceSource(name=self.name, utilization=w,
                           interval_s=self.duration_s / w.size,
                           provenance=self.provenance, normalize="unit")

    def replay(self, n_steps: int, tau_s: Optional[float] = None,
               method: str = "auto", offset: int = 0,
               loop: bool = True) -> np.ndarray:
        """Workload fractions for ``n_steps`` control steps.

        Resamples to ``tau_s`` seconds per step (``None`` keeps the native
        interval — one source sample per step), starts at sample
        ``offset`` (wrapped), and pads to ``n_steps``: ``loop=True`` tiles
        the series periodically (a day-long trace replays day after day),
        ``loop=False`` holds the final sample.  Pure indexing after one
        resample; the streaming fleet path chunks the result exactly like
        a synthetic trace.
        """
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        base = (self.utilization if tau_s is None
                else self.resampled(tau_s, method).utilization)
        idx = offset % base.size + np.arange(n_steps)
        if loop:
            idx = idx % base.size
        else:
            idx = np.minimum(idx, base.size - 1)
        return base[idx]

    def builder(self, tau_s: Optional[float] = None, method: str = "auto",
                jitter: str = "phase") -> TraceFn:
        """A ``scenarios.TraceFn`` replaying this source.

        ``jitter="phase"`` starts each seeded build at a random offset
        into the (looped) series — different seeds replay different
        day-phases of the same recording, which keeps scenario suites
        seed-diverse without fabricating data.  ``jitter="none"`` always
        replays from sample 0.
        """
        if jitter not in ("phase", "none"):
            raise ValueError(f"unknown jitter {jitter!r}; "
                             "choose 'phase' or 'none'")
        base = (self if tau_s is None else self.resampled(tau_s, method))

        def build(n: int, rng: np.random.Generator) -> np.ndarray:
            off = (int(rng.integers(base.n_samples)) if jitter == "phase"
                   else 0)
            return base.replay(n, offset=off)

        return build


# ---------------------------------------------------------------------------
# Loaders (CSV / NPZ / bundled samples)
# ---------------------------------------------------------------------------


def load_csv(path: str, column: Optional[str] = None,
             interval_s: Optional[float] = None, normalize: str = "auto",
             name: Optional[str] = None) -> TraceSource:
    """Load a cluster-trace-style CSV (header row + numeric columns).

    ``column`` names the utilization column (default: the last column).
    The sampling interval is inferred from a ``timestamp_s`` column when
    present (median spacing), else taken from ``interval_s`` (required if
    there is no timestamp column).
    """
    data = np.genfromtxt(path, delimiter=",", names=True)
    if data.dtype.names is None:
        raise ValueError(f"{path}: expected a CSV header row")
    cols = list(data.dtype.names)
    col = column if column is not None else cols[-1]
    if col not in cols:
        raise ValueError(f"{path}: no column {col!r}; available: {cols}")
    util = np.atleast_1d(data[col]).astype(np.float64)
    if interval_s is None:
        if "timestamp_s" in cols and util.size > 1:
            interval_s = float(np.median(np.diff(
                np.atleast_1d(data["timestamp_s"]))))
        else:
            raise ValueError(f"{path}: pass interval_s= (no timestamp_s "
                             "column to infer it from)")
    return TraceSource(
        name=name or os.path.splitext(os.path.basename(path))[0],
        utilization=util, interval_s=interval_s,
        provenance=f"csv:{os.path.basename(path)}:{col}",
        normalize=normalize)


def load_npz(path: str, key: str = "utilization",
             interval_s: Optional[float] = None, normalize: str = "auto",
             name: Optional[str] = None) -> TraceSource:
    """Load an NPZ trace: array ``key`` plus optional scalar
    ``interval_s`` (an explicit ``interval_s=`` argument wins)."""
    with np.load(path) as z:
        if key not in z:
            raise ValueError(f"{path}: no array {key!r}; "
                             f"available: {sorted(z.files)}")
        util = np.asarray(z[key], np.float64)
        if interval_s is None:
            interval_s = (float(z["interval_s"]) if "interval_s" in z
                          else 1.0)
    return TraceSource(
        name=name or os.path.splitext(os.path.basename(path))[0],
        utilization=util, interval_s=interval_s,
        provenance=f"npz:{os.path.basename(path)}:{key}",
        normalize=normalize)


def save_npz(source: TraceSource, path: str) -> None:
    """Write a source as an NPZ loadable by :func:`load_npz` (normalized
    fractions round-trip exactly)."""
    np.savez(path, utilization=source.utilization,
             interval_s=np.float64(source.interval_s))


def load(path: str, **kwargs) -> TraceSource:
    """Dispatch :func:`load_csv` / :func:`load_npz` on the file suffix."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        return load_csv(path, **kwargs)
    if ext == ".npz":
        return load_npz(path, **kwargs)
    raise ValueError(f"unsupported trace file {path!r} (use .csv or .npz)")


def list_bundled() -> Dict[str, str]:
    """Bundled sample traces: ``{name: path}`` (empty if the checkout has
    no ``data/traces`` directory)."""
    if not os.path.isdir(BUNDLED_DIR):
        return {}
    out = {}
    for fn in sorted(os.listdir(BUNDLED_DIR)):
        stem, ext = os.path.splitext(fn)
        if ext.lower() in (".csv", ".npz"):
            out[stem] = os.path.join(BUNDLED_DIR, fn)
    return out


def load_bundled(name: str) -> TraceSource:
    """Load one of the vendored ``data/traces`` samples by stem name."""
    paths = list_bundled()
    if name not in paths:
        raise KeyError(f"no bundled trace {name!r}; "
                       f"available: {sorted(paths)}")
    return load(paths[name])


def bundled_sources() -> Dict[str, TraceSource]:
    """All vendored sample traces, loaded (see ``data/traces/README.md``)."""
    return {n: load(p) for n, p in list_bundled().items()}


# ---------------------------------------------------------------------------
# Composition: mixtures and splices of replayed + synthetic components
# ---------------------------------------------------------------------------


def as_trace_fn(component: Component) -> TraceFn:
    """Coerce a mix/splice component to a ``TraceFn`` builder.

    Accepts a :class:`TraceSource` (replayed with phase jitter), the name
    of a registered scenario (resolved lazily at build time, so
    compositions can reference scenarios registered later), or a raw
    ``(n_steps, rng) → array`` callable.
    """
    if isinstance(component, TraceSource):
        return component.builder()
    if isinstance(component, str):
        def build(n: int, rng: np.random.Generator) -> np.ndarray:
            from repro_torch.core import scenarios as scn  # lazy: a cycle
            # Clip like Scenario.trace does: a scenario-name component
            # means that scenario's [0, 1] trace, not its raw builder
            # (several synthetic shapes overshoot before the clip).
            return np.clip(np.asarray(scn.get_scenario(component)
                                      .build(n, rng), np.float32), 0.0, 1.0)
        return build
    if callable(component):
        return component
    raise TypeError(f"cannot use {type(component).__name__} as a workload "
                    "component (want TraceSource, scenario name, or "
                    "TraceFn)")


def _child(rng: np.random.Generator) -> np.random.Generator:
    return np.random.default_rng(int(rng.integers(2 ** 31)))


@dataclasses.dataclass(frozen=True)
class MixedTrace:
    """A :func:`mix` blend — a ``TraceFn`` that *exposes its components*.

    Calling the instance builds the aggregate ``Σ wᵢ·traceᵢ`` exactly as
    the pre-tenant ``mix`` closure did (same child-generator draw order,
    same accumulation order — bit-for-bit).  :meth:`components` builds
    the weighted per-component traces ``[T, n]`` from the same seed
    instead, which is what lets ``scenarios.Scenario.tenant_plane`` turn
    any registered mixture into a tenant-resolved workload plane without
    a dedicated tenant builder.
    """

    fns: Tuple[TraceFn, ...]
    weights: np.ndarray  # [T] normalized

    def components(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Weighted component traces ``[T, n]`` (float64, unclipped)."""
        return np.stack([wi * np.asarray(fn(n, _child(rng)), np.float64)
                         for wi, fn in zip(self.weights, self.fns)])

    def __call__(self, n: int, rng: np.random.Generator) -> np.ndarray:
        out = np.zeros(n, np.float64)
        for wi, fn in zip(self.weights, self.fns):
            out += wi * np.asarray(fn(n, _child(rng)), np.float64)
        return np.clip(out, 0.0, 1.0).astype(np.float32)


def mix(components: Sequence[Component],
        weights: Optional[Sequence[float]] = None) -> MixedTrace:
    """Blend workload components sample-by-sample: ``Σ wᵢ·traceᵢ``.

    Weights are normalized to sum to 1 and the result is clipped to
    [0, 1] (sources and scenario names are already fractional; the clip
    also bounds raw caller-supplied builders), so the blend is always a
    valid workload-fraction trace.  Each component draws an independent
    child generator from the build seed, so mixtures stay deterministic
    per seed.  Components may be replayed sources, scenario names, or
    raw builders — e.g. a replayed Azure day blended with a synthetic
    flash crowd: ``mix([azure_source, "flash_crowd"], [0.7, 0.3])``.

    Returns a :class:`MixedTrace`: a plain ``TraceFn`` to every existing
    caller, but one whose per-component traces are recoverable
    (``.components(n, rng)``) so mixture scenarios double as
    multi-tenant workload planes.
    """
    fns = tuple(as_trace_fn(c) for c in components)
    if not fns:
        raise ValueError("mix needs at least one component")
    w = (np.full(len(fns), 1.0 / len(fns)) if weights is None
         else np.asarray(list(weights), np.float64))
    if w.shape != (len(fns),) or (w < 0).any() or w.sum() <= 0:
        raise ValueError(f"weights must be {len(fns)} non-negative values "
                         "with a positive sum")
    return MixedTrace(fns=fns, weights=w / w.sum())


def splice(components: Sequence[Component],
           fractions: Optional[Sequence[float]] = None) -> TraceFn:
    """Concatenate workload components as consecutive time segments.

    ``fractions`` apportions the requested step count across segments
    (normalized; default equal shares).  Each segment builds with its own
    child generator, so e.g. ``splice([azure_source, "flash_crowd"],
    [0.75, 0.25])`` replays three-quarters of a day of recorded load and
    hands the tail to a synthetic crowd spike.  Like :func:`mix`, the
    result is clipped to [0, 1].
    """
    fns = [as_trace_fn(c) for c in components]
    if not fns:
        raise ValueError("splice needs at least one component")
    f = (np.full(len(fns), 1.0 / len(fns)) if fractions is None
         else np.asarray(list(fractions), np.float64))
    if f.shape != (len(fns),) or (f < 0).any() or f.sum() <= 0:
        raise ValueError(f"fractions must be {len(fns)} non-negative "
                         "values with a positive sum")
    f = f / f.sum()

    def build(n: int, rng: np.random.Generator) -> np.ndarray:
        edges = np.round(np.cumsum(np.concatenate([[0.0], f])) * n)
        edges = edges.astype(np.int64)
        edges[-1] = n
        segs = []
        for fn, lo, hi in zip(fns, edges[:-1], edges[1:]):
            child = _child(rng)   # always draw: lengths don't shift seeds
            if hi > lo:
                segs.append(np.asarray(fn(int(hi - lo), child),
                                       np.float32))
        out = (np.concatenate(segs) if segs else np.zeros(0, np.float32))
        return np.clip(out, 0.0, 1.0)

    return build


def from_serving(result: Dict[str, object], name: str = "request_driven",
                 interval_s: float = 1.0) -> TraceSource:
    """Wrap a closed-loop serving run's measured workload as a source.

    ``result`` is the dict returned by
    ``DvfsServingSimulator.run_request_load`` — its ``workload_tau``
    entry holds the per-τ workload fraction the controller actually saw
    (batcher occupancy, or occupancy + queue demand, depending on
    ``workload_signal``).  The returned source replays/mixes like any
    recorded trace, so *measured* serving behavior can drive fleet
    campaigns instead of synthetic fractions.
    """
    if "workload_tau" not in result:
        raise ValueError("result lacks 'workload_tau' — pass the dict "
                         "returned by run_request_load")
    return TraceSource(name=name,
                       utilization=np.asarray(result["workload_tau"],
                                              np.float64),
                       interval_s=interval_s,
                       provenance="serving:run_request_load",
                       normalize="unit")
