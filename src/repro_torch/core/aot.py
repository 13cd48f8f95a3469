"""The port's cold path: a persistent kernel-build cache and a warmer.

In the JAX package (``repro.core.aot``) the cold cost of the fleet path is
tracing and XLA-compiling its programs.  The port's cold cost is the
``nvcc`` build of the CUDA kernel the fleet path launches (``grid_argmin``)
and the first call of each fleet program key: the table build, and the
capture of the stream chunk's CUDA graph (``controller``'s program
caches, counted by ``fleet_trace_counts``).  So:

* :func:`enable_compilation_cache` points ``kernels._build``'s library
  directory at a directory of the caller's (``--cache-dir`` of
  ``launch.campaign`` and ``launch.compose``); a library built there once
  is loaded, not rebuilt, by every later process that uses the same
  directory and the same kernel source;
* :func:`warm_fleet_programs` builds and loads those kernels up front,
  then builds the "tables" and "stream" programs of the caller's fleet
  shape by running them once (keyed through the controller's own
  ``_runtime_cfg``, as the JAX package's warmers are), so that the
  caller's first same-shaped call builds none, and reports the seconds
  of each.

Nothing here runs at import time: call sites opt in.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import characterization as char
from repro_torch.core import controller as ctl
from repro_torch.core import scheduler as sched_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import _build

#: The kernels the fleet path launches on the card.
FLEET_KERNELS = ("grid_argmin",)

_CACHE_DIR: Optional[str] = None


def enable_compilation_cache(cache_dir: str) -> str:
    """Build and load the port's kernel libraries under ``cache_dir``
    (created if missing); returns its absolute path.  Idempotent."""
    global _CACHE_DIR
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(Path(cache_dir))
    _CACHE_DIR = cache_dir
    return cache_dir


def cache_dir() -> Optional[str]:
    """The enabled cache directory, or None if never enabled here."""
    return _CACHE_DIR


def warm_fleet_programs(params: char.PlatformParams,
                        cfg: ctl.ControllerConfig,
                        techniques: Sequence[str] = ctl.DEFAULT_TECHNIQUES,
                        *, fleet_shape: Optional[Tuple[int, ...]] = None,
                        chunk_size: int = 1024, n_tenants: int = 1,
                        emit: Sequence[str] = (),
                        device=None) -> Dict[str, float]:
    """Build the fleet path's kernels and its programs at one fleet shape.

    ``fleet_shape`` is the tables' leading axes as
    :func:`~repro_torch.core.controller.simulate_fleet_stream` sees them
    (default ``(P, len(techniques))``; e.g. ``(P, T, N)`` for a campaign
    with a scenario axis); ``n_tenants`` the width of the workload plane.
    On the card the kernels are built (or loaded from the build
    directory) before the table build; on the CPU there is nothing to
    build.  The "tables" program of ``techniques`` and the "stream"
    program of ``(fleet_shape, chunk_size, n_tenants, emit)`` and ``cfg``
    are built here (their keys ignore the values), so a later same-shaped
    call adds nothing to ``fleet_trace_counts()``.  Returns wall seconds:
    ``{"tables_compile_s"}`` for the kernel build and one table build,
    ``{"stream_compile_s"}`` for one chunk of ``chunk_size`` steps over an
    idle workload (on the card, the graph's capture included).
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        for name in FLEET_KERNELS:
            _build.load(name)
    tables = ctl.fleet_bin_tables(params, cfg, techniques, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_tables = time.perf_counter() - t0

    # The fleet's cells cycle through the built [P, T] tables.
    lead = tuple(tables.capacity.shape[:-1])
    fleet_shape = lead if fleet_shape is None else tuple(fleet_shape)
    rows = (torch.arange(int(np.prod(fleet_shape, dtype=np.int64)),
                         device=dev) % int(np.prod(lead, dtype=np.int64)))
    # (each field keeps its table's weak flag: the program key holds it)
    fleet = ctl.BinTables(*[
        x.reshape((-1,) + x.shape[len(lead):])[rows]
        .reshape(fleet_shape + x.shape[len(lead):]).as_subclass(type(x)) for x in tables])
    q = max(1, int(n_tenants))
    c = max(1, int(chunk_size))
    t0 = time.perf_counter()
    if q == 1:
        ctl.simulate_fleet_stream(fleet, np.zeros(c, np.float32), cfg,
                                  chunk_size=c, emit=emit, device=dev)
    else:
        ctl.simulate_fleet_stream(fleet, np.zeros((c, q), np.float32), cfg,
                                  chunk_size=c, emit=emit,
                                  tenant_spec=sched_mod.default_tenants(q),
                                  device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_stream = time.perf_counter() - t0
    return {"tables_compile_s": t_tables, "stream_compile_s": t_stream}
