"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for Hopper into a shared library:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The library goes into ``src/repro_torch/kernels/.build/<name>-<hash>/``
(listed in ``.gitignore``; :func:`set_build_dir` moves it, as
``core.aot.enable_compilation_cache`` does), keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is built once per build directory; the key also hashes the headers a
source includes by a quoted path (``csrc/tensor_core.cuh``).  The
build's ``ptxas`` report (registers, shared memory, spills) is kept
beside the library as ``build.log``.  No ``--use_fast_math``: the
kernels must round like the plain PyTorch versions.  No source links
libcuda: the tensor-core flash kernels (forward and backward) look up
``cuTensorMapEncodeTiled`` at run time with the runtime's
``cudaGetDriverEntryPoint``, so the flags are the same for every source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / ".build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel name → its CUDA source, relative to this directory.
SOURCES: Dict[str, str] = {
    "grid_argmin": "grid_argmin/csrc/grid_argmin.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_wgmma": "flash_attention/csrc/flash_attention_wgmma.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_wgmma": "flash_attention/csrc/flash_attention_bwd_wgmma.cu",
    "flash_attention_wide": "flash_attention/csrc/flash_attention_wide.cu",
    "flash_attention_wide_bwd": "flash_attention/csrc/flash_attention_wide_bwd.cu",
    "ssm_scan": "ssm_scan/csrc/selective_scan.cu",
    "ssm_scan_bwd": "ssm_scan/csrc/selective_scan_bwd.cu",
}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_LOADED: Dict[str, ctypes.CDLL] = {}
#: Kernel name → seconds of the ``nvcc`` run that built it in this process.
_BUILT: Dict[str, float] = {}


def set_build_dir(path: os.PathLike | str) -> Path:
    """Build and look up kernel libraries under ``path`` from now on;
    returns the previous directory.  Libraries already loaded stay
    loaded."""
    global BUILD_DIR
    previous, BUILD_DIR = BUILD_DIR, Path(path)
    return previous


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (on PATH or under /usr/local/cuda): "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def source_files(name: str) -> Tuple[Path, ...]:
    """``name``'s source and every header it includes by a quoted path
    (``#include "x.cuh"``, relative to the including file), recursively,
    each once, in the order first met."""
    seen: Dict[Path, None] = {}
    todo = [KERNELS_DIR / SOURCES[name]]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen[path] = None
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return tuple(seen)


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags: the
    key hashes the source, the headers it includes and the flags, so an
    edited header rebuilds every library that includes it."""
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns name → library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, lib in todo.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNELS_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, cmd)
    failed = []
    for name, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        (todo[name].parent / "build.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, todo[name])  # atomic: a reader never sees half a file
        _BUILT[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def loaded() -> Tuple[str, ...]:
    """Names of the kernel libraries this process has loaded so far."""
    return tuple(_LOADED)


def built() -> Dict[str, float]:
    """Kernels this process compiled with ``nvcc``, with the seconds from
    the start of their build until each finished."""
    return dict(_BUILT)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return _LOADED[name]
