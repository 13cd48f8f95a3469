#!/usr/bin/env python3
"""Time shapes of the bf16 attention forward's native-width tiles on one NVIDIA GPU.

  python3 scripts/flash_tile_variants.py [--variants W80:K80:W192:K192,...]
                                         [--repeats 2] [--out DIR]

Builds a copy of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_wgmma.cu`` per variant, with the design constants of its
native-width tiles rewritten: ``kWarpgroups80`` = W80 consumer warpgroups and
``kKeys80`` = K80 keys a KV tile for (80, 80), ``kWarpgroups192`` = W192 and
``kKeys192`` = K192 for (192, 128) (its softcap instantiation keeps the
shipped shape), with the port's own nvcc flags, one ``nvcc`` per variant, all
started together, into ``src/repro_torch/kernels/.build/flash_tile_variants/``.
A variant whose tile passes the shared-memory or register budget does not
build (the source's static_asserts) and is reported.  For each variant it
prints the ptxas report of the (80, 80) and (192, 128) instantiations
(registers, spill bytes, wgmma that ptxas serializes); holds the kernel
against the plain version within 2e-2 at the three model layers that run those
tiles (deepseek-v2's MLA layer: B = 2, S = 4096, 128 heads, q, k of 192 and v
of 128, causal; zamba2's shared block: B = 4, S = 2048, 32/32 heads of 80,
causal; hubert's encoder: 16/16 heads of 80, non-causal), and times it there
(median of 10 launches behind a device spin) beside
``scaled_dot_product_attention`` on the same tensors, in turns (in order, then
in reverse, ``--repeats`` times), so the times are comparable within one run.
Ends with one JSON line of the results; ``--out DIR`` also writes it to
``DIR/flash_tile_variants.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

SOURCE = os.path.join(_build.KERNELS_DIR, _build.SOURCES[ops.TENSOR_CORE])
DEFAULT = "3:64:3:64,2:128:2:64,3:128:3:64,2:64:2:64"
CONSTANTS = ("kWarpgroups80", "kKeys80", "kWarpgroups192", "kKeys192")
SHAPES = {"deepseek_v2_mla": (2, 4096, 128, 1, 192, 128, True),
          "zamba2_shared": (4, 2048, 32, 1, 80, 80, True),
          "hubert": (4, 2048, 16, 1, 80, 80, False)}


def variant_source(source: str, values) -> str:
    """``source`` with each ``constexpr int <name> = <n>;`` of CONSTANTS
    rewritten to ``values``."""
    for name, value in zip(CONSTANTS, values):
        source, found = re.subn(rf"^constexpr int {name} = \d+;",
                                f"constexpr int {name} = {value};", source, flags=re.M)
        if found != 1:
            raise SystemExit(f"{os.path.basename(SOURCE)} has no single constant {name}")
    return source


def ptxas_lines(log: str) -> list:
    """(instantiation, report) of the native-width tiles in an nvcc log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"kernelILi(\d+)ELi(\d+)ELb(\d)E", line)
        if "Compiling entry function" in line:
            entry = f"({m[1]}, {m[2]}){' softcap' if m[3] == '1' else ''}" if m else None
        elif "serialized" in line and m and m[1] in ("80", "192"):
            out.append((f"({m[1]}, {m[2]})", "wgmma serialized: "
                        + line.split("serialized due to ")[-1].split(" for the")[0]))
        elif entry and entry.startswith(("(80,", "(192,")) and ("spill" in line
                                                              or "registers" in line):
            out.append((entry, line.split(":", 1)[-1].strip()))
    return out


def build(variants, build_dir: str) -> dict:
    """variant → (library path or None, nvcc log), one nvcc each, all at once."""
    with open(SOURCE) as fh:
        source = fh.read()
    header = os.path.join(os.path.dirname(SOURCE), "tensor_core.cuh")
    procs = {}
    for v in variants:
        d = os.path.join(build_dir, "-".join(map(str, v)))
        os.makedirs(d, exist_ok=True)
        with open(header) as fh, open(os.path.join(d, "tensor_core.cuh"), "w") as out:
            out.write(fh.read())
        with open(os.path.join(d, "fa.cu"), "w") as fh:
            fh.write(variant_source(source, v))
        lib = os.path.join(d, "libfa.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(d, "fa.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), lib)
    out = {}
    for v, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        out[v] = (lib if proc.returncode == 0 else None, log)
    return out


def launch(lib, q, k, v, causal: bool, scale: float, rows: int) -> torch.Tensor:
    """One launch of a variant library's forward, as ``ops._launch`` makes it,
    with k, v boxes of the variant's ``rows`` keys."""
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    maps = [ops.tma_map_args(q, ops.Q_BOX_ROWS).as_c(), ops.tma_map_args(k, rows).as_c(),
            ops.tma_map_args(v, rows).as_c()]
    fn = lib.flash_attention_wgmma_launch
    fn.argtypes, fn.restype = ops._WGMMA_ARGTYPES, ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, *maps, b, sq,
            k.shape[1], h, k.shape[2], d, v.shape[-1], float(scale), int(causal), -1, 0, 0.0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = [tuple(int(x) for x in v.split(":")) for v in args.variants.split(",")]
    if any(len(v) != len(CONSTANTS) for v in variants):
        raise SystemExit("a variant is W80:K80:W192:K192")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[variants] {smi}")
    built = build(variants, os.path.join(_build.BUILD_DIR, "flash_tile_variants"))
    libs, report = {}, {}
    for v, (path, log) in built.items():
        name = "W80:K80:W192:K192 = " + ":".join(map(str, v))
        report[name] = {"ptxas": ptxas_lines(log), "built": path is not None}
        for entry, line in report[name]["ptxas"]:
            print(f"[variants] {name} {entry}: {line}")
        if path is None:
            why = [ln for ln in log.splitlines() if "error" in ln][:2]
            print(f"[variants] {name} does not build: {why}")
            continue
        libs[name] = (ctypes.CDLL(path), {80: v[1], 192: v[3]})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol, failed = chip_smoke.FLASH_TOL[torch.bfloat16], 0
    for shape, (b, s, kv, g, d, dv, causal) in SHAPES.items():
        q = torch.randn(b, s, kv * g, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, s, kv, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, s, kv, dv, generator=gen, device=dev).to(torch.bfloat16)
        scale = d ** -0.5
        ref = chip_smoke._plain_attention(q, k, v, causal=causal, scale=scale)
        calls = {}
        for name, (lib, keys) in libs.items():
            call = (lambda lib=lib, rows=keys[d]:
                    launch(lib, q, k, v, causal, scale, rows))
            err = (call().float() - ref).abs().max().item()
            report[name].setdefault("max_abs_err", {})[shape] = err
            if err > tol:
                failed += 1
                print(f"[variants] {name} at {shape}: max|Δ| {err} > {tol}")
            calls[name] = call
        del ref
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        calls["scaled_dot_product_attention"] = lambda: torch.nn.functional \
            .scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale)
        times = {n: [] for n in calls}
        for _ in range(args.repeats):
            for order in (list(calls), list(calls)[::-1]):
                for n in order:
                    times[n].append(chip_smoke.device_time_ms(calls[n], 10))
        bound, _ = chip_smoke._flash_bound(q, k, v, q.new_empty(q.shape[:3] + (dv,)),
                                           causal=causal)
        for n, ts in times.items():
            report.setdefault(n, {}).setdefault("ms", {})[shape] = ts
            print(f"[variants] {shape} {n}: " + " / ".join(f"{t:.4f}" for t in ts)
                  + f" ms (bound {bound:.4f} ms)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    line = json.dumps({"device": smi, "variants": report})
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "flash_tile_variants.json"), "w") as fh:
            fh.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
