#!/usr/bin/env python3
"""Time variants of the selective-scan CUDA kernel on one NVIDIA GPU.

  python3 scripts/scan_variants.py [--variants G:CHUNK:STAGES[:CHANNELS],...]
                                   [--repeats 2] [--out DIR [--sass]]

Builds a copy of ``src/repro_torch/kernels/ssm_scan/csrc/selective_scan.cu``
per variant, with its design constants ``kLanes`` = G, ``kChunk`` = CHUNK,
``kStages`` = STAGES (and ``kChannels`` = CHANNELS, channels per block,
where given) rewritten, with the port's own nvcc flags, one ``nvcc`` per
variant, all started together, into
``src/repro_torch/kernels/.build/ssm_scan-variants/``.  For each variant it
prints the ptxas report (registers, spill bytes); holds the kernel against the plain
version on ``chip_smoke.py``'s scan cases and the serving shape (a variant
that differs is reported, and the script exits 1); times it at the
falcon-mamba-7b serving shape (b = 4, S = 2048, D = 8192, N = 16, fp32;
median of 20 launches behind a device spin) and at D = 8190, where rows
start off 16-byte boundaries; and reads the SM clock and power while it
runs back to back.  The variants are timed in turns (in order, then in
reverse, ``--repeats`` times), so their times are comparable within one
run.  Ends with one JSON line of the results; with ``--out DIR`` the same
goes to ``DIR/scan_variants.json``, and ``--sass`` writes each variant's
SASS to ``DIR/scan_sass/``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssm_scan import ops, selective_scan_ref  # noqa: E402

DEFAULT = "2:32:2,1:32:2,4:32:2,8:16:4,2:16:4,2:32:2:32"


def variant_source(source: str, **values: int) -> str:
    """``source`` with each ``constexpr int <name> = <n>;`` of ``values`` rewritten."""
    for name, value in values.items():
        source, found = re.subn(rf"^constexpr int {name} = \d+;",
                                f"constexpr int {name} = {value};", source, flags=re.M)
        if found != 1:
            raise SystemExit(f"selective_scan.cu has no single constant {name}")
    return source


def build(variants):
    """One library per variant, compiled in parallel; name → (path, ptxas lines)."""
    source = (_build.KERNELS_DIR / _build.SOURCES["ssm_scan"]).read_text()
    out_dir = _build.BUILD_DIR / "ssm_scan-variants"
    procs = {}
    for g, chunk, stages, *channels in variants:
        tag = f"G{g}-T{chunk}-S{stages}" + "".join(f"-C{c}" for c in channels)
        src = out_dir / tag / "selective_scan.cu"
        lib = src.with_name("libssm_scan.so")
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(variant_source(source, kLanes=g, kChunk=chunk, kStages=stages,
                                      **({"kChannels": channels[0]} if channels else {})))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    built = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc exited {proc.returncode}\n{log}")
        built[tag] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return built


def launcher(lib):
    """``ops.selective_scan``'s launch, on a variant's library."""
    fn = lib.selective_scan_launch
    fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int

    def run(delta, B, C, x, A_log):
        b, s, d = delta.shape
        n = B.shape[-1]
        y = torch.empty_like(x)
        h = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
        rc = fn(delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(), A_log.data_ptr(),
                y.data_ptr(), h.data_ptr(), None, int(x.dtype == torch.bfloat16), b, s, d, n,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y, h
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=DEFAULT,
                    help="comma-separated G:CHUNK:STAGES[:CHANNELS] (lanes per channel, "
                         "steps per stage, ring stages, channels per block)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", help="directory for scan_variants.json (and the SASS)")
    ap.add_argument("--sass", action="store_true",
                    help="with --out, also write each variant's SASS to OUT/scan_sass/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = [tuple(int(v) for v in s.split(":")) for s in args.variants.split(",")]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[variants] {smi}")
    built = build(variants)
    runs, results = {}, {}
    for tag, (lib_path, ptxas) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        runs[tag] = launcher(lib)
        print(f"[variants] {tag}: ptxas: {' | '.join(ptxas)[:400]}")
        gen = torch.Generator(device=dev).manual_seed(0)
        worst, wrong = 0.0, []
        for case in chip_smoke.SCAN_CASES + [chip_smoke.SCAN_SERVING]:
            dtype, tol = case[4], chip_smoke.SCAN_TOL[case[4]]
            ins = chip_smoke._scan_inputs(*case, gen, dev)
            y, h = runs[tag](*ins)
            yr, hr = selective_scan_ref(*ins)
            torch.cuda.synchronize()
            err = max((y.float() - yr.float()).abs().max().item(), (h - hr).abs().max().item())
            if not (torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol)
                    and torch.allclose(h, hr, rtol=tol, atol=tol)):
                wrong.append(f"{case[:4]} {str(dtype)[6:]}: max|Δ| {err:.3g}")
            worst = max(worst, err)
        if wrong:
            print(f"[variants] {tag} differs from the plain version: {wrong}")
        results[tag] = {"ptxas": ptxas, "max_abs_err": worst, "wrong": wrong, "ms": [],
                        "ms_off_boundary": []}
    b, s, d, n, dtype = chip_smoke.SCAN_SERVING
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = chip_smoke._scan_inputs(b, s, d, n, dtype, gen, dev)
    # D − 2: the same work within 0.03 %, every other row off a 16-byte boundary
    ins_off = chip_smoke._scan_inputs(b, s, d - 2, n, dtype, gen, dev)
    order = list(runs)
    for r in range(args.repeats):
        for tag in (order if r % 2 == 0 else order[::-1]):
            results[tag]["ms"].append(chip_smoke.device_time_ms(lambda: runs[tag](*ins), 20))
            results[tag]["ms_off_boundary"].append(
                chip_smoke.device_time_ms(lambda: runs[tag](*ins_off), 20))
    for tag in order:   # the SM clock and power while the kernel runs back to back
        for _ in range(2000):
            runs[tag](*ins)
        results[tag]["busy_clock"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        torch.cuda.synchronize()
    if args.out and args.sass:
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        out_dir = os.path.join(args.out, "scan_sass")
        os.makedirs(out_dir, exist_ok=True)
        for tag, (lib_path, _) in built.items():
            sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            with open(os.path.join(out_dir, f"{tag}.sass"), "w") as f:
                f.write(sass)
    for tag, res in results.items():
        res["median_ms"] = float(np.median(res["ms"]))
        print(f"[variants] {tag}: serving shape {res['ms']} ms (median {res['median_ms']:.4f}), "
              f"at D = {d - 2} {res['ms_off_boundary']} ms; max|Δ| vs plain on the scan "
              f"cases {res['max_abs_err']:.3g}; SM clock, power while busy {res['busy_clock']}")
    line = json.dumps({"device": smi, "variants": results})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "scan_variants.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if any(res["wrong"] for res in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
