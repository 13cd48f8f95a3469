#!/usr/bin/env python3
"""Time variants of the selective-scan backward CUDA kernel on one NVIDIA GPU.

  python3 scripts/scan_bwd_variants.py [--variants CHANNELS:MIN_BLOCKS:STAGES,...]
                                       [--baseline DIR/FILE.cu ...] [--repeats 2]
                                       [--out DIR [--sass]]

Builds a copy of ``src/repro_torch/kernels/ssm_scan/csrc/selective_scan_bwd.cu``
per variant, with its design constants ``kChannels`` (channels per block),
``kMinBlocks`` (blocks an SM must hold) and ``kStages`` (ring depth in
units) rewritten, with the port's own nvcc flags, one ``nvcc`` per
variant, all started together, into
``src/repro_torch/kernels/.build/ssm_scan_bwd-variants/``.  Each
``--baseline`` adds another source with the same C interface and a
``kChannels`` constant (for example an earlier commit's kernel, unpacked
with ``git show``), named after its directory, built and timed beside
them.  For each it prints the blocks an SM holds and the ptxas report
(registers, spill bytes); holds the kernel against the plain
backward (``backward.selective_scan_bwd_ref``) on ``chip_smoke.py``'s
backward cases, its off-boundary cases and the serving shape, each
gradient within ``SCAN_BWD_TOL`` of its largest magnitude, two launches
bit-equal (a variant that differs is reported, and the script exits 1);
times it at the falcon-mamba-7b serving shape (b = 4, S = 2048, D = 8192,
N = 16, fp32; median of 10 launches behind a device spin), in turns (in
order, then in reverse, ``--repeats`` times), so the times are comparable
within one run; and reads the SM clock and power while it runs back to
back.  Ends with one JSON line of the results (also written to
``DIR/scan_bwd_variants.json`` with ``--out``).  Needs a CUDA device.
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
from repro_torch.kernels.ssm_scan import ops, selective_scan_bwd_ref  # noqa: E402

DEFAULT = "64:4:3,64:4:2,128:2:3,128:2:2"


def variant_source(source: str, **values: int) -> str:
    """``source`` with each ``constexpr int <name> = <n>;`` of ``values`` rewritten."""
    for name, value in values.items():
        source, found = re.subn(rf"^constexpr int {name} = \d+;",
                                f"constexpr int {name} = {value};", source, flags=re.M)
        if found != 1:
            raise SystemExit(f"the backward source has no single constant {name}")
    return source


def channels_of(source: str) -> int:
    return int(re.search(r"^constexpr int kChannels = (\d+);", source, re.M).group(1))


def build(sources: dict) -> dict:
    """One library per source, compiled in parallel; tag → (path, ptxas lines)."""
    out_dir = _build.BUILD_DIR / "ssm_scan_bwd-variants"
    procs = {}
    for tag, text in sources.items():
        src = out_dir / tag / "selective_scan_bwd.cu"
        lib = src.with_name("libssm_scan_bwd.so")
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
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


def launcher(lib, channels: int):
    """``ops.selective_scan_bwd``'s launch, on a library whose blocks take
    ``channels`` channels (the first axis of its dB, dC partials)."""
    fn = lib.selective_scan_bwd_launch
    fn.argtypes, fn.restype = ops._BWD_ARGTYPES, ctypes.c_int

    def run(delta, B, C, x, A_log, boundary, dy, dh):
        b, s, d = delta.shape
        n = B.shape[-1]
        ddelta, dx = torch.empty_like(delta), torch.empty_like(x)
        dB, dC, dA_log = torch.empty_like(B), torch.empty_like(C), torch.empty_like(A_log)
        dB_part = torch.empty((-(-d // channels), b, s, n), dtype=torch.float32,
                              device=delta.device)
        dC_part = torch.empty_like(dB_part)
        dA_part = torch.empty((b, d, n), dtype=torch.float32, device=delta.device)
        rc = fn(delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(), A_log.data_ptr(),
                boundary.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
                ddelta.data_ptr(), dB.data_ptr(), dC.data_ptr(), dx.data_ptr(),
                dA_log.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(),
                b, s, d, n, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return ddelta, dB, dC, dx, dA_log
    return run


def check(run, dev) -> tuple:
    """(worst max|Δ| / max|g|, [what differs]) of ``run`` on the backward cases."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(c, (0, 0, 0)) for c in chip_smoke.SCAN_BWD_CASES]
    cases[-1:-1] = [(c, offs) for c, *offs in chip_smoke.SCAN_BWD_OFFSET_CASES]
    worst, wrong = 0.0, []
    for case, offsets in cases:
        ins, bnd, dy, dh, _ = chip_smoke._scan_bwd_inputs(case, gen, dev, offsets)
        g1, g2 = run(*ins, bnd, dy, dh), run(*ins, bnd, dy, dh)
        ref = selective_scan_bwd_ref(*ins, dy, dh, boundary=bnd)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(g1, g2)):
            wrong.append(f"{case} {offsets}: two launches differ")
        for name, a, r in zip(("dδ", "dB", "dC", "dx", "dA_log"), g1, ref):
            rel = (a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
            worst = max(worst, rel)
            if not rel <= chip_smoke.SCAN_BWD_TOL:
                wrong.append(f"{case} {offsets} {name}: max|Δ| / max|g| {rel:.3g}")
        del ins, bnd, dy, dh, g1, g2, ref
        torch.cuda.empty_cache()
    return worst, wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=DEFAULT,
                    help="comma-separated CHANNELS:MIN_BLOCKS:STAGES (channels per block, "
                         "blocks an SM holds, ring depth); empty for none")
    ap.add_argument("--baseline", action="append", default=[],
                    help="another backward source with the same C interface (repeatable; "
                         "named after its directory)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", help="directory for scan_bwd_variants.json (and the SASS)")
    ap.add_argument("--sass", action="store_true",
                    help="with --out, also write each variant's SASS to OUT/scan_bwd_sass/")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[bwd-variants] {smi}")
    source = (_build.KERNELS_DIR / _build.SOURCES["ssm_scan_bwd"]).read_text()
    sources = {}
    for spec in filter(None, args.variants.split(",")):
        channels, blocks, stages = (int(v) for v in spec.split(":"))
        sources[f"C{channels}-B{blocks}-S{stages}"] = variant_source(
            source, kChannels=channels, kMinBlocks=blocks, kStages=stages)
    for path in args.baseline:
        with open(path) as f:
            sources[os.path.basename(os.path.dirname(os.path.abspath(path)))] = f.read()
    built = build(sources)
    runs, results = {}, {}
    for tag, (lib_path, ptxas) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        runs[tag] = launcher(lib, channels_of(sources[tag]))
        occupancy = None
        if hasattr(lib, "selective_scan_bwd_blocks_per_sm"):
            occupancy = [lib.selective_scan_bwd_blocks_per_sm(a) for a in (1, 0)]
        print(f"[bwd-variants] {tag}: blocks an SM (aligned, not) {occupancy}; ptxas: "
              f"{' | '.join(ptxas)[:400]}")
        worst, wrong = check(runs[tag], dev)
        if wrong:
            print(f"[bwd-variants] {tag} differs from the plain backward: {wrong}")
        results[tag] = {"ptxas": ptxas, "blocks_per_sm": occupancy, "max_rel_err": worst,
                        "wrong": wrong, "ms": []}
    gen = torch.Generator(device=dev).manual_seed(3)
    ins, bnd, dy, dh, _ = chip_smoke._scan_bwd_inputs(chip_smoke.SCAN_BWD_CASES[-1], gen, dev)
    order = list(runs)
    for r in range(args.repeats):
        for tag in (order if r % 2 == 0 else order[::-1]):
            results[tag]["ms"].append(
                chip_smoke.device_time_ms(lambda: runs[tag](*ins, bnd, dy, dh), 10))
    for tag in order:   # the SM clock and power while the kernel runs back to back
        for _ in range(200):
            runs[tag](*ins, bnd, dy, dh)
        results[tag]["busy_clock"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        torch.cuda.synchronize()
    if args.out and args.sass:
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        out_dir = os.path.join(args.out, "scan_bwd_sass")
        os.makedirs(out_dir, exist_ok=True)
        for tag, (lib_path, _) in built.items():
            sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            with open(os.path.join(out_dir, f"{tag}.sass"), "w") as f:
                f.write(sass)
    for tag, res in results.items():
        res["median_ms"] = float(np.median(res["ms"]))
        print(f"[bwd-variants] {tag}: serving shape {res['ms']} ms (median "
              f"{res['median_ms']:.4f}); worst max|Δ| / max|g| vs plain "
              f"{res['max_rel_err']:.3g}; SM clock, power while busy {res['busy_clock']}")
    line = json.dumps({"device": smi, "variants": results})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "scan_bwd_variants.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if any(res["wrong"] for res in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
