"""Render the port's dry-run records as the markdown tables of PERF.md.

  PYTHONPATH=src python scripts/dryrun_table.py [GRID.jsonl [MORE.jsonl ...]]

One row per arch, a column per shape, from the newest record of each
cell: on the single-pod mesh the peak GiB per card, the HBM fraction of
``HW_H100``, the dominant roofline term (com, mem, col), the roofline
step in seconds, MFU at the roofline, then all-reduce / all-gather /
reduce-scatter GB per card (or the cell's status, or its error's type);
in the last column the multi-pod cells (the same, their own numbers, or
their errors).  Then the
``gpu_serving/*`` rows of the single-pod ``decode_32k`` / ``train_4k``
cells (``launch.dryrun.serving_rows`` on the CPU's plain path).  Then,
per arch, ``launch.train.ranks_to_fit`` on an 80 GiB card beside the
single-pod ``train_4k`` cell's reckoned state and peak per card, and the
peaks of the training cells in the further files (``--mesh`` / ``--batch``
/ ``--seq`` runs).  Every number is reckoned for the H100 from fake
tensors, none is measured.
"""

import collections
import json
import sys

from repro_torch.analysis.roofline import HW_H100
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.dryrun import DEFAULT_OUT, serving_rows
from repro_torch.launch.train import ranks_to_fit


def _gb(x: float) -> str:
    return f"{x / 1e9:.2f}"


def _latest(path: str) -> "collections.OrderedDict":
    latest = collections.OrderedDict()
    with open(path) as fh:
        for line in fh:
            r = json.loads(line)
            latest[(r["arch"], r["shape"], r["mesh"])] = r
    return latest


def _gib(x: float) -> str:
    return f"{x / 2**30:.2f}"


def _cell(r) -> str:
    """``peak GiB, HBM fraction, dominant, t_step s, MFU; all-reduce /
    all-gather / reduce-scatter GB`` of an ok cell, else its status."""
    if r["status"] == "skipped":
        return "skipped"
    if r["status"] == "error":
        return "error: " + r["error"].split(":")[0]
    rf, mem, c = r["roofline"], r["memory"], r["collectives"]
    colls = "/".join(_gb(c.get(k, 0)) for k in ("all-reduce", "all-gather", "reduce-scatter"))
    return (f"{_gib(mem['peak_live_bytes_per_device'])}, {mem['hbm_fraction']:.2f}, "
            f"{rf['dominant'][:3]}, {rf['t_step_s']:.4g}, {rf['mfu_at_roofline']:.3f}; {colls}")


def main(path: str, more=()) -> None:
    latest = _latest(path)
    archs = list(collections.OrderedDict((a, None) for a, _, _ in latest))
    shapes = list(collections.OrderedDict((s, None) for _, s, _ in latest))
    print("| arch | " + " | ".join(f"{s} 256x1" for s in shapes) + " | 2x128x1 |")
    print("|---|" + "---|" * (len(shapes) + 1))
    for arch in archs:
        cells, pods = [], []
        for shape in shapes:
            one, two = latest[(arch, shape, "256x1")], latest.get((arch, shape, "2x128x1"))
            cells.append(_cell(one))
            if two is not None and two["status"] != "skipped":
                same = (two["status"] == one["status"] == "ok"
                        and two["roofline"] == one["roofline"] and two["memory"] == one["memory"])
                pods.append(f"{shape}: " + ("the same" if same else _cell(two)))
        print(f"| {arch} | " + " | ".join(cells) + " | " + "; ".join(pods) + " |")
    print()
    print("| row | prop | core | hbm | pg | alpha_tpu |")
    print("|---|---|---|---|---|---|")
    for row in serving_rows(list(latest.values()), device="cpu"):
        parts = dict(x.split("=") for x in row["row"].split(";"))
        print(f"| {row['name']} | {parts['prop']} | {parts['core']} | {parts['hbm']} | "
              f"{parts['pg']} | {parts['alpha_tpu']} |")
    print()
    print("| arch | ranks_to_fit (80 GiB, state only) | train_4k 256x1: state GiB / card | "
          "peak GiB / card | fits |")
    print("|---|---|---|---|---|")
    for arch in ARCH_NAMES:
        r = latest.get((arch, "train_4k", "256x1"))
        fit = ranks_to_fit(get_config(arch), HW_H100.hbm_bytes)
        if r is None or r["status"] != "ok":
            print(f"| {arch} | {fit} | {r and r['status']} | | |")
            continue
        mem = r["memory"]
        state = sum(mem[f"{k}_bytes_per_device"] for k in ("params", "m", "v"))
        peak = mem["peak_live_bytes_per_device"]
        print(f"| {arch} | {fit} | {_gib(state)} | {_gib(peak)} | "
              f"{'yes' if peak <= HW_H100.hbm_bytes else 'no'} |")
    for extra in more:
        print()
        print("| arch | shape | mesh | batch × seq | status | state GiB / card | "
              "peak GiB / card | fits 80 GiB |")
        print("|---|---|---|---|---|---|---|---|")
        for (arch, shape, mesh), r in _latest(extra).items():
            size = f"{r.get('global_batch', '')} × {r.get('seq_len', '')}"
            if r["status"] != "ok":
                print(f"| {arch} | {shape} | {mesh} | {size} | {r['status']} | | | |")
                continue
            mem = r["memory"]
            state = sum(mem.get(f"{k}_bytes_per_device", 0) for k in ("params", "m", "v"))
            peak = mem["peak_live_bytes_per_device"]
            print(f"| {arch} | {shape} | {mesh} | {size} | ok | {_gib(state)} | {_gib(peak)} | "
                  f"{'yes' if peak <= HW_H100.hbm_bytes else 'no'} |")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT, sys.argv[2:])
