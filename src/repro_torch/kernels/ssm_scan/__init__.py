"""Mamba-1 selective scan (the prefill recurrence of every Mamba layer).

  csrc/selective_scan.cu — the Hopper kernel: one thread per channel
      (batch row, d) keeps its N states in registers and walks time in
      chunks staged through shared memory;
  ops.py — ``selective_scan``: the kernel for CUDA tensors, the plain
      version for CPU tensors, with input checks and a launch count;
  ref.py — ``selective_scan_ref``: the plain version.
"""

from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
