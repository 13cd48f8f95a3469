"""Mamba-1 selective scan (the prefill recurrence of every Mamba layer).

  csrc/selective_scan.cu — the Hopper kernel: two lanes share a channel
      (batch row, d), each keeping 8 of its states in registers, take each
      decay as one ``ex2.approx`` on the SFU, and walk time in chunks that
      ``cp.async`` streams through a 2-stage shared-memory ring while the
      previous chunk is scanned;
  ops.py — ``selective_scan``: the kernel for CUDA tensors, the plain
      version for CPU tensors, with input checks and a launch count;
  ref.py — ``selective_scan_ref``: the plain version.
"""

from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
