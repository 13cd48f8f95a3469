"""Mamba-1 selective scan (the prefill recurrence of every Mamba layer).

  csrc/selective_scan.cu — the Hopper kernel: two lanes share a channel
      (batch row, d), each keeping 8 of its states in registers, take each
      decay as one ``ex2.approx`` on the SFU, and walk time in chunks that
      ``cp.async`` streams through a 2-stage shared-memory ring while the
      previous chunk is scanned; for training it also stores the state at
      every 32-step chunk boundary;
  csrc/selective_scan_bwd.cu — its backward: chunks in reverse, each
      chunk's states recomputed from its stored start in 4-step
      sub-chunks whose decays are kept (1.875 exponentials a state
      element), delta, x, dy, B and C staged ahead by ``cp.async``, the
      serving shape's 256 blocks resident in one wave, channel sums
      reduced in a fixed order (no atomics); bound by the bytes it moves
      (0.4423 ms at the serving shape);
  ops.py — ``selective_scan``: the kernel for CUDA tensors, the plain
      version for CPU tensors, with input checks and launch counts;
      ``SelectiveScan``, the op under autograd; ``selective_scan_bwd``,
      the backward kernel's wrapper;
  ref.py — ``selective_scan_ref``: the plain version;
  backward.py — ``selective_scan_bwd_ref``: the plain backward.
"""

from repro_torch.kernels.ssm_scan.backward import selective_scan_bwd_ref
from repro_torch.kernels.ssm_scan.ops import SelectiveScan, selective_scan, selective_scan_bwd
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

__all__ = ["SelectiveScan", "selective_scan", "selective_scan_bwd", "selective_scan_bwd_ref",
           "selective_scan_ref"]
