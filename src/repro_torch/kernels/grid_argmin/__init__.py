"""Fused masked voltage-grid sweep + per-bin argmin (the §V cold path).

  csrc/grid_argmin.cu — the Hopper kernel: a cluster of blocks per
      (platform, row) tabulates each term over the rail voltages, walks the
      flat grid in windows with every level's running minimum in registers,
      and merges the first-index argmins through distributed shared memory;
  ops.py — ``grid_argmin``: the kernel for CUDA tensors, the plain
      version for CPU tensors, with input checks and a launch count;
  ref.py — ``grid_argmin_ref``: the plain PyTorch version.
"""

from repro_torch.kernels.grid_argmin.ops import grid_argmin
from repro_torch.kernels.grid_argmin.ref import grid_argmin_ref

__all__ = ["grid_argmin", "grid_argmin_ref"]
