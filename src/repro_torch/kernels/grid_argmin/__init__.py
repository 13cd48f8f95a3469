"""Fused masked voltage-grid sweep + per-bin argmin (the §V cold path).

  csrc/grid_argmin.cu — the Hopper kernel: one block per (platform, row)
      evaluates the term library over the flat grid into shared memory,
      then reduces each frequency level to its first-index argmin;
  ops.py — ``grid_argmin``: the kernel for CUDA tensors, the plain
      version for CPU tensors, with input checks and a launch count;
  ref.py — ``grid_argmin_ref``: the plain PyTorch version.
"""

from repro_torch.kernels.grid_argmin.ops import grid_argmin
from repro_torch.kernels.grid_argmin.ref import grid_argmin_ref

__all__ = ["grid_argmin", "grid_argmin_ref"]
