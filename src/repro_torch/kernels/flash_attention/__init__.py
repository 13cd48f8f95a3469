"""Online-softmax attention forward (the prefill attention of every layer).

  csrc/flash_attention.cu — the Hopper kernel: one block per (query head,
      batch, 64-row query tile) walks the KV tiles of its causal / window
      band in shared memory, GQA folded (query head h reads KV head h/G);
  ops.py — ``flash_attention``: the kernel for CUDA tensors, the plain
      version for CPU tensors, with input checks and a launch count;
  ref.py — ``attention_ref`` / ``flash_attention_ref``: the plain version.
"""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref

__all__ = ["flash_attention", "attention_ref", "flash_attention_ref"]
