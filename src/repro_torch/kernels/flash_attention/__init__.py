"""Online-softmax attention forward (the prefill attention of every layer).

Both kernels replace the TPU kernel ``_fa_kernel``
(``src/repro/kernels/flash_attention/kernel.py:38``); ``ops.route`` picks
one by dtype and head_dim, a fixed rule:

  csrc/flash_attention_wgmma.cu — bfloat16, head_dim 16/32/64/128/256:
      one block per (query head, batch, query tile of 192 rows, 128 at
      head_dim 128 and 256), a consumer warpgroup per 64 rows runs
      S = QKᵀ and O += PV on wgmma (bf16 in, fp32 sums), fed by a
      producer warpgroup's TMA loads through a K ring and a V ring of
      3 stages (2 at head_dim 256).  At the serving shape operations
      bound it (69 GFLOP, 70 µs at the bf16 tensor-core peak; the
      exponentials need about as long on the special-function units).
      p is rounded to bf16 before PV, as the TPU kernel does; within
      2e-2 of the plain version;
  csrc/flash_attention.cu — float32, head_dim up to 256: one block per
      (query head, batch, 64-row query tile), both products as fp32 FMAs
      on the CUDA cores
      from shared memory (1.03 ms at their 67 TFLOP/s peak for the same
      work), because TF32 would miss the fp32 tolerance; within 2e-5;
  ops.py — ``flash_attention``: the kernels for CUDA tensors, the plain
      version for CPU tensors, input checks, the TMA map arguments
      (``tma_map_args``) and launch counts, in total and per kernel;
  ref.py — ``attention_ref`` / ``flash_attention_ref``: the plain version.

Both are GQA-folded (query head h reads KV head h / G), align the causal
mask at 0, take a sliding window and a softcap, mask ragged ends and read
their inputs through their strides.
"""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref

__all__ = ["flash_attention", "attention_ref", "flash_attention_ref"]
