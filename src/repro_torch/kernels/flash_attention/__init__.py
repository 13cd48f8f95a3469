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
      (``tma_map_args``) and launch counts, in total and per kernel; under
      autograd, ``FlashAttention``, whose forward also stores each row's
      softmax stats (m, l) and whose backward is a backward kernel on CUDA
      tensors (``flash_attention_bwd_kernel``, by ``bwd_route``) and
      ``backward.py`` on CPU tensors;
  csrc/flash_attention_bwd_wgmma.cu — the bfloat16 backward: a prologue
      (Δ = rowsum(dO·O) and the row's log-sum-exp), a dK/dV kernel (one
      block per KV head and 64-key tile, walking the G query heads and the
      query tiles of its band, dK and dV summed in registers) and a dQ
      kernel (the forward's band per query tile), every product on wgmma,
      no atomics, so two launches give the same bits;
  csrc/flash_attention_bwd.cu — the float32 backward: the same two passes
      as fp32 FMAs on the CUDA cores;
  ref.py — ``attention_ref`` / ``flash_attention_ref``: the plain version,
      with the same stats on request;
  backward.py — ``flash_attention_bwd``: the JAX package's ``_fa_bwd`` in
      plain PyTorch (the JAX package has no backward kernel): the CPU's
      backward, the tests' and ``chip_smoke.py``'s reference for the
      backward kernels, and on no card's training path.

Both are GQA-folded (query head h reads KV head h / G), align the causal
mask at 0, take a sliding window and a softcap, mask ragged ends and read
their inputs through their strides.
"""

from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ops import (FlashAttention, flash_attention,
                                                     flash_attention_bwd_kernel,
                                                     flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "FlashAttention", "flash_attention_bwd",
           "flash_attention_bwd_kernel", "attention_ref", "flash_attention_ref"]
