#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the root of a checkout.  Phases, each raising on failure and
printing its seconds:

1. device — the card's name and power limit; TF32 off for matmul and cuDNN;
2. build — compile the port's CUDA kernels from this checkout's sources,
   one ``nvcc`` per source, all started together;
3. kernels — the ``grid_argmin`` kernel's ptxas report (no spill bytes);
   ``grid_argmin`` against its plain PyTorch version on the card, on the
   Table II sweep (both grid shapes), a roofline (max-delay) platform, an
   infeasible row, Table II's sweep on the 5 mV (61 x 91) and 1 mV
   (301 x 451) grids, every row on a 13 x 4501 grid (0.1 mV bram
   steps: grids read from device memory, table windows that start
   mid-row), the 5 mV sweep at 40 levels a row, shuffled (two passes), and
   the 5 mV sweep with a term at pw_v0 moved right after the core power
   terms (the leading run of one rail then ends before it), and the §III
   analytic platforms (α, β) = (0, 0.4), (0.8, 0.4), (0.2, 2.0) on the
   13 x 19 and 5 mV grids (α = 0: a BRAM delay term of weight 0; these
   cases allow no voltage flip at all); times the
   kernel at the Table II shape and on both fine grids beside its plain
   version, its bound and the launch floor;
   ``compare_all_batched(..., v_step=0.005)`` on ``cuda`` against the CPU;
   the closure half of ``core/voltage.py`` (``optimize_batch`` over the
   five accelerators × four grids × 25 levels) on ``cuda`` against the CPU
   and the params path, and the three ``voltage_opt/*`` rows (µs a call);
4. main path — ``compare_all_batched`` on ``cuda`` for Table II (five
   accelerators × six techniques, 8 nodes, 25 bins) at 2048 and 1024 steps:
   the kernel launch count of each run, the per-accelerator gains, the
   1024-step gains against ``BENCH_fleet.json``, the same calls on the CPU,
   the warm wall time with the step loop's share of it, and the device's
   busy time per step of the loop (``torch.profiler``);
5. flash kernels — ``flash_attention`` against its plain version on the
   card, every case in both dtypes, each on the kernel ``ops.route`` gives
   it: float32 on the CUDA-core kernel (2e-5), bfloat16 on the tensor-core
   kernel (2e-2) (the cases of ``tests/test_kernels_flash.py``, two ragged
   lengths, head_dim 16, the serving shape, head_dim 256 and 128 with GQA
   8/4, a window and softcap 50, a ragged S and a non-causal call, and k, v
   as strided halves of one fused projection; internvl2's GQA 14/2 (G = 7)
   and a non-causal D = 128 call at ragged lengths; the models' padded
   prefill, heads of 80 with zero columns to 128, against the plain version
   on the unpadded tensors, causal and not); the tensor-core kernel's
   SASS must hold HGMMA and UTMALDG, also in each head_dim-256
   instantiation, whose ptxas report must show no spill bytes; its ptxas
   report and shared memory per head_dim (within the card's opt-in limit)
   are printed; at the serving shape (B = 4, S = 2048, 32 query / 8 KV
   heads, D = 64, causal) each kernel's time in its dtype (bf16, float32)
   beside its plain version's, ``scaled_dot_product_attention``'s and its
   bound; at gemma2-2b's prefill (B = 2, S = 8160, 8/4 heads of 256,
   softcap 50) the tensor-core kernel's global layer and local layer
   (window 4096) and at gemma3-27b's (32/16 heads of 128, window 1024) its
   local layer, each beside its plain version's time and the bound of its
   band (no library call takes a softcap or that window; gemma2's global
   layer is also timed without the softcap, on the kernel and on
   ``scaled_dot_product_attention``, for reference), and the CUDA-core
   kernel at gemma2's local layer in float32 (B = 1, S = 4160);
5b. flash backward — both backward kernels' ptxas reports (no spill bytes
   in any instantiation) and shared memory per head_dim, HGMMA, UTMALDG and
   MUFU.EX2 in the tensor-core backward's SASS; every case of phase 5 in
   both dtypes (strided k, v, the padded heads of 80, the softcap cases,
   the serving shape) through ``FlashAttention`` on the card: one launch
   of the backward kernel ``ops.bwd_route`` names, dq, dk, dv within 2e-2
   of max(1, max |g|) (bf16) or 1e-4 of max |g| (float32) of the plain
   backward on the same tensors and forward stats, a second launch bit-
   equal; at llama's shape the tensor-core backward's time beside its
   bound, the plain backward (one call), SDPA's backward
   (``torch.autograd.grad``) and both forward + backward in turns; the
   kernel alone at qwen3-moe's D = 128, G = 16 layer and gemma2's
   softcapped D = 256 global layer beside their bounds; the CUDA-core
   backward at llama's shape in float32;
6. serving path — ``python -m repro_torch.launch.serve --no-reduced`` on
   ``cuda``; ``ServeEngine`` on full-width llama3.2-1b (random weights from
   a seed, bf16 activations) at B = 4, a 2048-token prompt and 32 new
   tokens: prefill time, decode time per token, tokens per second, the
   flash-attention launches of one ``generate`` (one per layer, all on the
   tensor-core kernel), the attention share of prefill and the decode
   loop's device busy share (``torch.profiler``); the same weights in
   float32 on ``cuda`` (through the CUDA-core kernel) and on the CPU
   (B = 1, S = 128, 4 tokens); ``DvfsServingSimulator.run_trace`` for the
   six default techniques on ``cuda`` against the CPU;
7. scan kernels — the scan kernel's ptxas report (no spill bytes) and its
   SASS (it must hold MUFU.EX2, the SFU's exponential, and LDGSTS, the
   ``cp.async`` copies of its ring); ``selective_scan`` against its plain
   version on the card (the cases of ``tests/test_kernels_ssm.py`` in fp32
   and with bf16 inputs, a ragged S and D, N = 1 and 12, D = 8200, S = 1,
   rows off a 16-byte boundary, delta and x starting off one, bf16 at
   N = 16, the serving shape), y and h both; at the serving shape (B = 4,
   S = 2048, d_inner 8192, d_state 16, fp32) the kernel's and the plain
   version's times and the bound; the backward kernel's ptxas report (no
   spill bytes) and SASS (MUFU.EX2), its gradients against the plain
   backward on the same boundary store (each within 1e-4 of its max |g|,
   two launches bit-equal; a ragged S, D and N = 4, N = 1 and 12, S = 1,
   D = 8200, the serving shape), the store against a plain re-scan and the
   store-less launch's y and h; at the serving shape the backward's, the
   plain backward's and the bound's times, and the forward with and
   without the store, in turns;
8. Mamba serving path — ``launch.serve --arch falcon-mamba-7b --no-reduced``
   on ``cuda``; ``ServeEngine`` on full-width falcon-mamba-7b (64 Mamba-1
   layers, 7.27 B float32 parameters from a seed, bf16 activations) at the
   shapes of phase 6, with one scan launch per layer; the prefill profile
   with the scan's share and a 4-step decode profile; the first 2 of the
   64 layers in float32 on ``cuda`` and on the CPU (a 64-layer float32
   forward on the host's CPU would not fit the run's time);
9. figures — every ``fig4/5/6/10/12`` row of ``BENCH_fleet.json`` through
   ``run_technique`` / ``simulate`` on ``cuda`` (the §III analytic platform
   at 256 steps, the Table I accelerators at 1024): gains within 0.006,
   fig10's voltage ranges and rates and fig12's lowest BRAM voltage equal at
   the printed decimals, every ``Summary`` field within 1e-5 of the same
   rows on the CPU, miss counts equal; the wall time and the grid_argmin
   launches;
10. campaign — ``python -m repro_torch.launch.campaign`` at its defaults but
   1024 steps (five accelerators × ``proposed,power_gating,hybrid`` × the
   fifteen scenarios, chunk 1024) on ``cuda`` and on the CPU: every cell
   within 1e-5 relative, miss rates and Pareto fronts equal; the wall time,
   µs per step, and from a ``torch.profiler`` window of the streaming loop
   the kernels per step and the device's busy share; then the
   ``campaign/*``, ``failure/*``, ``replay/*`` and ``scheduler/*`` rows of
   ``BENCH_fleet.json`` at 1024 steps, as ``benchmarks/run.py`` builds them:
   gains within 0.006, rates within 2/S, fronts and flags equal (the
   ``*/stream_reuse`` rows count JAX retraces and are skipped);
11. long stream — one scenario × five accelerators × three techniques at
   2048 steps in 1024-step chunks: peak device memory within 1 MiB of the
   same campaign at 1024 steps, every cell within 1e-5 of a CPU run;
12. predictors — ``benchmarks/run.py``'s predictor sweep on ``cuda``: every
   registered family's campaign over the fifteen scenarios (tabla,
   ``proposed``, 2048 steps in 512-step chunks; seasonal_naive one campaign
   per detected period: 8 campaigns, 8 grid_argmin launches) and its
   ``evaluate_trace`` row: all 96 ``predictor/*`` rows of
   ``BENCH_fleet.json`` (gains within 0.006, rates within 2/S); the
   holt_winters campaign within 1e-5 of the CPU, every family's
   ``evaluate_trace`` bins equal to the CPU's; µs, device kernels and busy
   share per step of each family's streaming loop (32-step profile); a
   seasonal trace whose dips drive the raw forecast to −1 through both
   fleet loops on ``cuda``, equal to the CPU;
13. composition — ``benchmarks/run.py``'s composition search on ``cuda``
   (tabla + stripes, 48 candidates, burse and diurnal, 1024 steps): the 3
   ``composition/*`` rows, one grid_argmin launch, the search within 1e-5
   of the CPU with Pareto sets equal; ``python -m
   repro_torch.launch.compose`` at its defaults but 512 steps with
   ``--cache-dir`` in an empty directory (it builds grid_argmin), then
   again with ``--warm``
   over the same directory (it must build nothing);
14. serving loop — the 5 ``hybrid/<accelerator>`` rows on ``cuda`` and
   ``hybrid/closed_loop_serving`` (``run_request_load``, λ = 1 for 4096
   steps): counts and latencies equal, gains within 0.006; then
   ``run_request_load`` on ``cuda`` against the CPU for the three workload
   signals and three tenants;
15. local:global serving — ``launch.serve --arch gemma2-2b --no-reduced`` on
   ``cuda``; ``ServeEngine`` on full-width gemma2-2b (26 layers, 13 local
   with window 4096, 8/4 heads of 256, softcaps, 2.614 B float32 parameters
   from a seed) and on full-width gemma3-27b cut to 8 layers (one period of
   6 and 2 remainder layers, 7 local with window 1024, QK-norm; the 62
   layers in float32 would not fit one card) at B = 2, an 8160-token prompt
   (past both windows) and 32 new tokens, capacity 8192: the times of
   phase 6, the flash launches of one ``generate`` (one a layer, all on the
   tensor-core kernel, windowed exactly on the local layers), the decode
   cache's rings (4096 / 1024 slots) and size, peak device memory; the
   first layers of the same weights in float32 on ``cuda`` and on the CPU
   (gemma2: 2 layers, prompt 4160; gemma3: 6 layers, prompt 1040; both past
   the window, so the CUDA-core kernel runs the band at the model's
   head_dim and decode wraps the rings); ``windowed_attention`` on ``cuda``
   against the CUDA-core kernel with the same band, float32, at gemma2's
   local layer (B = 1);
16. MoE serving — ``launch.serve --arch qwen3-moe-235b-a22b`` and ``--arch
   deepseek-v2-236b`` on ``cuda`` (REDUCED: neither fits one card at full
   depth); the tensor-core kernel at both models' prefill layers (qwen3: B = 2,
   S = 4096, 64/4 heads of 128; deepseek's MLA: 128 heads, q, k of 192 and v of
   128 padded to 256) beside its plain version, ``scaled_dot_product_attention``
   (for deepseek on the unpadded tensors) and the bound; ``ServeEngine`` on
   full-width qwen3-moe-235b-a22b cut to 8 layers and deepseek-v2-236b cut to 6
   (its dense layer and 5 MoE layers), bf16 weights drawn from a seed, at B = 2, a
   4096-token prompt (two dispatch groups), 32 new tokens, capacity 4128: the
   times of phase 6, one tensor-core flash launch a layer (D = 128 / 256), peak
   device memory, each MoE layer's ``moe_dropped`` in the prefill, every flash
   call of one prefill against the plain version on the model's q, k, v (and
   deepseek's padded call against the unpadded plain attention); one qwen3 MoE
   layer on one 4096-token group against the reference's one-hot einsum
   formulation (``xe`` bit-equal, y within 2e-2, both timed); the first layers in
   float32 on ``cuda`` and on the CPU (qwen3: 1 layer, a 512-token prompt;
   deepseek: 2 layers, 128), routing compared call for call;
17. hybrid and frontends serving — ``launch.serve --arch zamba2-2.7b`` and
   ``--arch internvl2-1b`` on ``cuda`` (REDUCED), ``--arch hubert-xlarge``
   refused (encoder-only); the tensor-core kernel at the three new prefill
   layers (B = 4, S = 2048: zamba2's shared block, 32/32 heads of 80 padded
   to 128, causal; hubert's encoder, 16/16 of 80 padded, non-causal;
   internvl2's 14/2 of 64) beside its plain version,
   ``scaled_dot_product_attention`` on the unpadded tensors and the bound of
   the useful work; ``ServeEngine`` on full-width zamba2-2.7b (all 54
   layers: 54 Mamba-2 layers and the shared block once in each of 9
   periods, 2,422,907,840 float32 parameters from a seed) at B = 4, a
   2048-token prompt and 32 new tokens: the times of phase 6, 9 tensor-core
   flash launches a ``generate`` at D = 128, peak device memory, the SSD's
   share of prefill device time (``torch.profiler``), every flash call of
   one prefill against the plain version; full-width internvl2-1b (24
   layers): a timed prefill with 256 patch positions, its flash calls
   against the plain version, and a ``generate`` on tokens with 24 launches
   at D = 64; full-width hubert-xlarge (48 layers): one bf16
   ``transformer.forward`` on ``features`` at B = 4, S = 2048, timed, 48
   non-causal launches at D = 128, every flash call against the plain
   version; float32 on ``cuda`` and on the CPU: zamba2's first period (6
   Mamba-2 layers and the shared block) at a 512-token prompt and 3 decode
   steps, internvl2's first 2 layers with patches, hubert's first 2 on
   features;
18. training path — ``python -m repro_torch.launch.train`` REDUCED on ``cuda``
   for every arch, 2 steps each (falcon-mamba-7b through the scan's
   forward and backward kernels), a grad-requiring bf16 scan call on the
   card raising; full-width llama3.2-1b (1.236 B float32
   masters, AdamW moments, bf16 activations, remat) for 8 steps of
   ``make_train_step`` through ``SyntheticPipeline`` at B = 4, S = 2048:
   ms a step, tokens a second, the 6·N·T bound, peak device memory,
   32 tensor-core flash launches a step (16 forward, 16 under remat) and
   16 tensor-core backward launches; the attention backward's share of a
   forward + backward (CUDA events around each backward kernel call); a
   finite gradient on every parameter leaf; every flash call of a
   training forward against the plain version, output and row stats (m,
   l), and the ``FlashAttention`` backward's dq, dk, dv on layer 0's own
   q, k, v (one tensor-core backward launch) against plain autograd
   through ``attention_ref``; the first 2 layers in float32 on ``cuda``
   and on the CPU (B = 1, S = 128, through the CUDA-core kernel's stats and
   the CUDA-core backward): grads, 2 steps' metrics and params; a
   ``run_with_restarts`` run with two injected failures, bit-equal to an
   unbroken run (through the backward kernels); B2 under autograd at
   llama's serving shape (forward with stats + backward kernel, the
   backward alone and its bound) beside SDPA's forward + backward;
   full-width falcon-mamba-7b cut to 8 of 64 layers
   (1.375 B float32 masters, bf16 activations, remat) for 8 steps at
   B = 4, S = 2048: ms a step, tokens a second, the roofline module's
   6·N·T bound, peak memory, 16 scan forwards and 8 backwards a step, the
   scan backward's share of a forward + backward (CUDA events), a finite
   gradient on every leaf; its first 2 layers in float32 on ``cuda`` and
   on the CPU (B = 1, S = 128): grads, 2 steps' metrics and params;
19. llama3-405b serving — ``launch.serve --arch llama3-405b`` REDUCED on
   ``cuda``; the tensor-core kernel at its prefill layer (B = 2, S = 4096,
   128/8 heads of 128, G = 16) beside its plain version, SDPA and the
   bound; ``ServeEngine`` on full-width llama3-405b cut to 8 of its 126
   layers (bf16 weights from a seed, 29.7 B parameters, 59.4 GB) at B = 2,
   a 4096-token prompt and 32 new tokens: the times of phase 6, 8
   tensor-core launches a ``generate``, peak device memory (at most 75
   GiB), every flash call of a prefill against the plain version; its
   first layer in float32 on ``cuda`` and on the CPU on a seeded
   256-token hidden state.

Phase 5 also times each flash kernel with its row-stats store (the
training forward's) beside the store-less launch that serving makes.
Peak rates come from ``repro_torch.analysis.roofline.HW_H100``.
It ends with a ``{"kernels": [...]}`` line, the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line.  Without a
CUDA device, or outside a checkout of this repository, it exits non-zero
and prints no result.  It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis.roofline import HW_H100  # noqa: E402

# The H100 SXM's published peaks: HBM3 bandwidth and dense bf16 on the tensor
# cores (the roofline module's HW_H100), non-tensor-core fp32.
HBM_BYTES_PER_S = HW_H100.hbm_bw
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = HW_H100.peak_flops
POWER_RTOL = 1e-5
# Table II's sweep on finer voltage grids: 61 x 91 and 301 x 451 points.
ARGMIN_FINE = {"fine_5mV": 0.005, "fine_1mV": 0.001}
ARGMIN_PLAIN_ELEMENTS = 2e8   # of one [P, rows, M, C, B, T] temporary of a plain call
ARGMIN_WIDE_BRAM_STEP = 1e-4  # 13 x 4501: grids past shared memory, windows mid-row
NEAR_TIE_RTOL = 1e-6
SUMMARY_RTOL = 1e-5
GAIN_ATOL = 0.006   # BENCH_fleet.json prints gains to two decimals
SUMMARY_FIELDS = ("mean_power_w", "nominal_power_w", "power_gain",
                  "qos_violation_rate", "served_fraction", "mean_backlog",
                  "nominal_power_configured_w", "power_gain_vs_configured")
MISS_FIELDS = ("misprediction_rate", "margin_misprediction_rate")
# tests/test_kernels_flash.py's tolerances: fp32 differs from the plain
# version only in summation order; bf16 adds one rounding of the output.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_CASES = [
    # B, S, KV, G, D, causal, window, softcap: tests/test_kernels_flash.py's CASES
    (1, 128, 1, 1, 64, True, None, None),
    (2, 256, 2, 2, 64, True, None, None),
    (1, 256, 1, 4, 32, True, 64, None),
    (2, 128, 4, 1, 64, False, None, None),
    (1, 256, 2, 2, 64, True, None, 50.0),
    (1, 512, 2, 4, 128, True, 128, 30.0),
    # ragged lengths (no multiple of the 64-row tiles)
    (1, 1000, 2, 4, 64, True, None, None),
    (2, 77, 2, 2, 64, True, 16, None),
    # the reduced llama's head_dim
    (1, 128, 2, 2, 16, True, None, None),
    # gemma2's head_dim 256 and gemma3's 128 with GQA 8/4, a window shorter than S and
    # gemma2's softcap; ragged lengths; a non-causal call
    (1, 1000, 4, 2, 256, True, 300, 50.0),
    (2, 333, 4, 2, 256, True, None, None),
    (1, 256, 2, 1, 256, False, None, None),
    (1, 700, 4, 2, 128, True, 200, 50.0),
    # internvl2's GQA 14/2 (G = 7) at a ragged S; a non-causal D = 128 call at a ragged S
    # (hubert's padded encoder layer)
    (2, 301, 2, 7, 64, True, None, None),
    (2, 450, 4, 1, 128, False, None, None),
]
# The models' padded prefill (``attention._padded_flash``): heads of 80 with zero
# columns to 128, against the plain version on the unpadded tensors:
# (B, S, KV, G, D, causal)
FLASH_PADDED_CASES = [(2, 333, 4, 1, 80, True), (1, 500, 4, 1, 80, False)]
# The softcap in its nonlinear range: q scaled so that the scores reach past the cap,
# where the capped and the uncapped function differ by far more than the bf16
# tolerance (phase 5 checks that they do): (B, S, KV, G, D, window, softcap, q's scale)
FLASH_SOFTCAP_CASES = [(1, 700, 4, 2, 256, 300, 50.0, 40.0), (2, 333, 4, 2, 256, None, 50.0, 40.0),
                       (1, 640, 4, 2, 128, 128, 5.0, 4.0)]
SOFTCAP_EFFECT_MIN = 10 * FLASH_TOL[torch.bfloat16]
# k and v as the two strided halves of one fused projection [B, S, 2, KV, D]:
# (B, S, KV, G, D, window, softcap)
FLASH_STRIDED_CASES = [(1, 600, 4, 2, 256, 100, 50.0), (2, 520, 4, 2, 128, 64, None)]
SERVING_SHAPE = (4, 2048, 8, 4, 64, True, None, None)   # llama3.2-1b prefill, bf16
# The attention backward's kernels against the plain backward (``flash_attention_bwd``)
# on the same card tensors and forward stats: bf16 within 2e-2 of max(1, max |g|) (P and dS
# round to bf16 at other places than in the plain version), float32 within 1e-4 of max |g|
# (sums in other orders).
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Phase 5b's timed shapes beside llama's: qwen3-moe's prefill layer (D = 128, G = 16) and
# gemma2-2b's softcapped global layer (D = 256): (B, S, KV, G, D, causal, window, softcap)
FLASH_BWD_SHAPES = {"qwen3_moe": (2, 4096, 4, 16, 128, True, None, None),
                    "gemma2_global": (2, 8160, 4, 2, 256, True, None, 50.0)}
# The local:global family's prefill attention, bf16, B = 2, a prompt of 8160 (past
# gemma2's 4096 window): name -> (B, S, KV, G, D, causal, window, softcap)
GEMMA_FLASH_SHAPES = {
    "gemma2_global": (2, 8160, 4, 2, 256, True, None, 50.0),
    "gemma2_local": (2, 8160, 4, 2, 256, True, 4096, 50.0),
    "gemma3_local": (2, 8160, 16, 2, 128, True, 1024, None),
}
# ... and the float32 CUDA-core kernel at gemma2's local layer as phase 15's float32
# check runs it (B = 1, a prompt of 4160)
GEMMA_FLASH_F32_SHAPES = {"gemma2_local_f32": (1, 4160, 4, 2, 256, True, 4096, 50.0)}
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
# Float32 logits of full-width llama3.2-1b, card vs CPU: the same weights
# and arithmetic with sums in other orders through 16 layers; logits are
# O(1), and the differences are expected near 1e-5.
F32_LOGIT_ATOL = 2e-3
# tests/test_kernels_ssm.py's tolerances: fp32 differs from the plain version
# in the order of the N-term dot product and FMA contraction; bf16 inputs
# add one rounding of y.
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SCAN_CASES = [
    # b, S, D, N, dtype: tests/test_kernels_ssm.py's CASES and bf16 case
    (2, 128, 128, 16, torch.float32),
    (1, 64, 256, 8, torch.float32),
    (2, 128, 128, 16, torch.float32),
    (1, 256, 128, 4, torch.float32),
    (1, 64, 128, 8, torch.bfloat16),
    # ragged: S and D no multiple of the 32-step chunks or 64-channel blocks
    (2, 77, 200, 16, torch.float32),
    # the kernel's edges: N = 1 and N = 12 (not a multiple of the 4 states a lane
    # holds), a ragged channel block at D = 8200, S = 1, rows that start off a
    # 16-byte boundary (D·size no multiple of 16), bf16 at N = 16
    (2, 50, 128, 1, torch.float32),
    (1, 45, 201, 12, torch.float32),
    (1, 40, 8200, 16, torch.float32),
    (3, 1, 300, 16, torch.float32),
    (2, 70, 203, 16, torch.bfloat16),
    (1, 33, 8200, 16, torch.bfloat16),
]
# delta and x as views that start off a 16-byte boundary: (case, delta's and x's offsets
# in elements into their buffers)
SCAN_OFFSET_CASES = [((2, 70, 256, 16, torch.float32), 1, 3),
                     ((1, 40, 200, 12, torch.bfloat16), 3, 0)]
SCAN_SERVING = (4, 2048, 8192, 16, torch.float32)   # falcon-mamba-7b prefill scan
# The scan's backward kernel against the plain backward: fp32, each gradient within
# SCAN_BWD_TOL of its largest magnitude (the kernels' exp2 and sum orders).  (b, S, D, N):
# a ragged S, D and N = 4, N = 1 and 12 with D off the 64-channel blocks, S = 1, D = 8200,
# and the serving shape.
SCAN_BWD_TOL = 1e-4
SCAN_BWD_CASES = [(2, 77, 70, 16), (1, 40, 33, 4), (2, 45, 201, 12), (2, 50, 128, 1),
                  (3, 1, 300, 16), (1, 33, 8200, 16), (4, 2048, 8192, 16)]
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_F32_LAYERS = 2    # layers of the float32 card-vs-CPU check
# Phase 15: gemma2-2b at full depth and gemma3-27b cut to 8 layers (one period of 6
# and 2 remainder layers; 62 float32 layers would not fit one card), B = 2, a prompt
# past gemma2's window, 32 new tokens, capacity gemma2's 8192 context.
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_NEW, GEMMA_CAPACITY = 2, 8160, 32, 8192
GEMMA3_LAYERS = 8
# Float32 card vs CPU: (layers, prompt) with a global layer and a prompt past the
# window, so the window, the CUDA-core kernel at the arch's head_dim and the ring's
# wrap during decode all run in float32.
GEMMA_F32 = {"gemma2-2b": (2, 4160), "gemma3-27b": (6, 1040)}
# Phase 16: the MoE family at full width, cut in depth (at 94 and 60 layers the models are
# 235 B and 236 B parameters): qwen3-moe-235b-a22b at 8 layers, deepseek-v2-236b at 6 (its
# dense layer and 5 MoE layers), weights drawn in bf16; B = 2, a 4096-token prompt (two
# dispatch groups of 4096 tokens), 32 new tokens, capacity 4128.
MOE_LAYERS = {"qwen3-moe-235b-a22b": 8, "deepseek-v2-236b": 6}
MOE_BATCH, MOE_PROMPT, MOE_NEW = 2, 4096, 32
MOE_CAPACITY = MOE_PROMPT + MOE_NEW
# Float32 card vs CPU: (layers, prompt): qwen3's first layer on one 512-token group
# (capacity 40); deepseek's dense layer and its first MoE layer.
MOE_F32 = {"qwen3-moe-235b-a22b": (1, 512), "deepseek-v2-236b": (2, 128)}
# B2 at the two models' prefill layers, bf16: (B, S, KV, G, D of q and k, D of v, causal)
MOE_FLASH_SHAPES = {"qwen3_moe": (2, 4096, 4, 16, 128, 128, True),
                    "deepseek_v2_mla": (2, 4096, 128, 1, 192, 128, True)}
# Phase 17: the hybrid and frontend families at full width and depth, bf16, B = 4 and a
# 2048-token prompt (a multiple of zamba2's 256-step SSD chunk), 32 new tokens.
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 4, 2048, 32
HYBRID_PATCHES = 256              # internvl2's frontend_len: patch positions of a prompt
# B2 at the three new prefill layers, bf16: (B, S, KV, G, D of q and k, D of v, causal);
# heads of 80 are padded to 128 as the models pad them
HYBRID_FLASH_SHAPES = {"zamba2_shared": (4, 2048, 32, 1, 80, 80, True),
                       "internvl2": (4, 2048, 2, 7, 64, 64, True),
                       "hubert": (4, 2048, 16, 1, 80, 80, False)}
# Float32 card vs CPU: (layers, prompt): zamba2's first period (6 Mamba-2 layers and the
# shared block), internvl2's first 2 layers with patches, hubert's first 2 on features.
HYBRID_F32 = {"zamba2-2.7b": (6, 512), "internvl2-1b": (2, 512), "hubert-xlarge": (2, 512)}
# An H100 SM issues 16 special-function results (ex2 of expf) per clock.
SFU_PER_SM_CLOCK = 16
# The §III analytic platforms of phase 3 (α, β): α = 0 zeroes the BRAM delay term.
ANALYTIC = ((0.0, 0.4), (0.8, 0.4), (0.2, 2.0))
FIGURES = ("fig4", "fig5", "fig6", "fig10", "fig12")
BENCH_STEPS = 1024          # the steps of BENCH_fleet.json's rows
BENCH_CHUNK = 512           # benchmarks/run.py's chunk at 1024 steps
# Depths cut to keep the whole script well inside its time limit as phases were added
# (the checks are unchanged): phase 11's stream (once 16384 steps, then 8192), phase 4's
# warm runs (once 5, then 3), the profile windows (once 64 steps), and phase 10's and
# 13's CLI runs (once at their 4096- and 2048-step defaults).
LONG_STEPS, LONG_CHUNK, LONG_SCENARIO = (2048, 4096), 2048, "node_failure"
WARM_RUNS = 1               # warm and staged 2048-step Table II calls timed in phase 4
PEAK_SLACK_BYTES = 1 << 20
PROFILE_STEPS = 32
CAMPAIGN_CLI_STEPS = 2048   # launch.campaign in phase 10 (its default: 4096)
COMPOSE_CLI_STEPS = 512     # launch.compose in phase 13 (its default: 2048)
PRED_STEPS, PRED_CHUNK = 2048, 512     # benchmarks/run.py's predictor sweep
COMPOSE_SCENARIOS = ("burse", "diurnal")
SERVE_LOOP_STEPS = 4096                # hybrid/closed_loop_serving's arrival steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8    # full-width llama3.2-1b training
TRAIN_F32 = (2, 256, 1)                # float32 card vs CPU: layers, S, B
TRAIN_LR = 1e-3
TRAIN_OUTLIERS = 1e-3                  # share of a leaf's elements past 1e-5 (Adam's noise)
TRAIN_M_RTOL, TRAIN_L_RTOL = 1e-5, 1e-4   # B2's row stats vs the plain version's
# Full-width falcon-mamba-7b training, cut from 64 to 8 layers (1.375 B float32 masters,
# 22 GB of state with AdamW moments), bf16 activations, remat, the llama run's B, S and steps
MAMBA_TRAIN_LAYERS = 8
LLAMA405_LAYERS = 8
LLAMA405_BATCH, LLAMA405_PROMPT, LLAMA405_NEW = 2, 4096, 32
LLAMA405_FLASH_SHAPES = {"llama3_405b": (2, 4096, 8, 16, 128, 128, True)}
LLAMA405_F32_TOKENS = 256


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_time_ms(fn, n: int) -> float:
    """Median device time of one call of ``fn`` over ``n`` calls, warm.

    Each call sits between two CUDA events, and all of them are queued
    behind a GPU spin long enough to cover their enqueue, so the events
    time the device's work and its launch gaps, not the host's Python.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(n)]
    torch.cuda._sleep(int(2e9 * (3 * host_s + 0.01)))  # ≥ 3× the enqueue time
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {name} x{torch.cuda.device_count()}")
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi, name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {sorted(libs)} built in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {name}: {line.strip()[:140]}")


def _sweep_cases(dev):
    """Kernel-vs-plain inputs: ``name → (params, masks, levels, grids)``."""
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import voltage as volt
    from repro_torch.core.accelerators import ACCELERATORS

    cfg = ctl.ControllerConfig()
    default = volt.VoltageGrids.default()
    fpga = char.stack_platform_params(
        [ctl.fpga_platform(a).params for a in ACCELERATORS.values()])
    tpu = char.stack_platform_params(
        [char.tpu_platform_params(0.002, 0.012, 0.001, "max")])
    gears, f_node, _ = ctl._hybrid_gears(cfg)
    levels = volt.bin_frequency_levels(cfg.n_bins, cfg.margin, cfg.f_floor)

    def all_rows(grids):
        masks = [volt.technique_grid_mask(t, grids) for t in ctl.TECHNIQUES]
        masks += [volt.technique_grid_mask("hybrid", grids)] * len(gears)
        rows = [levels] * len(ctl.TECHNIQUES) + list(f_node)
        return torch.stack(masks), torch.stack(rows)

    def table2(v_step):
        grids, _, masks, rows = ctl._sweep_rows(ctl.ControllerConfig(v_step=v_step),
                                                ctl.DEFAULT_TECHNIQUES)
        return fpga, masks, rows, grids

    def many_levels(params, masks, _, grids):
        # 40 levels a row, in no order: two passes of the kernel's levels
        lv = torch.linspace(0.05, 1.0, 40)[torch.randperm(40, generator=torch.Generator()
                                                          .manual_seed(0))]
        return params, masks, lv.expand(masks.shape[0], 40).contiguous(), grids

    def fixed_after_core(params):
        # Each platform's power terms reordered: the core terms, then one term
        # at pw_v0, then the rest, so a term at pw_v0 follows the core run.
        order = []
        for rails in params.pw_rail.tolist():
            core = [i for i, r in enumerate(rails) if r == char.RAIL_CORE]
            fixed = [i for i, r in enumerate(rails)
                     if r not in (char.RAIL_CORE, char.RAIL_BRAM)][:1]
            order.append(core + fixed + [i for i in range(len(rails))
                                         if i not in core + fixed])
        order = torch.tensor(order)
        return char.PlatformParams(*[x.gather(1, order) if f.startswith("pw_") else x
                                     for f, x in zip(params._fields, params)])

    # A 0.1 mV bram grid: C + B past the kernel's staged grids, and a bram row
    # longer than a table window, so windows start mid-row.
    wide = volt.VoltageGrids(core=default.core, bram=char.BRAM_RAIL.grid(ARGMIN_WIDE_BRAM_STEP))

    analytic = char.stack_platform_params(
        [char.analytic_platform_params(a, b) for a, b in ANALYTIC])
    fine = volt.VoltageGrids.default(ARGMIN_FINE["fine_5mV"])

    no_nominal = torch.ones(1, len(default.core), len(default.bram), dtype=torch.bool)
    no_nominal[0, -1, -1] = False
    cases = {
        "table2": table2(cfg.v_step),
        "all_rows_default": (fpga, *all_rows(default), default),
        "all_rows_core_only": (fpga, *all_rows(volt.VoltageGrids.core_only()),
                               volt.VoltageGrids.core_only()),
        "tpu_max_delay": (tpu, *all_rows(default), default),
        "infeasible": (fpga, no_nominal, torch.ones(1, cfg.n_bins), default),
        **{name: table2(step) for name, step in ARGMIN_FINE.items()},
        "wide_bram": (fpga, *all_rows(wide), wide),
        "levels_40": many_levels(*table2(ARGMIN_FINE["fine_5mV"])),
        "fixed_after_core_5mV": (fixed_after_core(fpga),
                                 *table2(ARGMIN_FINE["fine_5mV"])[1:]),
        "analytic": (analytic, *all_rows(default), default),
        "analytic_5mV": (analytic, *all_rows(fine), fine),
    }
    return {k: (p.to(dev), m.to(dev), lv.to(dev), g.to(dev))
            for k, (p, m, lv, g) in cases.items()}


def _argmin_plain(params, masks, levels, grids):
    """The plain version, a few rows a call: on the 1 mV grid one call over all
    rows would hold [P, R, M, C, B, T] temporaries of 6.5 GB each.  Rows are
    independent, so the result is the one call's."""
    from repro_torch.core import voltage as volt
    from repro_torch.kernels.grid_argmin import grid_argmin_ref

    per_row = params.pw_dyn.numel() * masks[0].numel() * levels.shape[-1]
    step = max(1, int(ARGMIN_PLAIN_ELEMENTS // per_row))
    parts = [grid_argmin_ref(params, masks[i:i + step], levels[i:i + step],
                             grids.core, grids.bram)
             for i in range(0, masks.shape[0], step)]
    return volt.OperatingPoint(*[torch.cat(f, 1) for f in zip(*parts)])


def _argmin_check(name, params, masks, levels, grids, out, ref) -> tuple[float, int]:
    """``out`` (the kernel's) against ``ref`` (the plain version's): feasible
    equal, power within POWER_RTOL, voltages equal except at a near-tie.
    Returns max |Δpower| and the number of near-tie flips."""
    from repro_torch.core import characterization as char

    torch.cuda.synchronize()
    check(torch.equal(out.feasible, ref.feasible), f"{name}: feasible differs")
    check(torch.allclose(out.power, ref.power, rtol=POWER_RTOL, atol=POWER_RTOL),
          f"{name}: power differs beyond {POWER_RTOL}")
    err = (out.power - ref.power).abs().max().item()
    # A voltage mismatch is allowed only at a near-tie: the plain version's
    # own objective at the kernel's point is within 1e-6 of its best.
    differs = (out.v_core != ref.v_core) | (out.v_bram != ref.v_bram)
    per_cell = char.PlatformParams(*[x.reshape(x.shape[:1] + (1, 1) + x.shape[1:])
                                     for x in params])
    p_at_kernel = char.params_power(per_cell, out.v_core, out.v_bram, ref.f_rel)
    tie = (p_at_kernel - ref.power).abs() <= NEAR_TIE_RTOL * ref.power.abs()
    check(not bool((differs & ~tie).any()),
          f"{name}: {(differs & ~tie).sum().item()} voltage picks differ off a tie")
    return err, int(differs.sum().item())


def _bound(params, masks, levels, grids, out) -> tuple[float, str]:
    """Least time for the sweep on an H100: bytes over HBM bandwidth vs
    fp32 operations over the non-tensor-core peak, for this data."""
    inputs = list(params) + [masks, levels, grids.core, grids.bram]
    outputs = [out.v_core, out.v_bram, out.power, out.feasible]
    n_bytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    n_p, n_m = params.watts_scale.shape[0], levels.shape[-1]
    g = grids.core.numel() * grids.bram.numel()
    # ~10 operations per delay term (sub, max, pow, div, sub, pow, div, div,
    # mul, add) and per power term (div, mul, mul, sub, mul, exp, mul, 2 adds,
    # select); per level and grid point one timing compare, and for the points
    # a row's mask admits a multiply, an add and a min.
    live_d = (params.dl_weight != 0).sum().item()
    live_t = ((params.pw_dyn != 0) | (params.pw_stat != 0)).sum().item()
    ops = (g * 10 * (live_d + live_t)
           + n_p * n_m * (masks.shape[0] * g + 3 * masks.sum().item()))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _argmin_build_check() -> None:
    """The built grid_argmin kernel's ptxas report: no spill bytes."""
    from repro_torch.kernels import _build

    lib = _build.library_path("grid_argmin")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[kernels] grid_argmin ptxas: {line.strip()[:140]}")
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            check(not any(spills), f"the grid_argmin kernel spills: {line.strip()}")


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.grid_argmin import grid_argmin, grid_argmin_ref

    _argmin_build_check()
    cases = _sweep_cases(dev)
    max_err, near_ties, outs = 0.0, 0, {}
    for name, (params, masks, levels, grids) in cases.items():
        out = grid_argmin(params, masks, levels, grids.core, grids.bram)
        ref = _argmin_plain(params, masks, levels, grids)
        err, ties = _argmin_check(name, params, masks, levels, grids, out, ref)
        rel = ((out.power - ref.power).abs() / ref.power.abs()).max().item()
        near_ties += ties
        max_err = max(max_err, err)
        if name == "infeasible":
            check(not bool(ref.feasible.any()), "infeasible row found a feasible point")
        if name.startswith("analytic"):
            check(ties == 0, f"{name}: {ties} voltage picks differ from the plain version")
        print(f"[kernels] grid_argmin {name}: shape {tuple(out.power.shape)}, grid "
              f"{len(grids.core)} x {len(grids.bram)}, max|Δpower| {err:.3g} (rel {rel:.3g}) near-tie flips {ties}")
        outs[name] = out
    print(f"[kernels] grid_argmin near-tie flips in all cases: {near_ties}")

    one = torch.zeros(1, device=dev)
    floor_ms = device_time_ms(lambda: one.add_(1.0), 200)
    launches_before = grid_argmin.launches
    times = {}
    for name in ("table2", *ARGMIN_FINE):
        p, m, lv, g = cases[name]
        ms = device_time_ms(lambda: grid_argmin(p, m, lv, g.core, g.bram), 200)
        plain_ms = device_time_ms(
            lambda: grid_argmin_ref(p, m, lv, g.core, g.bram) if name == "table2"
            else _argmin_plain(p, m, lv, g), 20 if name == "table2" else 3)
        bound_ms, bound_by = _bound(p, m, lv, g, outs[name])
        times[name] = (ms, plain_ms, bound_ms, bound_by)
        print(f"[kernels] grid_argmin {name} {tuple(outs[name].power.shape)} x "
              f"{len(g.core)} x {len(g.bram)}, medians: kernel {ms * 1e3:.2f} us "
              f"({ms / floor_ms:.2f}x the launch floor, {ms / bound_ms:.2f}x the bound), "
              f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.4f} us ({bound_by})")
    print(f"[kernels] launch floor (one-element add_) {floor_ms * 1e3:.2f} us; "
          f"{grid_argmin.launches - launches_before} timing launches")
    _fine_grid_end_to_end(dev)
    _voltage_closure(dev)
    ms, plain_ms, bound_ms, bound_by = times["table2"]
    return _record("grid_argmin", "grid_argmin", "src/repro/kernels/grid_argmin/kernel.py:40",
                   max_err, ms, plain_ms, bound_ms, bound_by, None)


def _voltage_closure(dev) -> None:
    """3b. The closure half of ``core/voltage.py`` on ``cuda``: every Table I
    accelerator × the default, core-only, BRAM-only and frequency-only
    grids × the 25 bin levels, grid points and ``feasible`` equal to the
    CPU's and power within 1e-5; the closure and params paths' points
    equal on the card; then the three ``voltage_opt/*`` rows of
    ``BENCH_fleet.json`` as ``benchmarks/run.py`` builds them (tabla, the
    13 x 19 grid), µs a call on ``cuda``."""
    from repro_torch.core import controller as ctl
    from repro_torch.core import voltage as volt
    from repro_torch.core.accelerators import ACCELERATORS

    levels = volt.bin_frequency_levels(25, 0.05)
    kinds = {"default": "proposed", "core_only": "core_only", "bram_only": "bram_only",
             "frequency_only": "freq_only"}
    worst, n = 0.0, 0
    for name, acc in ACCELERATORS.items():
        plat = ctl.fpga_platform(acc)
        for kind, tech in kinds.items():
            grids = (volt.VoltageGrids.default() if kind == "default"
                     else getattr(volt.VoltageGrids, kind)())
            got = volt.optimize_batch(plat.delay_fn, plat.power_fn, levels.to(dev),
                                      grids.to(dev))
            want = volt.optimize_batch(plat.delay_fn, plat.power_fn, levels, grids)
            for field in ("v_core", "v_bram", "feasible"):
                check(torch.equal(getattr(got, field).cpu(), getattr(want, field)),
                      f"voltage closure {name} {kind}: {field} on cuda differs from the CPU")
            rel = ((got.power.cpu() - want.power).abs() / want.power.abs()).max().item()
            check(rel <= POWER_RTOL, f"voltage closure {name} {kind}: power rel {rel}")
            full = volt.VoltageGrids.default().to(dev)
            params = volt.optimize_batch_params(
                plat.params.to(dev), levels.to(dev), full.core, full.bram,
                volt.technique_grid_mask(tech, full))
            check(torch.equal(params.v_core, got.v_core) and torch.equal(params.v_bram,
                                                                          got.v_bram),
                  f"voltage closure {name} {kind}: closure and params paths differ on cuda")
            worst, n = max(worst, rel), n + 1
    print(f"[kernels] voltage closure path on cuda, {n} (accelerator, grid) sweeps x 25 "
          f"levels: points and feasible equal to the CPU's and to the params path's, power "
          f"within {POWER_RTOL} (worst rel {worst:.3g})")

    plat = ctl.fpga_platform(ACCELERATORS["tabla"])
    grids = volt.VoltageGrids.default().to(dev)
    half = torch.tensor(0.5, device=dev)
    lv = levels.to(dev)
    table = volt.build_operating_table(plat.delay_fn, plat.power_fn, lv, grids)  # warm
    point_us = 1e6 * _median_s(lambda: volt.optimize_point(plat.delay_fn, plat.power_fn, half,
                                                           grids), 100)
    table_us = 1e6 * _median_s(lambda: volt.build_operating_table(plat.delay_fn, plat.power_fn,
                                                                  lv, grids), 20)
    req = torch.tensor(0.37, device=dev)
    lookup_us = 1e6 * _median_s(lambda: table.lookup(req), 100)
    check(float(table.lookup(req).f_rel) >= 0.37, "the table lookup does not ceil")
    for row, us, what in (("voltage_opt/grid_point", point_us, "13x19_grid, f_rel 0.5"),
                          ("voltage_opt/table_build_25bins", table_us, "synthesis_time"),
                          ("voltage_opt/runtime_lookup", lookup_us, "runtime_path, f 0.37")):
        print(f"[kernels] {row} on cuda: {us:.1f} us a call (median, host clock to a "
              f"synchronize, as benchmarks/run.py times it; {what})")


def _fine_grid_end_to_end(dev) -> None:
    """Table II's sweep at 5 mV end to end: ``compare_all_batched(...,
    v_step=0.005)`` on the card against the CPU (256 steps)."""
    from repro_torch.core import controller as ctl
    from repro_torch.core import workload as wl
    from repro_torch.core.accelerators import ACCELERATORS

    platforms = [ctl.fpga_platform(acc) for acc in ACCELERATORS.values()]
    trace = wl.generate_trace(wl.WorkloadConfig(
        n_steps=256, mean_load=0.40, lam=1000.0, hurst=0.76, idc=500.0, seed=0))
    step = ARGMIN_FINE["fine_5mV"]
    cuda = ctl.compare_all_batched(platforms, trace, device=dev, v_step=step)
    cpu = ctl.compare_all_batched(platforms, trace, device="cpu", v_step=step)
    worst = _compare_summaries(cuda, cpu, f"v_step {step}")
    print(f"[kernels] compare_all_batched v_step={step}, {len(platforms)} accelerators x "
          f"256 steps, cuda vs cpu: every Summary field within {SUMMARY_RTOL} (worst rel "
          f"{worst:.3g}), miss rates equal")


def _record(name: str, build: str, replaces: str, max_err: float, ms: float,
            plain_ms: float, bound_ms: float, bound_by: str, library_ms) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line (``build`` is
    its key in ``_build.SOURCES``); ``launches`` is filled in from its
    path's run."""
    from repro_torch.kernels import _build

    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{_build.SOURCES[build]}",
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _bench_gains() -> dict:
    """``table2/*`` gains recorded in BENCH_fleet.json (1024 steps, seed 0)."""
    with open(os.path.join(ROOT, "BENCH_fleet.json")) as fh:
        benches = json.load(fh)["benches"]
    out = {}
    for key, row in benches.items():
        if key.startswith("table2/"):
            out[key] = float(re.search(r"gain=([0-9.]+)x", row["derived"]).group(1))
    return out


def _table2_gains(res, platforms, techniques) -> dict:
    gains = {}
    for plat in platforms:
        acc = plat.name.split(":", 1)[1]
        for tech in techniques:
            gains[f"table2/{acc}/{tech}"] = res[plat.name][tech].power_gain
    for tech in ("proposed", "core_only", "bram_only"):
        gains[f"table2/average/{tech}"] = float(np.mean(
            [res[p.name][tech].power_gain for p in platforms]))
    return gains


def _compare_summaries(a, b, label: str) -> float:
    worst = 0.0
    for plat, per_tech in a.items():
        for tech, s in per_tech.items():
            t = b[plat][tech]
            for f in MISS_FIELDS:
                check(getattr(s, f) == getattr(t, f),
                      f"{label} {plat}/{tech}: {f} {getattr(s, f)} != {getattr(t, f)}")
            for f in SUMMARY_FIELDS:
                x, y = getattr(s, f), getattr(t, f)
                rel = abs(x - y) / max(abs(x), 1e-12)
                worst = max(worst, rel)
                check(rel <= SUMMARY_RTOL or abs(x - y) <= 1e-12,
                      f"{label} {plat}/{tech}: {f} cuda {x} vs cpu {y}")
    return worst


def phase_main_path(dev) -> int:
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import workload as wl
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.kernels.grid_argmin import grid_argmin

    platforms = [ctl.fpga_platform(acc) for acc in ACCELERATORS.values()]
    techniques = ctl.DEFAULT_TECHNIQUES
    traces = {n: wl.generate_trace(wl.WorkloadConfig(
        n_steps=n, mean_load=0.40, lam=1000.0, hurst=0.76, idc=500.0, seed=0))
        for n in (2048, 1024)}
    launches = {}
    results = {}
    for n, trace in traces.items():
        grid_argmin.launches = 0
        t0 = time.perf_counter()
        results[n] = ctl.compare_all_batched(platforms, trace, techniques, device=dev)
        cold_s = time.perf_counter() - t0
        launches[n] = grid_argmin.launches
        check(launches[n] > 0, f"{n} steps: the main path launched no grid_argmin")
        print(f"[main] compare_all_batched cuda, {len(platforms)} accelerators x "
              f"{len(techniques)} techniques x {n} steps: first call {cold_s:.3f} s, "
              f"grid_argmin launches {launches[n]}")
        gains = _table2_gains(results[n], platforms, techniques)
        for plat in platforms:
            acc = plat.name.split(":", 1)[1]
            print(f"[main]   {acc:10s} " + " ".join(
                f"{t}={gains[f'table2/{acc}/{t}']:.3f}x" for t in techniques))
        print("[main]   average    " + " ".join(
            f"{t}={gains[f'table2/average/{t}']:.3f}x"
            for t in ("proposed", "core_only", "bram_only")))

        t0 = time.perf_counter()
        cpu = ctl.compare_all_batched(platforms, trace, techniques, device="cpu")
        cpu_s = time.perf_counter() - t0
        worst = _compare_summaries(results[n], cpu, f"{n} steps")
        print(f"[main]   cuda vs cpu: every Summary field within {SUMMARY_RTOL} "
              f"(worst rel {worst:.3g}), miss rates equal; cpu call {cpu_s:.3f} s")

    bench = _bench_gains()
    got = _table2_gains(results[1024], platforms, techniques)
    check(set(bench) == set(got), f"table2 rows differ: {sorted(set(bench) ^ set(got))}")
    worst = max(abs(got[k] - bench[k]) for k in bench)
    bad = {k: (got[k], bench[k]) for k in bench if abs(got[k] - bench[k]) > GAIN_ATOL}
    check(not bad, f"table2 gains off BENCH_fleet.json by > {GAIN_ATOL}: {bad}")
    print(f"[main] 1024 steps: all {len(bench)} table2 gains within {GAIN_ATOL} of "
          f"BENCH_fleet.json (worst |Δ| {worst:.4f})")

    # Warm wall time of the 2048-step call, and its stages timed in a run
    # of the same code: tables, the step loop, the host-side summaries.
    cfg = ctl.ControllerConfig()
    trace = traces[2048]
    walls, stages = [], []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.compare_all_batched(platforms, trace, techniques, device=dev)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        params = char.stack_platform_params([p.params for p in platforms]).to(dev)
        tables = ctl.fleet_bin_tables(params, cfg, techniques, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = ctl.simulate_fleet(tables, trace, cfg, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ctl.summarize_fleet(platforms, techniques, trace, params, cfg, res)
        t3 = time.perf_counter()
        stages.append((t1 - t0, t2 - t1, t3 - t2))
    wall = float(np.median(walls))
    tab, loop, summ = (float(np.median(x)) for x in zip(*stages))
    print(f"[main] warm compare_all_batched cuda 2048 steps: {wall:.4f} s (median of "
          f"{len(walls)}: {', '.join(f'{w:.4f}' for w in walls)})")
    print(f"[main] stages (medians of {len(stages)} staged runs): tables {tab * 1e3:.2f} ms, "
          f"step loop {loop:.4f} s, summaries {summ * 1e3:.2f} ms; step loop "
          f"{loop / (tab + loop + summ):.1%} of the staged call, {loop / 2048 * 1e6:.1f} us "
          f"per step")
    phase_profile(ctl, tables, trace[:64], cfg, dev, loop / 2048)
    return launches[2048]


def phase_profile(ctl, tables, trace, cfg, dev, step_s: float) -> None:
    """Device busy time of a short window of the step loop (torch.profiler)."""
    ctl.simulate_fleet(tables, trace, cfg, device=dev)
    kernels = _device_kernels(lambda: ctl.simulate_fleet(tables, trace, cfg, device=dev))
    n = len(trace)
    if not kernels:
        print("[profile] the profiler saw no device work: device busy share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / n
    print(f"[profile] step loop, {n} steps: {len(kernels) / n:.1f} device kernels per "
          f"step, {busy_us:.1f} us device busy per step = {busy_us / (step_s * 1e6):.1%} "
          f"of the unprofiled {step_s * 1e6:.1f} us step")


def _device_kernels(fn):
    """CUDA kernel events of one run of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _top_kernels(events, n_calls: int, k: int = 5) -> str:
    """The ``k`` kernels with the most device time, per call of the
    profiled function: ``name ×launches time``."""
    by_name = {}
    for e in events:
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]
    return "; ".join(f"{name[:48]} x{count / n_calls:g} {us / n_calls / 1e3:.3f} ms"
                     for name, (count, us) in top)


def _flash_inputs(case, dtype, gen, dev):
    b, s, kv, g, d = case[:5]
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, s, kv * g, d), (b, s, kv, d), (b, s, kv, d)))


def _causal_flops(q, window=None, dv=None) -> int:
    """2·B·H·(D + Dv) per visible score of causal self-attention (4·B·H·D
    where v's head_dim ``dv`` is q's): Σ_q min(q + 1, window) scores,
    S(S+1)/2 without a window."""
    b, s, h, d = q.shape
    dv = d if dv is None else dv
    w = s if window is None else min(window, s)
    return 2 * b * h * (d + dv) * (w * (w + 1) // 2 + (s - w) * w)


def _attention_flops(q, causal: bool, dv=None) -> int:
    """``_causal_flops`` of a causal call; 2·B·H·(D + Dv)·S² of a
    non-causal one."""
    if causal:
        return _causal_flops(q, dv=dv)
    b, s, h, d = q.shape
    return 2 * b * h * (d + (d if dv is None else dv)) * s * s


def _flash_bound(q, k, v, out, window=None, causal=True) -> tuple[float, str]:
    """Least time on an H100 for attention: q, k, v and out moved once
    over HBM vs its FLOPs at the dtype's peak."""
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    flops = (_causal_flops(q, window, v.shape[-1]) if causal
             else _attention_flops(q, False, v.shape[-1]))
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _sass(lib) -> str:
    """``cuobjdump -sass`` of a kernel's library."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def _sass_check(sass: str, what: str, ops=("HGMMA", "UTMALDG")) -> str:
    """The SASS ``sass`` of ``what`` must hold each of ``ops`` (by default the
    tensor-core flash kernel's wgmma, HGMMA, and TMA loads, UTMALDG)."""
    counts = {op: len(re.findall(rf"\b{re.escape(op)}\b", sass)) for op in ops}
    check(all(counts.values()), f"{what}: SASS lacks {[k for k, v in counts.items() if not v]}")
    return ", ".join(f"{op} x{n}" for op, n in counts.items())


def _flash_build_report(lib) -> None:
    """The tensor-core kernel's build: HGMMA and UTMALDG in its SASS, and in
    that of each head_dim-256 instantiation; the ptxas report, with no spill
    bytes in the head_dim-256 instantiations; shared memory per head_dim
    within the card's opt-in limit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    sass = _sass(lib)
    print(f"[flash] {ops.TENSOR_CORE} SASS: {_sass_check(sass, lib.name)}")
    tile256 = [part for part in sass.split("Function : ")[1:]
               if "ILi256E" in part.split("\n", 1)[0]]
    check(len(tile256) == 2, f"{len(tile256)} Tile<256> instantiations in the SASS, want 2")
    for part in tile256:
        name = f"Tile<256> {'with' if 'Lb1E' in part[:200] else 'without'} softcap"
        _sass_check(part, name)
        counts = {op: len(re.findall(rf"\b{re.escape(op)}\b", part))
                  for op in ("HGMMA", "UTMALDG", "MUFU.EX2", "MUFU.TANH")}
        print(f"[flash] {name} SASS: " + ", ".join(f"{op} x{n}" for op, n in counts.items()))
    entry = ""
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"kernelILi(\d+)ELb(\d)E", line)
            entry = f"D={m[1]}{' softcap' if m[2] == '1' else ''}" if m else ""
        elif "registers" in line or "spill" in line:
            print(f"[flash] {ops.TENSOR_CORE} {entry} ptxas: {line.strip()[:110]}")
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            check(not (entry.startswith("D=256") and any(spills)),
                  f"the Tile<256> kernel spills: {line.strip()}")
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for d in ops.TC_HEAD_DIMS:
        smem = _build.load(ops.TENSOR_CORE).flash_attention_wgmma_smem_bytes(d)
        check(0 < smem <= limit, f"D={d}: {smem} bytes of shared memory, limit {limit}")
        print(f"[flash] {ops.TENSOR_CORE} D={d}: dynamic shared memory {smem} bytes "
              f"(the card's opt-in limit {limit})")


def _flash_case_check(name, q, k, v, dtype, causal, window, cap,
                      padded=False) -> tuple[str, float]:
    """One call of the op against the plain version: it must launch the
    kernel ``ops.route`` names, once, and agree within FLASH_TOL.  With
    ``padded`` the call is the models' ``attention._padded_flash`` (q, k, v
    with zero columns to the next tensor-core head_dim, the scale of the
    unpadded one, the output cut back), held to the plain version on the
    unpadded tensors."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention as attn_mod

    d = q.shape[-1]
    kernel = ops.route(dtype, attn_mod._flash_head_dim(d) if padded else d)
    before = dict(flash_attention.kernel_launches)
    if padded:
        out = attn_mod._padded_flash([q], [k], v, causal=causal, window=window, softcap=cap,
                                     scale=d ** -0.5)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    served = {n: flash_attention.kernel_launches[n] - before[n] for n in before}
    check(served == {n: int(n == kernel) for n in served},
          f"{name} {dtype}: launched {served}, want one {kernel}")
    check(out.dtype == dtype and out.shape == q.shape, f"{name}: bad output")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= FLASH_TOL[dtype], f"{kernel} {name} {dtype}: max|Δ| {err} "
          f"> {FLASH_TOL[dtype]}")
    print(f"[flash] {name} {str(dtype)[6:]} on {kernel}"
          f"{f' padded to D = {attn_mod._flash_head_dim(d)}' if padded else ''}: max|Δ| vs "
          f"plain {err:.3g} (tol {FLASH_TOL[dtype]})")
    return kernel, err


def phase_flash_kernels(dev) -> list:
    """Both flash kernels against the plain version on every case, each in
    the dtype ``ops.route`` gives it; their times at the serving shape and
    the tensor-core kernel's at the gemma shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import ops

    _flash_build_report(_build.library_path(ops.TENSOR_CORE))
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {ops.TENSOR_CORE: 0.0, ops.CUDA_CORE: 0.0}
    cases = [(c, dt) for c in FLASH_CASES for dt in (torch.float32, torch.bfloat16)]
    for case, dtype in cases + [(SERVING_SHAPE, torch.bfloat16)]:
        q, k, v = _flash_inputs(case, dtype, gen, dev)
        kernel, err = _flash_case_check(case, q, k, v, dtype, *case[5:])
        max_err[kernel] = max(max_err[kernel], err)
    for b, s, kv, g, d, window, cap in FLASH_STRIDED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, s, kv * g, d, generator=gen, device=dev).to(dtype)
            packed = torch.randn(b, s, 2, kv, d, generator=gen, device=dev).to(dtype)
            kernel, err = _flash_case_check(f"strided k, v of [{b}, {s}, 2, {kv}, {d}]", q,
                                            packed[:, :, 0], packed[:, :, 1], dtype, True,
                                            window, cap)
            max_err[kernel] = max(max_err[kernel], err)
    for b, s, kv, g, d, causal in FLASH_PADDED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs((b, s, kv, g, d), dtype, gen, dev)
            kernel, err = _flash_case_check(f"padded {(b, s, kv, g, d, causal)}", q, k, v,
                                            dtype, causal, None, None, padded=True)
            max_err[kernel] = max(max_err[kernel], err)
    for b, s, kv, g, d, window, cap, q_scale in FLASH_SOFTCAP_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs((b, s, kv, g, d), dtype, gen, dev)
            q = (q.float() * q_scale).to(dtype)
            kernel, err = _flash_case_check(f"{(b, s, kv, g, d)} q x{q_scale:g}", q, k, v,
                                            dtype, True, window, cap)
            max_err[kernel] = max(max_err[kernel], err)
            effect = (flash_attention_ref(q, k, v, window=window, softcap=cap).float()
                      - flash_attention_ref(q, k, v, window=window).float()).abs().max().item()
            check(effect >= SOFTCAP_EFFECT_MIN, f"softcap {cap} moves the plain version by "
                  f"only {effect}: the case cannot show a wrong softcap")
            print(f"[flash]   softcap {cap} moves the plain version's output by up to "
                  f"{effect:.3g} (the kernel's max|Δ| {err:.3g})")
    q, k, v = _flash_inputs((1, 40, 2, 1, 64), torch.bfloat16, gen, dev)
    try:
        flash_attention(q, k[:, :16], v[:, :16], causal=False, window=8)
        raise AssertionError("a windowed kernel call with Sq != Sk was not refused")
    except ValueError as e:
        print(f"[flash] a windowed call with Sq 40 != Sk 16 on cuda raises: {e}")

    records = []
    for kernel, dtype in ((ops.TENSOR_CORE, torch.bfloat16), (ops.CUDA_CORE, torch.float32)):
        q, k, v = _flash_inputs(SERVING_SHAPE, dtype, gen, dev)
        out = flash_attention(q, k, v)
        n = 20 if kernel == ops.TENSOR_CORE else 5
        ms = device_time_ms(lambda: flash_attention(q, k, v), n)
        plain_ms = device_time_ms(lambda: flash_attention_ref(q, k, v), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_ms = device_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n)
        sdpa_err = (sdpa.transpose(1, 2).float() - out.float()).abs().max().item()
        bound_ms, bound_by = _flash_bound(q, k, v, out)
        stats_ms = device_time_ms(lambda: ops.flash_attention_fwd(q, k, v), n)
        ms_again = device_time_ms(lambda: flash_attention(q, k, v), n)
        print(f"[flash] {kernel} at the serving shape with the row-stats store (training's "
              f"forward): {stats_ms:.4f} ms vs {ms:.4f} / {ms_again:.4f} ms without (before / "
              f"after), {stats_ms / min(ms, ms_again) - 1:+.1%}")
        tflops = _causal_flops(q) / (ms * 1e-3) / 1e12
        print(f"[flash] {kernel} at the serving shape q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} {str(dtype)[6:]} causal, medians: kernel {ms:.4f} ms "
              f"({tflops:.2f} TFLOP/s, {ms / bound_ms:.2f}x its bound, {ms / lib_ms:.2f}x "
              f"scaled_dot_product_attention), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms (max|Δ| vs kernel "
              f"{sdpa_err:.3g}), bound {bound_ms:.4f} ms ({bound_by} at "
              f"{(BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S) / 1e12:g} "
              f"TFLOP/s)")
        records.append(_record(kernel, kernel, "src/repro/kernels/flash_attention/kernel.py:38",
                               max_err[kernel], ms, plain_ms, bound_ms, bound_by, lib_ms))
        records[-1]["stats_ms"] = stats_ms
    records[0]["gemma_shapes"] = _gemma_flash_times(GEMMA_FLASH_SHAPES, torch.bfloat16,
                                                    gen, dev)
    records[1]["gemma_shapes"] = _gemma_flash_times(GEMMA_FLASH_F32_SHAPES, torch.float32,
                                                    gen, dev)
    return records


def _library_attention(q, k, v, window, cap) -> dict:
    """The PyTorch calls that compute causal attention with ``window`` and
    softcap ``cap`` on q [B,S,H,D], k, v [B,S,KV,D] in one call, by name:
    ``flex_attention`` (compiled; a tanh ``score_mod``, a band block mask,
    GQA) and, without a softcap, ``scaled_dot_product_attention`` with a
    boolean band mask.  Timed here only; the port calls neither."""
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    build = os.path.join(ROOT, "src", "repro_torch", "kernels", ".build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    s, d = q.shape[1], q.shape[-1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def band(b, h, qi, ki):
        keep = qi >= ki
        return keep if window is None else keep & (qi - ki < window)

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(band, None, None, s, s, device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    calls = {"flex_attention": lambda: flex(
        qt, kt, vt, score_mod=softcap if cap else None, block_mask=mask, scale=d ** -0.5,
        enable_gqa=True).transpose(1, 2)}
    if cap is None:
        i = torch.arange(s, device=q.device)
        dense = band(None, None, i[:, None], i[None, :])
        calls["scaled_dot_product_attention with a band mask"] = lambda: (
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=dense, enable_gqa=True)
            .transpose(1, 2))
    return calls


def _gemma_flash_times(shapes: dict, dtype, gen, dev) -> dict:
    """A flash kernel at the local:global family's prefill shapes: its time
    beside the plain version's, the bound of the band it computes and the
    fastest PyTorch call of the same function (``_library_attention``, each
    held to the plain version first).  For reference only, gemma2's global
    layer is also timed without its softcap, on the kernel and on
    ``scaled_dot_product_attention`` (not the same function)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    out = {}
    for name, case in shapes.items():
        q, k, v = _flash_inputs(case, dtype, gen, dev)
        window, cap = case[6], case[7]
        fn = lambda: flash_attention(q, k, v, window=window, softcap=cap)  # noqa: E731
        got = fn()
        ref = flash_attention_ref(q, k, v, window=window, softcap=cap)
        err = (got.float() - ref.float()).abs().max().item()
        check(err <= FLASH_TOL[dtype], f"{name}: max|Δ| {err}")
        library = {}
        for call, lib_fn in _library_attention(q, k, v, window, cap).items():
            lib_err = (lib_fn().float() - ref.float()).abs().max().item()
            check(lib_err <= FLASH_TOL[dtype], f"{name}: {call} max|Δ| vs plain {lib_err}")
            library[call] = device_time_ms(lib_fn, 10)
            print(f"[flash] {name}: {call} {library[call]:.4f} ms, max|Δ| vs plain "
                  f"{lib_err:.3g}")
        del ref
        torch.cuda.empty_cache()
        ms = device_time_ms(fn, 10)
        plain_ms = device_time_ms(
            lambda: flash_attention_ref(q, k, v, window=window, softcap=cap), 3)
        bound_ms, bound_by = _flash_bound(q, k, v, got, window)
        best = min(library, key=library.get)
        rec = {"shape": list(case), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library[best], "library": best,
               "library_calls_ms": library, "max_abs_err": err}
        note = ""
        if name == "gemma2_global":
            rec["no_softcap_ms"] = device_time_ms(lambda: flash_attention(q, k, v), 10)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rec["sdpa_no_softcap_ms"] = device_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)
            note = (f"; without the softcap {rec['no_softcap_ms']:.4f} ms, "
                    f"scaled_dot_product_attention without it {rec['sdpa_no_softcap_ms']:.4f} "
                    f"ms (not the same function)")
        tflops = _causal_flops(q, window) / (ms * 1e-3) / 1e12
        print(f"[flash] {name} q {tuple(q.shape)} k/v {tuple(k.shape)} {str(dtype)[6:]} "
              f"causal window {window} softcap {cap}: kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s, "
              f"{ms / bound_ms:.2f}x its bound, {ms / library[best]:.2f}x {best}), plain "
              f"{plain_ms:.4f} ms, {best} {library[best]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max|Δ| vs plain {err:.3g}{note}")
        out[name] = rec
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def _ptxas_entries(lib) -> list:
    """(kernel, registers line, spill bytes) of each entry in a library's
    ptxas report (``build.log``); kernel is the demangled-enough name with
    its template arguments."""
    rows, entry = [], ""
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(prologue_kernel|dkdv_kernel|dq_kernel)((?:I|L[ib]\d+E)*)", line)
            entry = (f"{m[1]}<{','.join(re.findall(r'L[ib](\d+)E', m[2]))}>" if m
                     else line.strip())
        elif "spill" in line:
            rows.append([entry, "", sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))])
        elif "registers" in line and rows and rows[-1][0] == entry:
            rows[-1][1] = line.split(":", 1)[-1].strip()
    return rows


def _flash_bwd_build_report() -> None:
    """The backward kernels' builds: no spill bytes in any instantiation of
    either, HGMMA and UTMALDG in the tensor-core library's SASS, and each
    kernel's shared memory per head_dim within the card's opt-in limit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for name in (ops.TENSOR_CORE_BWD, ops.CUDA_CORE_BWD):
        lib = _build.library_path(name)
        entries = _ptxas_entries(lib)
        check(len(entries) >= (21 if name == ops.TENSOR_CORE_BWD else 9),
              f"{name}: {len(entries)} entries in its ptxas report")
        for entry, regs, spills in entries:
            print(f"[flash-bwd] {name} {entry}: {regs}; {spills} bytes spill")
        spilled = [(entry, n) for entry, _, n in entries if n]
        check(not spilled, f"{name}: instantiations that spill (entry, bytes): {spilled}")
        lib_fn = getattr(_build.load(name), f"{name}_smem_bytes")
        dims = ops.TC_HEAD_DIMS if name == ops.TENSOR_CORE_BWD else (16, 64, 128, 256)
        sizes = {d: (lib_fn(d, 0), lib_fn(d, 1)) for d in dims}
        check(all(0 < x <= limit for pair in sizes.values() for x in pair),
              f"{name}: shared memory {sizes}, limit {limit}")
        print(f"[flash-bwd] {name} dynamic shared memory (dK/dV, dQ) by head_dim: {sizes} "
              f"bytes (the card's opt-in limit {limit})")
    sass = _sass(_build.library_path(ops.TENSOR_CORE_BWD))
    print(f"[flash-bwd] {ops.TENSOR_CORE_BWD} SASS: "
          f"{_sass_check(sass, ops.TENSOR_CORE_BWD, ('HGMMA', 'UTMALDG', 'MUFU.EX2'))}")


def _flash_bwd_tol(dtype, max_g: float) -> float:
    """FLASH_BWD_TOL of a gradient whose largest magnitude is ``max_g``:
    of max(1, max |g|) in bf16, of max |g| in float32."""
    return FLASH_BWD_TOL[dtype] * (max(1.0, max_g) if dtype == torch.bfloat16 else max_g)


def _flash_bwd_case(name, q, k, v, causal, window, cap, scale=None) -> float:
    """``FlashAttention``'s backward on the card against the plain backward:
    the call must launch the backward kernel ``ops.bwd_route`` names, once;
    dq, dk and dv within FLASH_BWD_TOL of ``flash_attention_bwd`` on the same
    card tensors and forward stats; a second launch of the kernel bit-equal
    to the first.  Returns the largest error as a share of its tolerance,
    and the largest absolute error."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd, ops

    dtype, d = q.dtype, q.shape[-1]
    kw = dict(causal=causal, window=window, softcap=cap,
              scale=scale if scale is not None else d ** -0.5)
    kernel = ops.bwd_route(dtype, d)
    gen = torch.Generator(device=q.device).manual_seed(q.shape[1])
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(dtype)
    before = dict(flash_attention.bwd_kernel_launches)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*ins, **kw).backward(dout)
    torch.cuda.synchronize()
    served = {n: flash_attention.bwd_kernel_launches[n] - before[n] for n in before}
    check(served == {n: int(n == kernel) for n in served},
          f"{name} {dtype}: backward launched {served}, want one {kernel}")
    with torch.no_grad():
        out, m, l = ops.flash_attention_fwd(q, k, v, **kw)
        again = ops.flash_attention_bwd_kernel(q, k, v, out, m, l, dout, **kw)
        ref = flash_attention_bwd(q, k, v, out, m, l, dout, q_chunk=1024, kv_chunk=1024, **kw)
    torch.cuda.synchronize()
    worst, worst_abs, report = 0.0, 0.0, []
    for gname, got, twin, want in zip(("dq", "dk", "dv"), (t.grad for t in ins), again, ref):
        check(torch.equal(got, twin), f"{name} {dtype} {gname}: two launches differ")
        check(got.dtype == want.dtype and got.shape == want.shape, f"{name} {gname}: bad grad")
        mx = want.float().abs().max().item()
        tol = _flash_bwd_tol(dtype, mx)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol, f"{kernel} {name} {dtype} {gname}: max|Δ| {err} > {tol}")
        worst, worst_abs = max(worst, err / tol), max(worst_abs, err)
        report.append(f"{gname} {err:.3g} (max |g| {mx:.3g})")
    print(f"[flash-bwd] {name} {str(dtype)[6:]} on {kernel}: max|Δ| vs plain "
          + ", ".join(report) + f"; {worst:.3f} of the tolerance; two launches bit-equal")
    return worst, worst_abs


def _flash_bwd_bound(q, k, v, out, causal=True, window=None) -> tuple[float, str]:
    """Least time on an H100 for the attention backward: q, k, v, out, dout
    and the row stats read and dq, dk, dv written once over HBM, vs 2.5 x
    the forward's FLOPs (S, dP, dV, dK, dQ) at the dtype's peak."""
    b, s, h, _ = q.shape
    n_bytes = (2 * sum(t.numel() * t.element_size() for t in (q, k, v))
               + 2 * out.numel() * out.element_size() + 2 * b * h * s * 4)
    flops = 2.5 * (_causal_flops(q, window) if causal else _attention_flops(q, False))
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _flash_bwd_time(case, dtype, gen, dev, plain: bool) -> dict:
    """The backward kernel of ``dtype`` at ``case``: its time beside its
    bound, held to the plain backward first; with ``plain``, also the plain
    backward's time (one call) and the library's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention``, one
    call on the same inputs and cotangent; causal, no window or softcap)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops

    q, k, v = _flash_inputs(case, dtype, gen, dev)
    causal, window, cap = case[5:]
    kw = dict(causal=causal, window=window, softcap=cap, scale=q.shape[-1] ** -0.5)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        out, m, l = ops.flash_attention_fwd(q, k, v, **kw)
    fn = lambda: ops.flash_attention_bwd_kernel(q, k, v, out, m, l, dout, **kw)  # noqa: E731
    grads = fn()
    ref = flash_attention_bwd(q, k, v, out, m, l, dout, q_chunk=1024, kv_chunk=1024, **kw)
    errs = [(a.float() - r.float()).abs().max().item()
            / _flash_bwd_tol(dtype, r.float().abs().max().item()) for a, r in zip(grads, ref)]
    check(max(errs) <= 1.0, f"{case}: backward errors {errs} of the tolerance")
    del ref, grads
    torch.cuda.empty_cache()
    ms = device_time_ms(fn, 20 if dtype == torch.bfloat16 else 3)
    bound_ms, bound_by = _flash_bwd_bound(q, k, v, out, causal, window)
    rec = {"shape": list(case), "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "err_share_of_tol": max(errs),
           "fwd_gflop": (_causal_flops(q, window) if causal
                         else _attention_flops(q, False)) / 1e9}
    if plain:
        rec["plain_ms"] = device_time_ms(lambda: flash_attention_bwd(
            q, k, v, out, m, l, dout, q_chunk=1024, kv_chunk=1024, **kw), 1)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dout_t = dout.transpose(1, 2).contiguous()
        rec["library_ms"] = device_time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dout_t, retain_graph=True), 20 if dtype == torch.bfloat16
            else 3)
        del qt, kt, vt, sdpa_out, dout_t
    if dtype == torch.bfloat16 and plain:
        # each of the three kernels' median ms a launch, from a profile of 5 calls
        parts = {}
        for e in _device_kernels(lambda: [fn() for _ in range(5)]):
            hit = re.search(r"(prologue|dkdv|dq)_kernel", e.name)
            if hit:
                parts.setdefault(hit[1], []).append(e.time_range.elapsed_us() / 1e3)
        rec["kernels_ms"] = {name: float(np.median(v)) for name, v in parts.items()}
    del q, k, v, out, m, l, dout
    torch.cuda.empty_cache()
    return rec


def _fwd_bwd_turns(dev, seed: int) -> dict:
    """B2's forward (with its stats store) + backward under autograd at
    llama's shape, bf16, beside ``scaled_dot_product_attention``'s forward +
    backward, in turns (ours, SDPA, SDPA, ours): median ms of each."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = _flash_inputs(SERVING_SHAPE, torch.bfloat16, gen, dev)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dout_t = dout.transpose(1, 2).contiguous()
    calls = {"ours": lambda: flash_attention(qg, kg, vg, causal=True).backward(dout),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True).backward(dout_t)}
    turns = {"ours": [], "sdpa": []}
    for who in ("ours", "sdpa", "sdpa", "ours"):
        turns[who].append(device_time_ms(calls[who], 10))
    return turns


def phase_flash_backward(dev) -> list:
    """5b. Both backward kernels against the plain backward on every phase-5
    case in both dtypes (strided k, v, the padded heads of 80 as the models
    pad them, the softcap in its nonlinear range, the serving shape), then
    the tensor-core kernel's times at llama's, qwen3-moe's and gemma2's
    training shapes beside their bounds; returns the kernels' records."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention as attn_mod

    _flash_bwd_build_report()
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {ops.TENSOR_CORE_BWD: [0.0, 0.0], ops.CUDA_CORE_BWD: [0.0, 0.0]}
    dtypes = (torch.float32, torch.bfloat16)

    def run(name, q, k, v, causal, window, cap, scale=None):
        kernel = ops.bwd_route(q.dtype, q.shape[-1])
        got = _flash_bwd_case(name, q, k, v, causal, window, cap, scale)
        worst[kernel] = [max(a, b) for a, b in zip(worst[kernel], got)]

    for case in FLASH_CASES:
        for dtype in dtypes:
            run(case, *_flash_inputs(case, dtype, gen, dev), *case[5:])
    run(SERVING_SHAPE, *_flash_inputs(SERVING_SHAPE, torch.bfloat16, gen, dev),
        *SERVING_SHAPE[5:])
    for b, s, kv, g, d, window, cap in FLASH_STRIDED_CASES:
        for dtype in dtypes:
            q = torch.randn(b, s, kv * g, d, generator=gen, device=dev).to(dtype)
            packed = torch.randn(b, s, 2, kv, d, generator=gen, device=dev).to(dtype)
            run(f"strided k, v of [{b}, {s}, 2, {kv}, {d}]", q, packed[:, :, 0],
                packed[:, :, 1], True, window, cap)
    for b, s, kv, g, d, causal in FLASH_PADDED_CASES:
        hd = attn_mod._flash_head_dim(d)
        for dtype in dtypes:
            q, k, v = (F.pad(t, (0, hd - d))
                       for t in _flash_inputs((b, s, kv, g, d), dtype, gen, dev))
            run(f"{(b, s, kv, g, d, causal)} padded to D = {hd}", q, k, v, causal, None, None,
                d ** -0.5)
    for b, s, kv, g, d, window, cap, q_scale in FLASH_SOFTCAP_CASES:
        for dtype in dtypes:
            q, k, v = _flash_inputs((b, s, kv, g, d), dtype, gen, dev)
            run(f"{(b, s, kv, g, d)} q x{q_scale:g}", (q.float() * q_scale).to(dtype), k, v,
                True, window, cap)

    llama = _flash_bwd_time(SERVING_SHAPE, torch.bfloat16, gen, dev, plain=True)
    turns = _fwd_bwd_turns(dev, 11)
    print(f"[flash-bwd] {ops.TENSOR_CORE_BWD} at llama's training shape {SERVING_SHAPE[:5]} "
          f"bf16 causal, medians: kernel {llama['ms']:.4f} ms ({llama['ms'] / llama['bound_ms']:.2f}x "
          f"its bound {llama['bound_ms']:.4f} ms, {llama['bound_by']}: 2.5 x the forward's "
          f"{llama['fwd_gflop']:.1f} GFLOP), plain backward {llama['plain_ms']:.4f} ms, SDPA's "
          f"backward (torch.autograd.grad) {llama['library_ms']:.4f} ms; forward + backward "
          f"under autograd {turns['ours'][0]:.4f} / {turns['ours'][1]:.4f} ms vs SDPA's "
          f"{turns['sdpa'][0]:.4f} / {turns['sdpa'][1]:.4f} ms (in turns); by kernel, median ms "
          f"a launch (torch.profiler): {llama['kernels_ms']}")
    shapes = {}
    for name, case in FLASH_BWD_SHAPES.items():
        shapes[name] = rec = _flash_bwd_time(case, torch.bfloat16, gen, dev, plain=False)
        print(f"[flash-bwd] {ops.TENSOR_CORE_BWD} at {name}'s shape {case}: kernel "
              f"{rec['ms']:.4f} ms, {rec['ms'] / rec['bound_ms']:.2f}x its bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); max|Δ| vs plain "
              f"{rec['err_share_of_tol']:.3g} of its tolerance")
    tc = _record(ops.TENSOR_CORE_BWD, ops.TENSOR_CORE_BWD,
                 "none: the Pallas kernel src/repro/kernels/flash_attention/kernel.py:38 has no "
                 "VJP (JAX differentiates full_attention through _fa_bwd, "
                 "src/repro/models/attention.py:244)", worst[ops.TENSOR_CORE_BWD][1],
                 llama["ms"], llama["plain_ms"], llama["bound_ms"], llama["bound_by"],
                 llama["library_ms"])
    tc.update(fwd_bwd_ms=turns["ours"], sdpa_fwd_bwd_ms=turns["sdpa"], shapes=shapes,
              err_share_of_tol=worst[ops.TENSOR_CORE_BWD][0],
              kernels_ms_at_llama=llama["kernels_ms"])
    f32 = _flash_bwd_time(SERVING_SHAPE, torch.float32, gen, dev, plain=True)
    print(f"[flash-bwd] {ops.CUDA_CORE_BWD} at the serving shape in float32: kernel "
          f"{f32['ms']:.4f} ms ({f32['ms'] / f32['bound_ms']:.2f}x its bound "
          f"{f32['bound_ms']:.4f} ms, {f32['bound_by']} at {FP32_OPS_PER_S / 1e12:g} TFLOP/s), "
          f"plain backward {f32['plain_ms']:.4f} ms, SDPA's float32 backward "
          f"(torch.autograd.grad) {f32['library_ms']:.4f} ms")
    cc = _record(ops.CUDA_CORE_BWD, ops.CUDA_CORE_BWD, tc["replaces"],
                 worst[ops.CUDA_CORE_BWD][1], f32["ms"], f32["plain_ms"], f32["bound_ms"],
                 f32["bound_by"], f32["library_ms"])
    cc["err_share_of_tol"] = worst[ops.CUDA_CORE_BWD][0]
    return [tc, cc]


def _median_s(fn, n: int) -> float:
    """Median host seconds of ``fn`` over ``n`` runs, each ending in a sync."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_serving(dev) -> dict:
    """The serving path; returns the flash launches by kernel: the bf16
    ``generate``'s and the float32 card-vs-CPU run's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer

    # 6a. the serving launcher at full width, as a user runs it
    flash_attention.launches = grid_argmin.launches = 0
    t0 = time.perf_counter()
    check(serve.main(["--no-reduced", "--device", "cuda"]) == 0, "serve.main failed")
    torch.cuda.synchronize()
    fa, ga = flash_attention.launches, grid_argmin.launches
    print(f"[serve] launch.serve --no-reduced --device cuda: {time.perf_counter() - t0:.2f} s, "
          f"flash_attention launches {fa}, grid_argmin launches {ga}")
    check(fa > 0 and ga > 0, "the serving launcher launched no flash_attention or grid_argmin")

    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in common.tree_leaves(params))
    print(f"[serve] {cfg.name} full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {n_params} float32 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    launches, by_kernel, _ = phase_generate(cfg, params, dev, flash_attention, "[serve]")
    want = {ops.TENSOR_CORE: cfg.n_layers, ops.CUDA_CORE: 0}
    check(by_kernel == want, f"one bf16 generate launched {by_kernel}, want {want}")
    flash_attention.kernel_launches.update(dict.fromkeys(want, 0))
    phase_float32_cuda_vs_cpu(cfg, params, dev, "[serve]")
    f32 = dict(flash_attention.kernel_launches)
    print(f"[serve] float32 path flash launches by kernel: {f32}")
    check(f32[ops.CUDA_CORE] > 0 and f32[ops.TENSOR_CORE] == 0,
          f"the float32 path launched {f32}, want the CUDA-core kernel only")
    phase_run_trace(dev)
    return {ops.TENSOR_CORE: launches, ops.CUDA_CORE: f32[ops.CUDA_CORE]}


def phase_generate(cfg, params, dev, op, tag: str, b: int = SERVE_BATCH,
                   s: int = SERVE_PROMPT, n_new: int = SERVE_NEW, capacity=None,
                   per_generate=None) -> tuple:
    """One timed ``generate`` at B = 4, a 2048-token prompt and 32 new
    tokens (or the shapes given), with ``op`` (the path's kernel wrapper)
    launched once per layer (or ``per_generate`` times); then a profiled
    prefill and a profiled window of decode steps.  Returns the launches of
    that ``generate``, where ``op`` has more than one kernel its launches
    by kernel, and a prefill's decode cache."""
    from repro_torch.serving.engine import ServeEngine

    engine = ServeEngine(cfg=cfg, params=params, capacity=capacity or s + n_new,
                         batch_size=b, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    name = op.__name__
    engine.generate(prompts, n_new)                     # warm
    op.launches = 0
    by_kernel = getattr(op, "kernel_launches", {})
    by_kernel.update(dict.fromkeys(by_kernel, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches, by_kernel = op.launches, dict(by_kernel)
    want = cfg.n_layers if per_generate is None else per_generate
    check(launches == want, f"one generate launched {name} {launches} times, want {want}")
    check(tuple(toks.shape) == (b, n_new) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"bad tokens {tuple(toks.shape)}")
    batch = {"tokens": prompts}
    with torch.inference_mode():
        prefill_s = _median_s(lambda: engine._prefill(engine._params, batch), 3)
        logits, cache = engine._prefill(engine._params, batch)
    decode_s = (gen_s - prefill_s) / (n_new - 1)
    print(f"{tag} ServeEngine.generate B={b} prompt={s} new={n_new} (bf16): "
          f"{gen_s:.4f} s, {b * n_new / gen_s:.1f} tokens/s; prefill {prefill_s * 1e3:.2f} ms "
          f"(median of 3), decode {decode_s * 1e3:.3f} ms per token; {name} "
          f"launches per generate {launches}{f' {by_kernel}' if by_kernel else ''}; "
          f"sample {toks[0, :8].tolist()}")

    # where the device time of one prefill goes, and how busy a decode step keeps it
    with torch.inference_mode():
        pre = _device_kernels(lambda: engine._prefill(engine._params, batch))
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        n_steps = 4

        def steps():
            c = cache
            for i in range(n_steps):
                pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
                _, c = engine._decode_step(engine._params, c, tok, pos)
        dec = _device_kernels(steps)
    if not pre or not dec:
        print(f"{tag} the profiler saw no device work: busy shares not measured")
        return launches, by_kernel, cache
    busy = sum(e.time_range.elapsed_us() for e in pre)
    mine = sum(e.time_range.elapsed_us() for e in pre if name in e.name)
    print(f"{tag} prefill profile: {len(pre)} device kernels, {busy / 1e3:.2f} ms busy "
          f"({busy / 1e3 / (prefill_s * 1e3):.1%} of the unprofiled prefill); "
          f"{name} {mine / 1e3:.2f} ms = {mine / busy:.1%} of busy time")
    print(f"{tag} prefill top kernels: {_top_kernels(pre, 1)}")
    busy_d = sum(e.time_range.elapsed_us() for e in dec) / n_steps
    print(f"{tag} decode profile, {n_steps} steps: {len(dec) / n_steps:.1f} device kernels "
          f"per step, {busy_d:.1f} us device busy per step = "
          f"{busy_d / (decode_s * 1e6):.1%} of the unprofiled {decode_s * 1e3:.3f} ms step")
    print(f"{tag} decode top kernels per step: {_top_kernels(dec, n_steps)}")
    return launches, by_kernel, cache


def phase_float32_cuda_vs_cpu(cfg, params, dev, tag: str, s: int = 128,
                              extra=None, atol: float = F32_LOGIT_ATOL) -> None:
    """The same full-width weights in float32, card vs CPU, in lockstep:
    the CPU's token feeds both, logits agree within ``atol`` at every
    step, tokens are equal unless the CPU's top-two gap is below it.
    ``extra`` (CPU tensors, e.g. ``patches``) joins the prefill's batch."""
    from repro_torch.models import common
    from repro_torch.serving.engine import ServeEngine, greedy_sample

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    n_tok = 4
    t0 = time.perf_counter()
    engines = {d: ServeEngine(cfg=cfg32, batch_size=1, capacity=s + n_tok, device=d,
                              params=common.tree_map(lambda t: t.to(d), params))
               for d in (dev, torch.device("cpu"))}
    prompts = torch.randint(0, cfg.vocab_size, (1, s),
                            generator=torch.Generator().manual_seed(2))
    out = {d: e._prefill(e._params, dict({k: t.to(d) for k, t in (extra or {}).items()},
                                         tokens=prompts.to(d)))
           for d, e in engines.items()}
    worst, flips, toks = 0.0, 0, []
    with torch.inference_mode():
        for step in range(n_tok):
            lg, lc = out[dev][0].cpu(), out[torch.device("cpu")][0]
            diff = (lg - lc).abs().max().item()
            worst = max(worst, diff)
            check(diff <= atol, f"float32 step {step}: logits cuda vs cpu "
                  f"max|Δ| {diff} > {atol}")
            tc, tg = greedy_sample(lc), greedy_sample(lg)
            top2 = lc.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).min().item()
            if not torch.equal(tc, tg):
                check(gap <= atol, f"float32 step {step}: tokens differ with "
                      f"a top-two gap of {gap}")
                flips += 1
            toks.append(int(tc[0]))
            if step + 1 == n_tok:
                break
            for d, e in engines.items():
                pos = torch.full((1,), s + step, dtype=torch.int32, device=d)
                _, cache = out[d]
                out[d] = e._decode_step(e._params, cache, tc.to(d)[:, None], pos)
    print(f"{tag} float32 full width, {cfg.n_layers} layers, B=1 S={s}, {n_tok} tokens, "
          f"cuda vs cpu: logits "
          f"max|Δ| {worst:.3g} (tol {atol}), token flips {flips}, tokens {toks}; "
          f"{time.perf_counter() - t0:.2f} s")


def phase_run_trace(dev) -> None:
    from repro_torch.core import controller as ctl
    from repro_torch.core import workload as wl
    from repro_torch.serving.autoscale import DvfsServingSimulator, RooflineTerms

    terms = RooflineTerms(t_compute=0.002, t_memory=0.012, t_collective=0.001)
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=512, seed=3))
    res = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[d] = {"tpu": {t: DvfsServingSimulator(terms=terms, technique=t, device=d)
                          .run_trace(trace) for t in ctl.DEFAULT_TECHNIQUES}}
        print(f"[serve] run_trace {d}, {len(ctl.DEFAULT_TECHNIQUES)} techniques x 512 "
              f"steps: {time.perf_counter() - t0:.2f} s")
    worst = _compare_summaries(res["cuda"], res["cpu"], "run_trace")
    print(f"[serve] run_trace cuda vs cpu: every Summary field within {SUMMARY_RTOL} "
          f"(worst rel {worst:.3g}), miss rates equal; " + " ".join(
              f"{t}={s.power_gain:.3f}x" for t, s in res["cuda"]["tpu"].items()))


def _scan_inputs(b, s, d, n, dtype, gen, dev):
    """delta, B, C, x, A_log drawn as tests/test_kernels_ssm.py draws them."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    delta = torch.nn.functional.softplus(r(b, s, d)) * 0.1
    return (delta.to(dtype), r(b, s, n).to(dtype), r(b, s, n).to(dtype),
            r(b, s, d).to(dtype), r(d, n) * 0.5)


def _scan_bound(ins, outs) -> tuple[float, str, str]:
    """Least time for the selective scan on this card: the inputs read and
    the outputs written once over HBM bandwidth, vs its operations — the
    fp32 ones (δ·A, the FMA a·h + u, du·B, the FMA of ⟨h, C⟩ per state
    element, δ·x per channel step) over the non-tensor-core peak, and one
    exponential per state element over the special-function units
    (16 per clock per SM at the card's maximum SM clock)."""
    delta, B = ins[0], ins[1]
    b, s, d = delta.shape
    elems = b * s * d * B.shape[-1]
    n_bytes = sum(t.numel() * t.element_size() for t in list(ins) + list(outs))
    return _scan_bound_of(n_bytes, elems, 6 * elems + b * s * d)


def _scan_bound_of(n_bytes: int, n_exp: int, fp32_ops: int) -> tuple[float, str, str]:
    """max(bytes over HBM bandwidth, max(fp32 ops over the non-tensor-core
    peak, exponentials over the SFUs at the card's maximum SM clock)), in ms,
    with what bounds it and the terms."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_fp32 = fp32_ops / FP32_OPS_PER_S
    t_exp = n_exp / (SFU_PER_SM_CLOCK * sms * float(smi) * 1e6)
    t_ops = max(t_fp32, t_exp)
    detail = (f"{n_bytes / 1e6:.1f} MB in {t_bytes * 1e3:.4f} ms, {n_exp / 1e9:.3f} G exp in "
              f"{t_exp * 1e3:.4f} ms ({sms} SMs at {smi} MHz), fp32 ops in "
              f"{t_fp32 * 1e3:.4f} ms")
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), detail


def _scan_build_check() -> None:
    """The built scan kernel: its ptxas report shows no spills, and its SASS
    holds the SFU's ex2 (MUFU.EX2) and ``cp.async`` (LDGSTS)."""
    from repro_torch.kernels import _build

    lib = _build.library_path("ssm_scan")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[scan] ptxas: {line.strip()[:140]}")
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            check(not any(spills), f"the scan kernel spills: {line.strip()}")
    print(f"[scan] SASS: {_sass_check(_sass(lib), lib.name, ('MUFU.EX2', 'LDGSTS'))}")


def _offset_copy(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``k`` elements into its buffer."""
    view = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape)
    return view.copy_(t)


def _scan_case_check(name: str, ins) -> float:
    """``selective_scan`` against its plain version on ``ins``; the larger
    of y's and h's max |difference|."""
    from repro_torch.kernels.ssm_scan import selective_scan, selective_scan_ref

    dtype = ins[3].dtype
    tol = SCAN_TOL[dtype]
    y, h = selective_scan(*ins)
    yr, hr = selective_scan_ref(*ins)
    torch.cuda.synchronize()
    check(y.dtype == dtype and y.shape == ins[3].shape and h.dtype == torch.float32
          and h.shape == hr.shape, f"selective_scan {name}: bad output")
    check(torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol)
          and torch.allclose(h, hr, rtol=tol, atol=tol),
          f"selective_scan {name}: differs from the plain version beyond {tol}")
    err_y = (y.float() - yr.float()).abs().max().item()
    err_h = (h - hr).abs().max().item()
    print(f"[scan] {name} {str(dtype)[6:]}: max|Δy| {err_y:.3g}, max|Δh| {err_h:.3g} vs "
          f"plain (tol {tol}); max|y| {yr.float().abs().max().item():.3g}")
    return max(err_y, err_h)


def _scan_bwd_build_check() -> None:
    """The built backward kernel: no spills, MUFU.EX2 in its SASS."""
    from repro_torch.kernels import _build

    lib = _build.library_path("ssm_scan_bwd")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[scan-bwd] ptxas: {line.strip()[:140]}")
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            check(not any(spills), f"the scan backward kernel spills: {line.strip()}")
    print(f"[scan-bwd] SASS: {_sass_check(_sass(lib), lib.name, ('MUFU.EX2',))}")


def _scan_bwd_inputs(case, gen, dev):
    """Inputs, the forward's boundary store and cotangents dy, dh of a case."""
    from repro_torch.kernels.ssm_scan import ops

    b, s, d, n = case
    ins = _scan_inputs(b, s, d, n, torch.float32, gen, dev)
    y, h, bnd = ops._forward(*ins, store=True)
    dy = torch.randn(b, s, d, generator=gen, device=dev)
    dh = torch.randn(b, d, n, generator=gen, device=dev)
    return ins, bnd, dy, dh, (y, h)


def _scan_bwd_bound(ins, bnd, dy, dh, grads) -> tuple[float, str, str]:
    """Least time for the scan's backward: its inputs (δ, B, C, x, A_log, the
    boundary states, dy, dh) read and its gradients written once over HBM
    bandwidth, vs its operations per state element: one exponential a_t,
    which the walk back can keep from the recompute of the chunk's states,
    and 22 fp32 operations — the recompute's δ·A, du·B and FMA a·h + u (4),
    g = dy·C + a·g (3), a·h_{t−1} and A·(a·h_{t−1}) (2), x·B + that (2), and
    the FMAs into dδ, dx, dB, dC (8) and into dA_log (g·a·h_{t−1}, then ·δ;
    3)."""
    b, s, d = ins[0].shape
    elems = b * s * d * ins[1].shape[-1]
    n_bytes = sum(t.numel() * t.element_size() for t in (*ins, bnd, dy, dh, *grads))
    return _scan_bound_of(n_bytes, elems, 22 * elems)


def _scan_backward_kernel(dev) -> dict:
    """7b. The backward kernel against ``backward.selective_scan_bwd_ref`` on
    the same inputs and boundary store, two launches bit-equal; the store
    against a plain re-scan and the store-less launch; times at the serving
    shape: the backward, its plain version, its bound, and the forward
    with and without the store."""
    from repro_torch.kernels.ssm_scan import ops, selective_scan, selective_scan_bwd_ref
    from repro_torch.kernels.ssm_scan.backward import scan_boundaries

    _scan_bwd_build_check()
    gen = torch.Generator(device=dev).manual_seed(3)
    max_err = 0.0
    for case in SCAN_BWD_CASES:
        ins, bnd, dy, dh, (y, h) = _scan_bwd_inputs(case, gen, dev)
        y0, h0 = selective_scan(*ins)
        check(torch.equal(y, y0) and torch.equal(h, h0),
              f"{case}: the storing forward's y, h differ from the serving launch's")
        if case[1] < 2048:
            ref_bnd = scan_boundaries(ins[0], ins[1], ins[3], ins[4])
            tol = SCAN_TOL[torch.float32]
            check(torch.allclose(bnd, ref_bnd, rtol=tol, atol=tol),
                  f"{case}: boundary store differs from a plain re-scan beyond {tol}")
            check(torch.equal(bnd[:, -1], h), f"{case}: the last boundary is not h_final")
        g1 = ops.selective_scan_bwd(*ins, bnd, dy, dh)
        g2 = ops.selective_scan_bwd(*ins, bnd, dy, dh)
        ref = selective_scan_bwd_ref(*ins, dy, dh, boundary=bnd)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(g1, g2)),
              f"{case}: two backward launches differ")
        errs = []
        for name, a, r in zip(("dδ", "dB", "dC", "dx", "dA_log"), g1, ref):
            scale = max(r.abs().max().item(), 1e-30)   # dA_log is 0 at S = 1 (h_0 = 0)
            err = (a - r).abs().max().item()
            check(a.shape == r.shape and err <= SCAN_BWD_TOL * scale,
                  f"{case} {name}: max|Δ| {err} > {SCAN_BWD_TOL} x {scale}")
            errs.append(err / scale)
            max_err = max(max_err, err)
        print(f"[scan-bwd] {case}: each gradient vs the plain backward, max|Δ| / max|g|: "
              + ", ".join(f"{v:.3g}" for v in errs) + f" (tol {SCAN_BWD_TOL}); two launches "
              f"bit-equal")
        del ins, bnd, dy, dh, g1, g2, ref, y, h, y0, h0
        torch.cuda.empty_cache()

    ins, bnd, dy, dh, _ = _scan_bwd_inputs(SCAN_BWD_CASES[-1], gen, dev)
    grads = ops.selective_scan_bwd(*ins, bnd, dy, dh)
    launches_before = selective_scan.bwd_launches
    ms = device_time_ms(lambda: ops.selective_scan_bwd(*ins, bnd, dy, dh), 10)
    plain_ms = device_time_ms(lambda: selective_scan_bwd_ref(*ins, dy, dh, boundary=bnd), 1)
    bound_ms, bound_by, detail = _scan_bwd_bound(ins, bnd, dy, dh, grads)
    fwd = {}
    for label in ("plain", "store", "store", "plain"):
        store = label == "store"
        fwd.setdefault(label, []).append(
            device_time_ms(lambda: ops._forward(*ins, store=store), 20))
    print(f"[scan-bwd] serving shape {SCAN_BWD_CASES[-1]} fp32, medians: backward kernel "
          f"{ms:.4f} ms ({ms / bound_ms:.2f}x the bound), plain backward {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {detail}); "
          f"{selective_scan.bwd_launches - launches_before} timing launches")
    print(f"[scan-bwd] the forward at the serving shape, in turns (no store, store, store, no "
          f"store): without the boundary store {fwd['plain'][0]:.4f} / {fwd['plain'][1]:.4f} ms, "
          f"with it (training) {fwd['store'][0]:.4f} / {fwd['store'][1]:.4f} ms")
    rec = _record("selective_scan_bwd", "ssm_scan_bwd", "src/repro/kernels/ssm_scan/kernel.py:30",
                  max_err, ms, plain_ms, bound_ms, bound_by, None)
    rec["forward_store_ms"], rec["forward_no_store_ms"] = fwd["store"], fwd["plain"]
    return rec


def phase_scan_kernels(dev) -> tuple:
    from repro_torch.kernels.ssm_scan import selective_scan, selective_scan_ref

    _scan_build_check()
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for case in SCAN_CASES + [SCAN_SERVING]:
        max_err = max(max_err, _scan_case_check(str(case[:4]), _scan_inputs(*case, gen, dev)))
    for case, k_delta, k_x in SCAN_OFFSET_CASES:
        delta, B, C, x, A_log = _scan_inputs(*case, gen, dev)
        ins = (_offset_copy(delta, k_delta), B, C, _offset_copy(x, k_x), A_log)
        check(ins[0].data_ptr() % 16 != 0, "the offset case's delta starts on a boundary")
        max_err = max(max_err, _scan_case_check(
            f"{case[:4]} delta, x {k_delta}, {k_x} elements off", ins))

    ins = _scan_inputs(*SCAN_SERVING, gen, dev)
    y, h = selective_scan(*ins)
    launches_before = selective_scan.launches
    ms = device_time_ms(lambda: selective_scan(*ins), 20)
    plain_ms = device_time_ms(lambda: selective_scan_ref(*ins), 3)
    bound_ms, bound_by, detail = _scan_bound(ins, (y, h))
    print(f"[scan] serving shape {SCAN_SERVING[:4]} fp32, medians: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {detail}); "
          f"{selective_scan.launches - launches_before} timing launches")
    del ins, y, h
    torch.cuda.empty_cache()
    fwd = _record("selective_scan", "ssm_scan", "src/repro/kernels/ssm_scan/kernel.py:30",
                  max_err, ms, plain_ms, bound_ms, bound_by, None)
    return fwd, _scan_backward_kernel(dev)


def phase_mamba_serving(dev) -> int:
    from repro_torch.configs import get_config
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.kernels.ssm_scan import selective_scan
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer

    torch.cuda.empty_cache()    # earlier phases' weights are gone; free their blocks
    # 8a. the serving launcher at full width, as a user runs it
    selective_scan.launches = grid_argmin.launches = 0
    t0 = time.perf_counter()
    check(serve.main(["--arch", MAMBA_ARCH, "--no-reduced", "--device", "cuda"]) == 0,
          "serve.main failed")
    torch.cuda.synchronize()
    ss, ga = selective_scan.launches, grid_argmin.launches
    print(f"[mamba] launch.serve --arch {MAMBA_ARCH} --no-reduced --device cuda: "
          f"{time.perf_counter() - t0:.2f} s, selective_scan launches {ss}, grid_argmin "
          f"launches {ga}")
    check(ss > 0 and ga > 0, "the serving launcher launched no selective_scan or grid_argmin")
    torch.cuda.empty_cache()

    cfg = get_config(MAMBA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in common.tree_leaves(params))
    print(f"[mamba] {cfg.name} full width: {cfg.n_layers} Mamba-1 layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.ssm.d_inner(cfg.d_model)}, d_state {cfg.ssm.d_state}, "
          f"vocab {cfg.vocab_size}: {n_params} float32 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    launches, _, _ = phase_generate(cfg, params, dev, selective_scan, "[mamba]")
    print(f"[mamba] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(float32 weights and the engine's bf16 copy)")

    # 8e. float32 card vs CPU on the first layers of the same weights
    cut = dataclasses.replace(cfg, n_layers=MAMBA_F32_LAYERS)
    few = dict(params, slots=[common.tree_map(lambda t: t[:MAMBA_F32_LAYERS],
                                              params["slots"][0])])
    phase_float32_cuda_vs_cpu(cut, few, dev, "[mamba]")
    return launches


def _bench_derived(prefixes) -> dict:
    """``name → derived`` of BENCH_fleet.json's rows under ``prefixes``."""
    with open(os.path.join(ROOT, "BENCH_fleet.json")) as fh:
        benches = json.load(fh)["benches"]
    return {k: v["derived"] for k, v in sorted(benches.items())
            if k.split("/")[0] in prefixes}


def _figure_run(key: str, dev, trace_1024):
    """The run behind one figure row, as ``benchmarks/run.py`` builds it:
    ``(Summary, TraceResult or None)``."""
    from repro_torch.core import controller as ctl
    from repro_torch.core.accelerators import ACCELERATORS

    fig, *rest = key.split("/")
    if fig == "fig4":
        plat = ctl.analytic_platform(alpha=0.2, beta=0.4)
        return ctl.run_technique(plat, np.full(256, float(rest[0][4:])), rest[1], n_nodes=64,
                                 device=dev), None
    if fig in ("fig5", "fig6"):
        value = float(rest[0][5:] if fig == "fig5" else rest[0][4:])
        plat = (ctl.analytic_platform(alpha=value, beta=0.4) if fig == "fig5"
                else ctl.analytic_platform(alpha=0.2, beta=value))
        return ctl.run_technique(plat, np.full(256, 0.5), rest[1], device=dev), None
    plat = ctl.fpga_platform(ACCELERATORS[rest[0]])
    cfg = ctl.ControllerConfig(technique="proposed")
    res = ctl.simulate(plat, cfg, trace_1024, device=dev)
    return ctl.summarize(plat, cfg, trace_1024, res), res


def phase_figures(dev) -> None:
    """Every figure row of BENCH_fleet.json on the card, against the file
    and against the same rows on the CPU."""
    from repro_torch.core import workload as wl
    from repro_torch.kernels.grid_argmin import grid_argmin

    rows = _bench_derived(FIGURES)
    check(len(rows) == 56, f"BENCH_fleet.json holds {len(rows)} figure rows, want 56")
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=BENCH_STEPS, seed=0))
    grid_argmin.launches = 0
    t0 = time.perf_counter()
    cuda = {key: _figure_run(key, dev, trace) for key in rows}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = grid_argmin.launches
    want = sum(1 for k in rows if not k.endswith(("/power_gating", "/nominal")))
    check(launches == want, f"the figure rows launched grid_argmin {launches} times, want {want}")
    print(f"[figures] {len(rows)} rows on cuda in {wall:.2f} s, grid_argmin launches {launches} "
          f"(one per DVFS table build; power gating is closed form)")
    worst = 0.0
    for key, derived in rows.items():
        s, res = cuda[key]
        bench = float(re.search(r"gain=([0-9.]+)x", derived).group(1))
        worst = max(worst, abs(s.power_gain - bench))
        check(abs(s.power_gain - bench) <= GAIN_ATOL,
              f"{key}: gain {s.power_gain} vs BENCH_fleet.json {derived}")
        if key.startswith("fig10/"):
            vc, vb = res.v_core.cpu().numpy(), res.v_bram.cpu().numpy()
            got = (f"vcore=[{vc.min():.2f},{vc.max():.2f}];vbram=[{vb.min():.2f},{vb.max():.2f}]"
                   f";mispred={s.misprediction_rate:.3f};qos_viol={s.qos_violation_rate:.3f}")
            check(derived.split(";", 1)[1] == got, f"{key}: {got} vs {derived}")
            print(f"[figures] {key}: gain={s.power_gain:.4f}x;{got}")
        elif key.startswith("fig12/"):
            got = f"min_vbram={res.v_bram.min().item():.2f}"
            check(derived.split(";", 1)[1] == got, f"{key}: {got} vs {derived}")
    print(f"[figures] all {len(rows)} gains within {GAIN_ATOL} of BENCH_fleet.json (worst |Δ| "
          f"{worst:.4f}); fig10's voltage ranges and rates and fig12's lowest BRAM voltage equal")
    t0 = time.perf_counter()
    cpu = {key: _figure_run(key, "cpu", trace)[0] for key in rows}
    worst = _compare_summaries({"figures": {k: v[0] for k, v in cuda.items()}},
                               {"figures": cpu}, "figures")
    print(f"[figures] the same rows on the CPU in {time.perf_counter() - t0:.2f} s: every "
          f"Summary field within {SUMMARY_RTOL} (worst rel {worst:.3g}), miss rates equal")


def _compare_campaigns(got: dict, want: dict, label: str) -> float:
    """Two ``run_campaign`` results (or their JSON): every cell within
    SUMMARY_RTOL relative, miss rates and Pareto fronts equal."""
    check(list(got["scenarios"]) == list(want["scenarios"]), f"{label}: scenarios differ")
    worst = 0.0
    for plat, per_tech in want["table"].items():
        for tech, per_scen in per_tech.items():
            for scen, cell in per_scen.items():
                for key, ref in cell.items():
                    x, y = np.asarray(got["table"][plat][tech][scen][key]), np.asarray(ref)
                    where = f"{label} {plat}/{tech}/{scen} {key}"
                    if key in MISS_FIELDS:
                        check(np.array_equal(x, y), f"{where}: {x} vs {y}")
                        continue
                    rel = float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-12)))
                    worst = max(worst, rel)
                    check(rel <= SUMMARY_RTOL or float(np.max(np.abs(x - y))) <= 1e-12,
                          f"{where}: {x} vs {y}")
    fronts = {p: {s: list(f) for s, f in v.items()} for p, v in got["pareto"].items()}
    check(fronts == {p: {s: list(f) for s, f in v.items()} for p, v in want["pareto"].items()},
          f"{label}: Pareto fronts differ")
    return worst


def _stream_profile(dev, cells) -> tuple:
    """µs per step of the streaming loop at the default campaign's fleet,
    unprofiled, and its device kernels and busy µs per step in a short
    ``torch.profiler`` window."""
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import scenarios as scn
    from repro_torch.core.accelerators import ACCELERATORS

    platforms = [ctl.fpga_platform(a) for a in ACCELERATORS.values()]
    cfg = ctl.ControllerConfig()
    names, traces, avail = scn.build_suite(None, n_steps=4 * PROFILE_STEPS)
    params = char.stack_platform_params([p.params for p in platforms])
    tables = ctl.fleet_bin_tables(params, cfg, ("proposed", "power_gating", "hybrid"),
                                  device=dev)
    tab = ctl.BinTables(*[x[:, :, None].expand(x.shape[:2] + (len(names),) + x.shape[2:])
                          for x in tables])
    check(int(np.prod(tab.capacity.shape[:-1])) == cells, "profile fleet differs")
    return _profile_stream_loop(dev, tab, traces, avail, cfg)


def _profile_stream_loop(dev, tab, traces, avail, cfg) -> tuple:
    """``simulate_fleet_stream`` over ``tab`` ``[P, T, N, M]`` and the
    scenario suite's ``[N, S]`` traces (S ≥ 4·PROFILE_STEPS): seconds a
    step, unprofiled (median of 3 runs of 4·PROFILE_STEPS steps), then the
    device kernels and busy µs per step of a PROFILE_STEPS-step profile
    (``None`` where the profiler saw no device work)."""
    from repro_torch.core import controller as ctl

    def run(n):
        ctl.simulate_fleet_stream(tab, traces[None, None, :, :n], cfg, chunk_size=n,
                                  avail=avail[None, None, :, :n], device=dev)

    run(PROFILE_STEPS)
    step_s = _median_s(lambda: run(4 * PROFILE_STEPS), 3) / (4 * PROFILE_STEPS)
    kernels = _device_kernels(lambda: run(PROFILE_STEPS))
    if not kernels:
        return step_s, None, None
    busy = sum(e.time_range.elapsed_us() for e in kernels) / PROFILE_STEPS
    return step_s, len(kernels) / PROFILE_STEPS, busy


def _derived_tokens(derived: str) -> list:
    """``k=v;…`` → ``[(key, token), …]``, a value's ``/``-parts apart."""
    return [(k, tok) for item in derived.split(";") for k, v in [item.split("=", 1)]
            for tok in v.split("/")]


def _check_bench_row(name: str, got: str, want: str, n_steps: int) -> None:
    """A BENCH row rebuilt by the port (``got``, at full precision) against
    the file's (``want``): gains (``…x``), ``avail`` and ``power_w`` within
    0.006, ratios within 0.0006, rates within 2/S, the rest equal."""
    g, w = _derived_tokens(got), _derived_tokens(want)
    check([k for k, _ in g] == [k for k, _ in w], f"{name}: keys {got} vs {want}")
    rate_keys = ("qos_viol", "qos", "worst_tenant_qos", "t_viol", "t_starve")
    for (key, a), (_, b) in zip(g, w):
        if key in ("front", "ok", "qos_ok", "samples", "interval_s"):
            check(a == b, f"{name}: {key} {a} vs {b} ({got} vs {want})")
            continue
        rate = key in rate_keys or b.startswith("q")
        x, y = float(a.strip("qx")), float(b.strip("qx"))
        tol = (2.0 / n_steps if rate else GAIN_ATOL if b.endswith("x")
               or key in ("avail", "power_w") else 6e-4)
        check(abs(x - y) <= tol, f"{name}: {key} {x} vs {y} beyond {tol} ({got} vs {want})")


def _bench_campaign_rows(dev) -> dict:
    """benchmarks/run.py's campaign, failure, replay and scheduler rows at
    1024 steps through the port on ``dev``, numbers at full precision; the
    retrace counters (``*/stream_reuse``) have no counterpart."""
    from repro_torch.core import controller as ctl
    from repro_torch.core import scenarios as scn
    from repro_torch.core import traces as tr
    from repro_torch.core.accelerators import ACCELERATORS

    n, chunk = BENCH_STEPS, BENCH_CHUNK
    two = [ctl.fpga_platform(ACCELERATORS[a]) for a in ("tabla", "stripes")]
    tabla = [ctl.fpga_platform(ACCELERATORS["tabla"])]
    rows = {}

    def mean_cell(out, plats, tech, scen):
        cell = [out["table"][p.name][tech][scen] for p in plats]
        return {k: float(np.mean([c[k] for c in cell]))
                for k in ("power_gain", "power_gain_vs_configured", "mean_avail_nodes",
                          "qos_violation_rate")}

    techs = ("proposed", "power_gating", "hybrid")
    names = ("burse", "diurnal", "flash_crowd", "node_failure")
    out = scn.run_campaign(two, scenario_names=names, techniques=techs, n_steps=n,
                           chunk_size=chunk, device=dev)
    for scen in names:
        g = {t: mean_cell(out, two, t, scen)["power_gain"] for t in techs}
        q = mean_cell(out, two, "proposed", scen)["qos_violation_rate"]
        rows[f"campaign/{scen}"] = (f"prop={g['proposed']:.6f}x;pg={g['power_gating']:.6f}x"
                                    f";hyb={g['hybrid']:.6f}x;qos_viol={q:.6f}")

    techs = ("proposed", "power_gating", "hybrid", "headroom")
    fails = ("node_failure", "rack_failure", "cascade", "flaky_fleet")
    out = scn.run_campaign(two, scenario_names=("burse",) + fails, techniques=techs,
                           n_steps=n, chunk_size=chunk, device=dev)
    for tech in techs:
        c = mean_cell(out, two, tech, "node_failure")
        rows[f"failure/node_failure/{tech}"] = (
            f"gain={c['power_gain']:.6f}x;vs_cfg={c['power_gain_vs_configured']:.6f}x"
            f";avail={c['mean_avail_nodes']:.6f};qos_viol={c['qos_violation_rate']:.6f}")
    for scen in fails[1:]:
        h, y = mean_cell(out, two, "hybrid", scen), mean_cell(out, two, "headroom", scen)
        rows[f"failure/{scen}"] = (f"hyb={h['power_gain']:.6f}x/q{h['qos_violation_rate']:.6f}"
                                   f";hr={y['power_gain']:.6f}x/q{y['qos_violation_rate']:.6f}"
                                   f";avail={y['mean_avail_nodes']:.6f}")
    for scen in fails:
        front = scn.pareto_front({t: mean_cell(out, two, t, scen) for t in techs})
        rows[f"failure/pareto/{scen}"] = "front=" + ",".join(front)
    g = mean_cell(out, two, "headroom", "node_failure")
    ok = g["qos_violation_rate"] < 0.5 and g["power_gain"] >= 2.5
    rows["failure/headroom_gate"] = (f"qos_viol={g['qos_violation_rate']:.6f}"
                                     f";gain={g['power_gain']:.6f}x;ok={int(ok)}")

    replays = ("replay_azure_vm_cpu", "replay_google_cluster", "cloud_mix")
    techs = ("proposed", "power_gating", "hybrid")
    out = scn.run_campaign(tabla, scenario_names=replays, techniques=techs, n_steps=n,
                           chunk_size=chunk, device=dev)
    row = out["table"][tabla[0].name]
    for scen in replays:
        rows[f"replay/{scen}"] = (f"prop={row['proposed'][scen]['power_gain']:.6f}x"
                                  f";hyb={row['hybrid'][scen]['power_gain']:.6f}x"
                                  f";qos={row['proposed'][scen]['qos_violation_rate']:.6f}")
    for name, src in sorted(tr.bundled_sources().items()):
        rows[f"replay/source/{name}"] = (f"samples={src.n_samples};interval_s={src.interval_s:g}"
                                         f";mean={src.utilization.mean():.6f}")

    cells = {}
    for label, tech, sched in (("sched_dvfs", "hybrid", "priority"),
                               ("dvfs_only", "hybrid", "none"),
                               ("placement_only", "power_gating", "priority")):
        out = scn.run_campaign(tabla, techniques=(tech,), scheduler=sched,
                               scenario_names=("multi_tenant",), n_steps=n, chunk_size=chunk,
                               tenants=3, device=dev)
        c = cells[label] = out["table"][tabla[0].name][tech]["multi_tenant"]
        rows[f"scheduler/{label}"] = (
            f"power_w={c['mean_power_w']:.6f}"
            f";worst_tenant_qos={c['worst_tenant_qos_violation']:.6f}"
            ";t_viol=" + "/".join(f"{v:.6f}" for v in c["tenant_qos_violation_rate"])
            + ";t_starve=" + "/".join(f"{v:.6f}" for v in c["tenant_starvation_rate"]))
    s, d, p = (cells[k] for k in ("sched_dvfs", "dvfs_only", "placement_only"))
    worst = "worst_tenant_qos_violation"
    qos_ok = s[worst] <= d[worst] + 1e-9 and s[worst] <= p[worst] + 1e-9
    rows["scheduler/cooptimization"] = (
        f"power_vs_dvfs_only={s['mean_power_w'] / d['mean_power_w']:.6f}"
        f";power_vs_placement_only={s['mean_power_w'] / p['mean_power_w']:.6f}"
        f";qos_ok={int(qos_ok)}")
    return rows


def phase_campaign(dev) -> None:
    """The campaign CLI (its defaults, CAMPAIGN_CLI_STEPS steps) on the card
    and on the CPU, its
    step loop's profile, and BENCH_fleet.json's campaign-path rows."""
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.launch import campaign

    tables, res = {}, {}

    def cli(argv, device):
        # the printed table has a block per scenario: the first is shown
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()) as out:
            path = os.path.join(tmp, "campaign.json")
            rc = campaign.main(argv + ["--json", path])
            with open(path) as fh:
                res[device] = json.load(fh)
        tables[device] = out.getvalue()
        return rc

    grid_argmin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    argv = ["--steps", str(CAMPAIGN_CLI_STEPS)]
    check(cli(argv, "cuda") == 0, "campaign.main failed on cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = grid_argmin.launches
    check(launches == 1, f"the campaign launched grid_argmin {launches} times, want 1")
    t0 = time.perf_counter()
    check(cli(argv + ["--device", "cpu"], "cpu") == 0, "campaign.main failed on the CPU")
    cpu_s = time.perf_counter() - t0
    first = tables["cuda"].split("\n\n")[1]
    print("\n".join(f"[campaign]   {line}" for line in first.splitlines()))
    steps = res["cuda"]["n_steps"]
    cells = sum(len(s) for t in res["cuda"]["table"].values() for s in t.values())
    worst = _compare_campaigns(res["cuda"], res["cpu"], "campaign")
    print(f"[campaign] python -m repro_torch.launch.campaign (defaults, --steps "
          f"{CAMPAIGN_CLI_STEPS}: {cells} cells x "
          f"{steps} steps, chunk 1024) on cuda: {wall:.2f} s, {wall / steps * 1e6:.1f} us per "
          f"step, grid_argmin launches {launches}; on the CPU {cpu_s:.2f} s; every cell "
          f"within {SUMMARY_RTOL} (worst rel {worst:.3g}), miss rates and Pareto fronts equal")
    step_s, per_step, busy = _stream_profile(dev, cells)
    if per_step is None:
        print("[campaign] the profiler saw no device work: kernels per step and busy share "
              "not measured")
    else:
        print(f"[campaign] streaming loop at {cells} cells: {step_s * 1e6:.1f} us per step "
              f"(median of 3 runs of {4 * PROFILE_STEPS} steps); profile of {PROFILE_STEPS} "
              f"steps: {per_step:.1f} device kernels per step, {busy:.1f} us device busy per "
              f"step = {busy / (step_s * 1e6):.1%} of the unprofiled step")

    bench = _bench_derived(("campaign", "failure", "replay", "scheduler"))
    t0 = time.perf_counter()
    grid_argmin.launches = 0
    got = _bench_campaign_rows(dev)
    torch.cuda.synchronize()
    rows_s, launches = time.perf_counter() - t0, grid_argmin.launches
    skipped = sorted(k for k in bench if k.endswith(("/stream_reuse", "stream_reuse_onoff",
                                                     "stream_reuse_tenant_width")))
    check(sorted(got) == sorted(set(bench) - set(skipped)),
          f"BENCH rows differ: {sorted(set(got) ^ (set(bench) - set(skipped)))}")
    for name in sorted(got):
        _check_bench_row(name, got[name], bench[name], BENCH_STEPS)
    print(f"[campaign] {len(got)} campaign/failure/replay/scheduler rows of BENCH_fleet.json "
          f"on cuda at {BENCH_STEPS} steps in {rows_s:.2f} s (grid_argmin launches "
          f"{launches}): gains within {GAIN_ATOL}, rates within 2/S, fronts and flags equal")
    for name in ("failure/headroom_gate", "scheduler/cooptimization"):
        print(f"[campaign]   {name}: {got[name]}")
    print(f"[campaign] skipped {skipped}: they count JAX retraces, which the port has no "
          f"counter for yet (ROADMAP A13)")


def phase_long_stream(dev) -> None:
    """One scenario's campaign at LONG_STEPS (2048 and 4096) steps in
    LONG_CHUNK-step chunks: the peak device memory must not grow with the
    trace, and the longer run's cells match a CPU run."""
    from repro_torch.core import controller as ctl
    from repro_torch.core import scenarios as scn
    from repro_torch.core.accelerators import ACCELERATORS

    platforms = [ctl.fpga_platform(a) for a in ACCELERATORS.values()]
    kw = dict(scenario_names=(LONG_SCENARIO,), techniques=("proposed", "power_gating", "hybrid"),
              chunk_size=LONG_CHUNK)
    peaks, out = {}, {}
    for n in LONG_STEPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[n] = scn.run_campaign(platforms, n_steps=n, device=dev, **kw)
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated()
        print(f"[long] {LONG_SCENARIO} x {len(platforms)} accelerators x 3 techniques, {n} "
              f"steps in {LONG_CHUNK}-step chunks on cuda: {time.perf_counter() - t0:.2f} s, "
              f"peak device memory {peaks[n]} bytes")
    short, long_ = LONG_STEPS
    grow = peaks[long_] - peaks[short]
    check(abs(grow) <= PEAK_SLACK_BYTES, f"peak device memory grew by {grow} bytes from "
          f"{short} to {long_} steps")
    t0 = time.perf_counter()
    cpu = scn.run_campaign(platforms, n_steps=long_, device="cpu", **kw)
    worst = _compare_campaigns(out[long_], cpu, "long stream")
    print(f"[long] peak device memory at {long_} steps - at {short}: {grow} bytes (limit "
          f"{PEAK_SLACK_BYTES}); the {long_}-step cells on the CPU ({time.perf_counter() - t0:.2f}"
          f" s) within {SUMMARY_RTOL} (worst rel {worst:.3g}), miss rates equal")


def _predictor_config(kind: str, **kw):
    from repro_torch.core import predictors as pred

    return pred.PredictorConfig(kind=kind, n_bins=25, warmup_steps=32, margin_bins=1, **kw)


def _predictor_rows(dev) -> tuple:
    """benchmarks/run.py's predictor sweep through the port on ``dev``, at
    full precision: ``(rows, campaigns, trace_evals)``; one campaign per
    family over the fifteen scenarios, seasonal_naive one per detected
    period."""
    from repro_torch.core import controller as ctl
    from repro_torch.core import predictors as pred
    from repro_torch.core import scenarios as scn
    from repro_torch.core import workload as wl
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.core.predictors import seasonal

    plat = ctl.fpga_platform(ACCELERATORS["tabla"])
    names = tuple(sorted(scn.SCENARIOS))
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=PRED_STEPS, seed=0))
    rows, camps, evals = {}, {}, {}
    for kind in pred.available():
        cfg = _predictor_config(kind)
        ev = evals[kind] = pred.evaluate_trace(cfg, trace, device=dev)
        rows[f"predictor/{kind}/trace"] = (f"exact={float(ev.exact_accuracy)}"
                                           f";margin={float(ev.margin_accuracy)}")
        groups = {0: names}
        if kind == "seasonal_naive":
            groups = {}
            for scen in names:
                period = seasonal.detect_period(scn.get_scenario(scen).trace(PRED_STEPS, seed=0))
                groups.setdefault(period, []).append(scen)
        for season, group in sorted(groups.items()):
            out = camps[(kind, season)] = scn.run_campaign(
                [plat], scenario_names=tuple(group), techniques=("proposed",),
                n_steps=PRED_STEPS, chunk_size=PRED_CHUNK,
                predictor=dataclasses.replace(cfg, season=season), device=dev)
            for scen in out["scenarios"]:
                cell = out["table"][plat.name]["proposed"][scen]
                rows[f"predictor/{kind}/{scen}"] = (
                    f"exact={1.0 - cell['misprediction_rate']}"
                    f";margin={1.0 - cell['margin_misprediction_rate']}"
                    f";gain={cell['power_gain']}x;qos={cell['qos_violation_rate']}")
    return rows, camps, evals


def _dip_trace(n: int) -> np.ndarray:
    """A 16-step tile whose phases 3 and 11 lie below 1/M (M = 25)."""
    tile = np.linspace(0.2, 0.9, 16).astype(np.float32)
    tile[[3, 11]] = [0.01, 0.03]
    return np.tile(tile, -(-n // 16))[:n]


def _seasonal_dips(dev) -> None:
    """seasonal_naive's exact-phase forecast is −1 at the dips: the shared
    shell clips it to bin 0, so the fleet loops gather no negative index.
    Each technique's run on the card must finish and equal the CPU's."""
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import predictors as pred
    from repro_torch.core.accelerators import ACCELERATORS

    params = char.stack_platform_params([ctl.fpga_platform(ACCELERATORS["tabla"]).params])
    trace = _dip_trace(96)
    pcfg = pred.PredictorConfig(kind="seasonal_naive", n_bins=25, warmup_steps=4,
                                margin_bins=1, season=16)
    raw = pred.get("seasonal_naive").predict_inner(
        pcfg, pred.evaluate_trace(pcfg, trace[:19], device=dev).final_state.inner)
    check(int(raw[0]) == -1, f"the dip trace's raw forecast at step 19 is {int(raw[0])}, not -1")
    for tech in ("proposed", "hybrid", "headroom"):
        cfg = ctl.ControllerConfig(technique=tech, predictor=pcfg)
        out = {}
        for d in (dev, "cpu"):
            tab = ctl.fleet_bin_tables(params, cfg, (tech,), device=d)
            out[str(d)] = (ctl.simulate_fleet(tab, trace, cfg, device=d),
                           ctl.simulate_fleet_stream(tab, trace, cfg, chunk_size=40,
                                                     emit=("predicted_bin",), device=d))
        torch.cuda.synchronize()
        (res, stream), (cres, cstream) = out[str(dev)], out["cpu"]
        bins = res.predicted_bin.cpu().numpy()
        check(np.array_equal(bins, cres.predicted_bin.numpy()), f"dips/{tech}: bins differ")
        check(np.array_equal(stream.emitted["predicted_bin"], cstream.emitted["predicted_bin"]),
              f"dips/{tech}: stream bins differ")
        check((bins[0, 0, 20:][trace[20:] < 1 / 25] == 0).all(), f"dips/{tech}: dip bins not 0")
        check(np.allclose(res.power.cpu().numpy(), cres.power.numpy(), rtol=SUMMARY_RTOL,
                          atol=0), f"dips/{tech}: power differs")
    print("[predictors] seasonal_naive on a dip trace (raw forecast -1 at the dips): "
          "simulate_fleet and simulate_fleet_stream on cuda for proposed, hybrid and "
          "headroom finish, bins 0 at the dips and equal to the CPU, power within "
          f"{SUMMARY_RTOL}")


def phase_predictors(dev) -> None:
    """Every predictor/* row of BENCH_fleet.json on the card, one family's
    campaign against the CPU, each family's streaming loop profiled, and the
    seasonal dip case."""
    from repro_torch.core import characterization as char
    from repro_torch.core import controller as ctl
    from repro_torch.core import predictors as pred
    from repro_torch.core import scenarios as scn
    from repro_torch.core import workload as wl
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.kernels.grid_argmin import grid_argmin

    bench = _bench_derived(("predictor",))
    check(len(bench) == 96, f"BENCH_fleet.json holds {len(bench)} predictor rows, want 96")
    grid_argmin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, camps, evals = _predictor_rows(dev)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, grid_argmin.launches
    check(sorted(camps) == [(k, 0) for k in ("ewma", "hierarchy", "holt_winters", "markov",
                                             "persistence")]
          + [("seasonal_naive", p) for p in (0, 288, 576)],
          f"predictor campaigns {sorted(camps)}")
    check(launches == len(camps), f"the predictor sweep launched grid_argmin {launches} "
          f"times, want one per campaign ({len(camps)})")
    check(sorted(rows) == sorted(bench), f"rows differ: {sorted(set(rows) ^ set(bench))}")
    for name in sorted(rows):
        _check_bench_row(name, rows[name], bench[name], PRED_STEPS)
    steps = len(camps) * PRED_STEPS + len(evals) * PRED_STEPS
    print(f"[predictors] all {len(rows)} predictor rows of BENCH_fleet.json on cuda "
          f"(6 families, {len(camps)} campaigns of tabla x proposed x 15 scenarios grouped by "
          f"period, {PRED_STEPS} steps in {PRED_CHUNK}-step chunks, and 6 evaluate_trace runs) "
          f"in {wall:.2f} s, {wall / steps * 1e6:.1f} us per step; grid_argmin launches "
          f"{launches}: gains within {GAIN_ATOL}, rates within 2/S, accuracies within 6e-4")

    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=PRED_STEPS, seed=0))
    for kind, ev in evals.items():
        cpu = pred.evaluate_trace(_predictor_config(kind), trace, device="cpu")
        check(np.array_equal(ev.predicted.cpu().numpy(), cpu.predicted.numpy()),
              f"evaluate_trace {kind}: cuda bins differ from the CPU")
        check(float(ev.exact_accuracy) == float(cpu.exact_accuracy), f"{kind}: accuracy")
    t0 = time.perf_counter()
    names = tuple(sorted(scn.SCENARIOS))
    cpu = scn.run_campaign([ctl.fpga_platform(ACCELERATORS["tabla"])], scenario_names=names,
                           techniques=("proposed",), n_steps=PRED_STEPS, chunk_size=PRED_CHUNK,
                           predictor=_predictor_config("holt_winters"), device="cpu")
    worst = _compare_campaigns(camps[("holt_winters", 0)], cpu, "holt_winters campaign")
    print(f"[predictors] evaluate_trace bins and accuracies of all 6 families equal on cuda "
          f"and the CPU; the holt_winters campaign (season 0) on the CPU in "
          f"{time.perf_counter() - t0:.2f} s: every cell within {SUMMARY_RTOL} (worst rel "
          f"{worst:.3g}), miss rates equal")

    plat = ctl.fpga_platform(ACCELERATORS["tabla"])
    _, traces, avail = scn.build_suite(names, n_steps=4 * PROFILE_STEPS)
    params = char.stack_platform_params([plat.params])
    for kind, season in (("markov", 0), ("persistence", 0), ("ewma", 0), ("holt_winters", 0),
                         ("hierarchy", 0), ("seasonal_naive", 288)):
        cfg = ctl.ControllerConfig(predictor=_predictor_config(kind, season=season))
        tables = ctl.fleet_bin_tables(params, cfg, ("proposed",), device=dev)
        tab = ctl.BinTables(*[x[:, :, None].expand(x.shape[:2] + (len(names),) + x.shape[2:])
                              for x in tables])
        step_s, per_step, busy = _profile_stream_loop(dev, tab, traces, avail, cfg)
        if per_step is None:
            print(f"[predictors] {kind}: {step_s * 1e6:.1f} us per step; the profiler saw no "
                  "device work: kernels per step and busy share not measured")
            continue
        print(f"[predictors] {kind}{f' (season {season})' if season else ''} streaming loop "
              f"at {len(names)} cells: {step_s * 1e6:.1f} us per step; {per_step:.1f} device "
              f"kernels and {busy:.1f} us device busy per step = {busy / (step_s * 1e6):.1%} "
              f"of the step")
    _seasonal_dips(dev)


def _composition_search(dev):
    from repro_torch.core import composition as comp
    from repro_torch.core import controller as ctl
    from repro_torch.core.accelerators import ACCELERATORS

    platforms = [ctl.fpga_platform(ACCELERATORS[n]) for n in ("tabla", "stripes")]
    return comp.search_fleet_composition(platforms, comp.enumerate_candidates(2, 6, 48),
                                         COMPOSE_SCENARIOS, n_steps=BENCH_STEPS,
                                         chunk_size=BENCH_CHUNK, device=dev)


def _compose_cli(args) -> tuple:
    """``python -m repro_torch.launch.compose`` in a process of its own:
    its wall seconds and the kernels it built (name → seconds)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.compose", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"launch.compose {args} exited {run.returncode}:\n"
          f"{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    line = next(x for x in run.stdout.splitlines()
                if x.startswith("# kernels built in this process: "))
    built = line.split(": ", 1)[1].split(" — ")[0]
    check("second-half retraces: 0" in line, f"launch.compose: {line}")
    warmed = [x for x in run.stdout.splitlines() if x.startswith("# warmed fleet path")]
    return wall, built, warmed


def phase_composition(dev) -> None:
    """BENCH_fleet.json's composition rows on the card, the search against
    the CPU, and the compose CLI twice over one kernel build cache."""
    from repro_torch.kernels.grid_argmin import grid_argmin

    bench = _bench_derived(("composition",))
    check(len(bench) == 3, f"BENCH_fleet.json holds {len(bench)} composition rows, want 3")
    grid_argmin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = _composition_search(dev)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, grid_argmin.launches
    check(launches == 1, f"the composition search launched grid_argmin {launches} times")
    n = res.candidates.shape[0]
    pareto = ";".join(f"pareto_{s}={len(res.pareto[s])}" for s in COMPOSE_SCENARIOS)
    got = f"cands={n};{pareto};retraces={res.retraces_second_half}"
    check(got == bench["composition/sweep"], f"composition/sweep {got} vs {bench['composition/sweep']}")
    for i, s in enumerate(COMPOSE_SCENARIOS):
        idx = res.pareto[s]
        ok = [j for j in idx if res.qos_violation_rate[j, i] <= 0.25]
        j = ok[0] if ok else min(idx, key=lambda j: res.qos_violation_rate[j, i])
        want = dict(item.split("=") for item in bench[f"composition/knee/{s}"].split(";"))
        mix = "x".join(str(int(v)) for v in res.candidates[j])
        check(mix == want["mix"], f"composition/knee/{s}: mix {mix} vs {want['mix']}")
        check(abs(res.total_power_w[j, i] - float(want["power_w"])) <= 0.06,
              f"composition/knee/{s}: power {res.total_power_w[j, i]} vs {want['power_w']}")
        check(abs(res.qos_violation_rate[j, i] - float(want["qos_viol"])) <= 2 / BENCH_STEPS,
              f"composition/knee/{s}: qos {res.qos_violation_rate[j, i]} vs {want['qos_viol']}")
        print(f"[composition]   knee/{s}: mix={mix};power_w={res.total_power_w[j, i]:.4f};"
              f"qos_viol={res.qos_violation_rate[j, i]:.4f}")
    cells = n * 2 * len(COMPOSE_SCENARIOS)
    print(f"[composition] {got} on cuda ({cells} cells x {BENCH_STEPS} steps in two halves) in "
          f"{wall:.2f} s, {wall / (2 * BENCH_STEPS) * 1e6:.1f} us per step of a half; "
          f"grid_argmin launches {launches}; the 3 composition rows hold (knee power within "
          f"0.06 W, rates within 2/S)")
    t0 = time.perf_counter()
    cpu = _composition_search("cpu")
    worst = 0.0
    for f in ("total_power_w", "qos_violation_rate", "served_fraction"):
        x, y = getattr(res, f), getattr(cpu, f)
        worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-12))))
        check(np.allclose(x, y, rtol=SUMMARY_RTOL, atol=1e-12), f"composition {f}: cuda vs cpu")
    check({k: v.tolist() for k, v in res.pareto.items()}
          == {k: v.tolist() for k, v in cpu.pareto.items()}, "composition: Pareto sets differ")
    print(f"[composition] the same search on the CPU in {time.perf_counter() - t0:.2f} s: "
          f"every array within {SUMMARY_RTOL} (worst rel {worst:.3g}), Pareto sets equal")

    with tempfile.TemporaryDirectory() as cache:
        args = ["--cache-dir", cache, "--steps", str(COMPOSE_CLI_STEPS)]
        cold = _compose_cli(args)
        warm = _compose_cli(args + ["--warm"])
    check(cold[1].startswith("grid_argmin "), f"the first compose process built {cold[1]!r}")
    check(warm[1] == "none", f"the second compose process built {warm[1]!r}, want none")
    print(f"[composition] python -m repro_torch.launch.compose (defaults: 200 candidates x 2 "
          f"platforms x 2 scenarios; --steps {COMPOSE_CLI_STEPS}) --cache-dir <empty dir>: "
          f"{cold[0]:.2f} s, "
          f"built {cold[1]}; again with --warm over the same dir: {warm[0]:.2f} s, built "
          f"{warm[1]}; {warm[2][0][2:] if warm[2] else 'no warm line'}")


def _request_load(dev, technique="hybrid", **kw):
    from repro_torch.core import controller as ctl
    from repro_torch.core import predictors as pred
    from repro_torch.serving.autoscale import DvfsServingSimulator, RooflineTerms

    sim = DvfsServingSimulator(
        terms=RooflineTerms(t_compute=0.002, t_memory=0.012, t_collective=0.001),
        steps_per_tau=16, device=dev,
        controller_cfg=ctl.ControllerConfig(technique=technique, n_nodes=8,
                                            predictor=pred.PredictorConfig(warmup_steps=4)))
    return sim.run_request_load(np.full(SERVE_LOOP_STEPS, 1.0), batch_size=32,
                                mean_new_tokens=8, **kw)


def _compare_request_loads(a: dict, b: dict, label: str) -> float:
    """Two ``run_request_load`` results: counts and latencies equal, float
    arrays and summary fields within 1e-6 relative."""
    worst = 0.0
    for key, x in b.items():
        y = a[key]
        if key == "summary":
            for f in dataclasses.fields(x):
                u, v = getattr(y, f.name), getattr(x, f.name)
                if isinstance(v, float) and not (np.isnan(u) and np.isnan(v)):
                    worst = max(worst, abs(u - v) / max(abs(v), 1e-12))
                    check(abs(u - v) <= 1e-6 * max(abs(v), 1e-12), f"{label} {f.name}: {u} vs {v}")
                elif not isinstance(v, float):
                    check(u == v, f"{label} {f.name}: {u} vs {v}")
        elif isinstance(x, np.ndarray) and x.dtype.kind == "f":
            rel = float(np.max(np.abs(y - x) / np.maximum(np.abs(x), 1e-12), initial=0.0))
            worst = max(worst, rel)
            check(rel <= 1e-6, f"{label} {key}: worst rel {rel}")
        else:
            x, y = np.asarray(x), np.asarray(y)
            check(np.array_equal(y, x, equal_nan=x.dtype.kind == "f"),
                  f"{label} {key}: {y} vs {x}")
    return worst


def phase_serving_loop(dev) -> None:
    """The hybrid rows of BENCH_fleet.json on the card, the closed-loop
    serving row, and run_request_load on cuda against the CPU."""
    from repro_torch.core import controller as ctl
    from repro_torch.core import scheduler as sched
    from repro_torch.core import workload as wl
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.kernels.grid_argmin import grid_argmin

    bench = _bench_derived(("hybrid",))
    check(len(bench) == 6, f"BENCH_fleet.json holds {len(bench)} hybrid rows, want 6")
    trace = wl.generate_trace(wl.WorkloadConfig(n_steps=BENCH_STEPS, seed=0))
    accs = sorted(k.split("/")[1] for k in bench if k != "hybrid/closed_loop_serving")
    platforms = [ctl.fpga_platform(ACCELERATORS[a]) for a in accs]
    grid_argmin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = ctl.compare_all_batched(platforms, trace, ("proposed", "power_gating", "hybrid"),
                                    device=dev)
    for acc, plat in zip(accs, platforms):
        res = fleet[plat.name]
        sim = ctl.simulate(plat, ctl.ControllerConfig(technique="hybrid"), trace, device=dev)
        got = (f"hybrid={res['hybrid'].power_gain}x;prop={res['proposed'].power_gain}x"
               f";pg={res['power_gating'].power_gain}x"
               f";mean_nodes={sim.n_active.float().mean().item()}")
        want = bench[f"hybrid/{acc}"]
        g, w = _derived_tokens(got), _derived_tokens(want)
        check([k for k, _ in g] == [k for k, _ in w], f"hybrid/{acc}: {got} vs {want}")
        for (key, a), (_, b) in zip(g, w):
            check(abs(float(a.strip("x")) - float(b.strip("x"))) <= GAIN_ATOL,
                  f"hybrid/{acc}: {key} {a} vs {b}")
    torch.cuda.synchronize()
    rows_s, launches = time.perf_counter() - t0, grid_argmin.launches
    check(launches == 1 + len(accs), f"the hybrid rows launched grid_argmin {launches} times")
    print(f"[serving-loop] the 5 hybrid/<accelerator> rows on cuda ({BENCH_STEPS} steps) in "
          f"{rows_s:.2f} s, grid_argmin launches {launches}: gains and mean nodes within "
          f"{GAIN_ATOL}")

    want = dict(item.split("=") for item in bench["hybrid/closed_loop_serving"].split(";"))
    grid_argmin.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _request_load(dev)
    wall = time.perf_counter() - t0
    s = out["summary"]
    check(out["completed"] == int(want["completed"]), f"completed {out['completed']} vs {want}")
    check(f"{s.latency_p50:.0f}" == want["p50"] and f"{s.latency_p99:.0f}" == want["p99"],
          f"latency {s.latency_p50} / {s.latency_p99} vs {want}")
    check(abs(s.power_gain - float(want["gain"].rstrip("x"))) <= GAIN_ATOL, f"gain {s.power_gain}")
    check(abs(out["occupancy_tau"].mean() - float(want["occ"])) <= GAIN_ATOL, "occupancy")
    n_tau = len(out["tau_weights"])
    print(f"[serving-loop] hybrid/closed_loop_serving on cuda: {SERVE_LOOP_STEPS} arrival steps "
          f"+ {out['drain_steps']} drain, {n_tau} control intervals, in {wall:.2f} s "
          f"({wall / n_tau * 1e3:.2f} ms per interval, {wall / SERVE_LOOP_STEPS * 1e6:.1f} us "
          f"per decode step), grid_argmin launches {grid_argmin.launches}: "
          f"gain={s.power_gain:.4f}x;occ={out['occupancy_tau'].mean():.4f};"
          f"p50={s.latency_p50:.0f};p99={s.latency_p99:.0f};completed={out['completed']}")

    t0 = time.perf_counter()
    worst = 0.0
    spec = sched.make_tenants([2.0, 1.0, 0.0], [0.0, 4.0, 16.0], [0.5, 0.3, 0.2])
    runs = {f"{sig}": dict(workload_signal=sig) for sig in ("occupancy", "demand", "arrival")}
    runs["3 tenants"] = dict(workload_signal="demand", tenants=spec)
    for label, kw in runs.items():
        a = out if label == "occupancy" else _request_load(dev, **kw)
        worst = max(worst, _compare_request_loads(a, _request_load("cpu", **kw), label))
    print(f"[serving-loop] run_request_load on cuda vs the CPU for the occupancy, demand and "
          f"arrival signals and 3 tenants: counts and latencies equal, float arrays within 1e-6 "
          f"(worst rel {worst:.3g}); {time.perf_counter() - t0:.2f} s")


def _gemma_cache_check(cfg, cache, b: int, capacity: int) -> None:
    """A prefill's decode cache: the local layers' rings hold
    ``min(window, capacity)`` slots and the global layers ``capacity``; its
    bytes beside ``kvcache.cache_bytes`` (every leaf at the cache dtype)."""
    from repro_torch.models import common, transformer
    from repro_torch.serving import kvcache

    leaves = dict(common.tree_leaves(cache))
    layout = dict(common.tree_leaves(transformer.cache_layout(cfg, b, capacity)))
    check({p: tuple(t.shape) for p, t in leaves.items()} ==
          {p: d.shape for p, d in layout.items()}, "the decode cache is not the layout's")
    rings = sorted({d.shape[d.axes.index("kv_seq")] for d in layout.values()})
    check(rings == sorted({min(cfg.attention.sliding_window, capacity), capacity}),
          f"kv_seq lengths {rings}")
    real = sum(t.numel() * t.element_size() for t in leaves.values())
    print(f"[gemma] {cfg.name} decode cache B={b} capacity={capacity}: kv_seq "
          f"{rings} (local rings, global layers), {real} bytes on the card "
          f"(int32 position tags); kvcache.cache_bytes {kvcache.cache_bytes(cfg, b, capacity)}")


def _gemma_prefill_attention_check(cfg, params, dev) -> None:
    """Every flash call of one bf16 prefill of the served model (B = 2, the
    8160-token prompt of ``generate``) against the plain version on the
    q, k, v the model gave it: the tensor-core kernel at the model's own
    inputs, within FLASH_TOL.  The plain version runs a batch row and 16
    heads at a time (``_plain_attention``) to bound its fp32 scores' memory."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.serving.engine import ServeEngine

    engine = ServeEngine(cfg=cfg, params=params, capacity=GEMMA_CAPACITY,
                         batch_size=GEMMA_BATCH, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (GEMMA_BATCH, GEMMA_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    real, errs, moved = attn_mod.flash_attention, [], []

    def held(q, k, v, **kw):
        out = real(q, k, v, **kw)
        ref = _plain_attention(q, k, v, **kw)
        errs.append((out.float() - ref).abs().max().item())
        if kw.get("softcap"):
            moved.append((ref - _plain_attention(q, k, v, **dict(kw, softcap=None)))
                         .abs().max().item())
        return out

    attn_mod.flash_attention = held
    try:
        with torch.inference_mode():
            engine._prefill(engine._params, {"tokens": prompts})
    finally:
        attn_mod.flash_attention = real
    tol = FLASH_TOL[torch.bfloat16]
    check(len(errs) == cfg.n_layers, f"{len(errs)} flash calls in a prefill")
    check(max(errs) <= tol, f"{cfg.name}: the kernel at the model's inputs, max|Δ| vs plain "
          f"by layer {errs}")
    cap = (f"; the softcap moves the plain output by up to {max(moved):.3g} at these "
           f"inputs" if moved else "")
    print(f"[gemma] {cfg.name} bf16 prefill, every layer's flash call vs the plain version on "
          f"the model's q, k, v: max|Δ| {max(errs):.3g} (tol {tol}, layers "
          f"{min(errs):.3g}–{max(errs):.3g}){cap}")


def _gemma_windowed_vs_flash(dev) -> None:
    """``windowed_attention`` on the card against the CUDA-core flash kernel
    with the same band, float32, at gemma2's local-layer shape cut to B = 1."""
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models.attention import windowed_attention

    b, s, kv, g, d, _, window, cap = GEMMA_FLASH_SHAPES["gemma2_local"]
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _flash_inputs((1, s, kv, g, d), torch.float32, gen, dev)
    scale = d ** -0.5
    before = flash_attention.kernel_launches[ops.CUDA_CORE]
    flash = flash_attention(q, k, v, causal=True, window=window, softcap=cap, scale=scale)
    band = windowed_attention(q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2),
                              window=window, scale=scale, cap=cap, q_chunk=1020)
    torch.cuda.synchronize()
    check(flash_attention.kernel_launches[ops.CUDA_CORE] == before + 1, "no CUDA-core launch")
    err = (band - flash).abs().max().item()
    check(err <= FLASH_TOL[torch.float32], f"windowed_attention vs flash: max|Δ| {err}")
    print(f"[gemma] windowed_attention (q_chunk 1020) vs the CUDA-core flash kernel, float32 "
          f"q {tuple(q.shape)} window {window} softcap {cap}: max|Δ| {err:.3g} "
          f"(tol {FLASH_TOL[torch.float32]})")


def phase_gemma_serving(dev) -> dict:
    """The local:global family's serving path; returns, per model, the flash
    launches of one bf16 ``generate`` by kernel and how many had a window."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import common, transformer

    torch.cuda.empty_cache()
    # 15a. the serving launcher at full width, as a user runs it
    flash_attention.launches = grid_argmin.launches = 0
    t0 = time.perf_counter()
    check(serve.main(["--arch", "gemma2-2b", "--no-reduced", "--device", "cuda"]) == 0,
          "serve.main failed")
    torch.cuda.synchronize()
    fa, ga = flash_attention.launches, grid_argmin.launches
    print(f"[gemma] launch.serve --arch gemma2-2b --no-reduced --device cuda: "
          f"{time.perf_counter() - t0:.2f} s, flash_attention launches {fa}, grid_argmin "
          f"launches {ga}")
    check(fa > 0 and ga > 0, "the serving launcher launched no flash_attention or grid_argmin")
    torch.cuda.empty_cache()

    # the window of every flash call, through the name the model calls
    windows, real = [], attn_mod.flash_attention

    def spy(*args, **kw):
        windows.append(kw.get("window"))
        return real(*args, **kw)

    out = {}
    for arch, n_layers in (("gemma2-2b", None), ("gemma3-27b", GEMMA3_LAYERS)):
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                    transformer.model_layout(cfg))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for _, t in common.tree_leaves(params))
        local = [transformer._is_local(cfg, i) for i in range(cfg.n_layers)]
        a = cfg.attention
        print(f"[gemma] {arch}: {cfg.n_layers} layers ({sum(local)} local, window "
              f"{a.sliding_window}), d_model {cfg.d_model}, {a.n_heads}/{a.n_kv_heads} heads "
              f"of {a.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} float32 "
              f"parameters drawn in {time.perf_counter() - t0:.2f} s")
        windows.clear()
        attn_mod.flash_attention = spy
        try:
            launches, by_kernel, cache = phase_generate(
                cfg, params, dev, flash_attention, "[gemma]", b=GEMMA_BATCH, s=GEMMA_PROMPT,
                n_new=GEMMA_NEW, capacity=GEMMA_CAPACITY)
        finally:
            attn_mod.flash_attention = real
        _gemma_cache_check(cfg, cache, GEMMA_BATCH, GEMMA_CAPACITY)
        del cache
        want = {ops.TENSOR_CORE: cfg.n_layers, ops.CUDA_CORE: 0}
        check(by_kernel == want, f"one bf16 generate launched {by_kernel}, want {want}")
        # every prefill of the phase (the timed generate's among them) had one call a
        # layer, windowed exactly where the layer is local
        per_layer = [w is not None for w in windows]
        check(len(per_layer) % cfg.n_layers == 0 and per_layer == local * (
            len(per_layer) // cfg.n_layers), f"flash windows {windows[:cfg.n_layers]}")
        check(all(w in (None, a.sliding_window) for w in windows), "a window other than the config's")
        windowed = sum(local)
        print(f"[gemma] {arch} flash launches per generate: {by_kernel} ({windowed} windowed, "
              f"window {a.sliding_window}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (float32 weights, the "
              f"engine's bf16 copy, activations)")
        out[arch] = {"tensor_core": by_kernel[ops.TENSOR_CORE], "windowed": windowed,
                     "layers": cfg.n_layers}
        _gemma_prefill_attention_check(cfg, params, dev)
        torch.cuda.empty_cache()

        # 15d. float32, card vs CPU, on the first layers of the same weights
        f32_layers, f32_prompt = GEMMA_F32[arch]
        period = transformer.period_of(cfg)
        cut = dataclasses.replace(cfg, n_layers=f32_layers)
        few = dict(params, slots=[common.tree_map(lambda t: t[:f32_layers // period], sl)
                                  for sl in params["slots"]], rem=[])
        flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
        phase_float32_cuda_vs_cpu(cut, few, dev, "[gemma]", s=f32_prompt)
        f32 = dict(flash_attention.kernel_launches)
        check(f32 == {ops.CUDA_CORE: f32_layers, ops.TENSOR_CORE: 0},
              f"the float32 check launched {f32}, want {f32_layers} on the CUDA-core kernel")
        print(f"[gemma] {arch} float32 check: {f32_layers} layers ({sum(local[:f32_layers])} "
              f"local), prompt {f32_prompt} past the window {a.sliding_window}; flash launches "
              f"{f32}")
        del params, few
        torch.cuda.empty_cache()
    _gemma_windowed_vs_flash(dev)
    return out


def _plain_attention(q, k, v, heads: int = 16, q_chunk=None, kv_chunk=None,
                     **kw) -> torch.Tensor:
    """The plain version (``attention_ref``) of a GQA call, a batch row and
    ``heads`` query heads at a time to bound its fp32 scores' memory; float32.
    ``q_chunk`` and ``kv_chunk``, the backward's blocks that the models pass
    the op, do not change the forward and are dropped."""
    from repro_torch.kernels.flash_attention import attention_ref

    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=torch.float32, device=q.device)
    for i in range(q.shape[0]):
        for h in range(0, q.shape[2], heads):
            sl = (slice(i, i + 1), slice(None), slice(h, h + heads))
            out[sl] = attention_ref(q[sl], k[sl], v[sl], **kw).float()
    return out


def _padded_flash_times(shapes: dict, seed: int, dev, tag: str) -> dict:
    """The tensor-core kernel at models' prefill layers, bf16: its time on
    q, k, v padded as the model pads them (``attention._padded_flash``: zero
    columns to the next tensor-core head_dim; MLA's q, k of 192 and v of 128
    to 256, heads of 80 to 128, at their unpadded scale), and the model's
    whole call with its copies, beside the plain version,
    ``scaled_dot_product_attention`` and the bound, all three of the
    unpadded function (the bound on its useful work); the plain version
    runs a batch row and 16 heads at a time (``_plain_attention``), and the
    kernel and SDPA are each held to it first."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn_mod

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (b, s, kv, g, dqk, dv, causal) in shapes.items():
        q = torch.randn(b, s, kv * g, dqk, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, s, kv, dqk, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, s, kv, dv, generator=gen, device=dev).to(torch.bfloat16)
        scale = dqk ** -0.5
        hd = attn_mod._flash_head_dim(max(dqk, dv))
        pq, pk, pv = (F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
        kernel = lambda: flash_attention(pq, pk, pv, causal=causal, scale=scale)  # noqa: E731
        model = lambda: attn_mod._padded_flash([q], [k], v, causal=causal,  # noqa: E731
                                               scale=scale)
        got = model()
        ref = _plain_attention(q, k, v, causal=causal, scale=scale)
        err = (got.float() - ref).abs().max().item()
        check(err <= FLASH_TOL[torch.bfloat16], f"{name}: max|Δ| vs plain {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=g > 1)
        lib_err = (sdpa().transpose(1, 2).float() - ref).abs().max().item()
        check(lib_err <= FLASH_TOL[torch.bfloat16], f"{name}: SDPA max|Δ| vs plain {lib_err}")
        del ref
        torch.cuda.empty_cache()
        ms = device_time_ms(kernel, 10)
        model_ms = device_time_ms(model, 10) if hd != max(dqk, dv) else ms
        lib_ms = device_time_ms(sdpa, 10)
        plain_ms = device_time_ms(lambda: _plain_attention(q, k, v, causal=causal,
                                                           scale=scale), 3)
        flops = _attention_flops(q, causal, dv)
        bound_ms, bound_by = _flash_bound(q, k, v, got, causal=causal)
        pad = (f", padded to D = {hd} ({2 * hd / (dqk + dv):.2f}x the work; the model's call "
               f"with its copies {model_ms:.4f} ms)" if hd != max(dqk, dv) else "")
        print(f"{tag} flash {name} q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} bf16 "
              f"{'causal' if causal else 'non-causal'}{pad}: kernel {ms:.4f} ms "
              f"({flops / (ms * 1e-3) / 1e12:.2f} useful TFLOP/s, {ms / bound_ms:.2f}x its bound, "
              f"{ms / lib_ms:.2f}x scaled_dot_product_attention), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms (max|Δ| vs plain {lib_err:.3g}), "
              f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP), max|Δ| vs plain "
              f"{err:.3g}")
        out[name] = {"shape": [b, s, kv, g, dqk, dv, causal], "padded_head_dim": hd, "ms": ms,
                     "model_ms": model_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "max_abs_err": err}
        del q, k, v, pq, pk, pv, got, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def _moe_prefill_check(cfg, params, dev) -> list:
    """One bf16 prefill of the served model (B = 2, the 4096-token prompt of
    ``generate``): every flash call against the plain version
    (``_model_flash_check``); returns each MoE layer's ``moe_dropped``."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import ServeEngine

    engine = ServeEngine(cfg=cfg, params=params, capacity=MOE_CAPACITY, batch_size=MOE_BATCH,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    real, dropped = moe_mod.moe_apply, []

    def watched(*args):
        y, aux = real(*args)
        dropped.append(aux["moe_dropped"].item())
        return y, aux

    moe_mod.moe_apply = watched
    try:
        _model_flash_check(cfg, lambda: engine._prefill(engine._params, {"tokens": prompts}),
                           cfg.n_layers, "[moe]")
    finally:
        moe_mod.moe_apply = real
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    check(len(dropped) == n_moe, f"{len(dropped)} MoE calls in a prefill, want {n_moe}")
    print(f"[moe] {cfg.name} prefill moe_dropped by MoE layer: "
          + " ".join(f"{d:.4f}" for d in dropped))
    return dropped


def _one_hot_moe(lp, x, cfg):
    """The JAX package's formulation of ``moe_apply`` without the shared
    expert (``repro/models/moe.py:77-112``), in torch: one-hot ``disp`` and
    ``comb`` ``[g, s, e, C]`` around the port's routing; returns (xe, y)."""
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import activation

    b, s, d = x.shape
    xg = x.reshape(1, b * s, d)
    cap = moe_mod._capacity(b * s, cfg)
    r = moe_mod.route(lp["router"], xg, cfg, cap)
    keep = F.one_hot(r.expert_idx, cfg.moe.n_experts).float() * r.keep[..., None]
    slot_oh = F.one_hot(r.slot, cap).float()
    disp = torch.einsum("gske,gskc->gsec", keep, slot_oh).to(x.dtype)
    comb = torch.einsum("gsk,gske,gskc->gsec", r.gate, keep, slot_oh)
    del keep, slot_oh
    xe = torch.einsum("gsec,gsd->gecd", disp, xg)
    del disp
    gu = torch.einsum("gecd,edxf->gecxf", xe, lp["w_in"].to(x.dtype))
    h = activation(cfg.act)(gu[:, :, :, 0]) * gu[:, :, :, 1]
    ye = torch.einsum("gecf,efd->gecd", h, lp["w_down"].to(x.dtype))
    y = torch.einsum("gsec,gecd->gsd", comb.to(x.dtype), ye)
    return xe, y.reshape(b, s, d)


def _moe_layer_check(cfg, params, dev) -> dict:
    """One full-width qwen3 MoE layer on one 4096-token group (capacity
    320), bf16: the index dispatch's ``xe`` bit-equal to the one-hot
    einsum's, the outputs within FLASH_TOL's bf16 2e-2, and both timed."""
    from repro_torch.models import common
    from repro_torch.models import moe as moe_mod

    lp = common.tree_map(lambda t: t[0], params["slots"][0]["moe"])
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, MOE_PROMPT, cfg.d_model, generator=gen, device=dev)
    x = (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).to(torch.bfloat16)
    with torch.inference_mode():
        xe_ref, y_ref = _one_hot_moe(lp, x, cfg)
        cap = moe_mod._capacity(MOE_PROMPT, cfg)
        r = moe_mod.route(lp["router"], x, cfg, cap)
        xe = moe_mod.dispatch(x, r, cfg.moe.n_experts, cap)
        check(torch.equal(xe.transpose(0, 1), xe_ref), "index dispatch xe != one-hot xe")
        y, aux = moe_mod.moe_apply(lp, x, cfg)
        err = (y.float() - y_ref.float()).abs().max().item()
        check(err <= FLASH_TOL[torch.bfloat16], f"moe_apply vs one-hot: max|Δ| {err}")
        del xe, xe_ref, y_ref
        torch.cuda.empty_cache()
        index_ms = device_time_ms(lambda: moe_mod.moe_apply(lp, x, cfg), 5)
        one_hot_ms = device_time_ms(lambda: _one_hot_moe(lp, x, cfg), 5)
        tops = {name: _top_kernels(_device_kernels(fn), 1, k=6) for name, fn in (
            ("index", lambda: moe_mod.moe_apply(lp, x, cfg)),
            ("one-hot", lambda: _one_hot_moe(lp, x, cfg)))}
    m = cfg.moe
    expert_flops = 2 * m.n_experts * cap * cfg.d_model * 3 * m.d_ff_expert
    onehot_flops = 2 * 2 * MOE_PROMPT * m.n_experts * cap * cfg.d_model
    print(f"[moe] one qwen3 MoE layer, 1 group of {MOE_PROMPT} tokens, capacity {cap}, bf16: "
          f"xe of the index dispatch bit-equal to the one-hot einsum's; y max|Δ| {err:.3g} (tol "
          f"{FLASH_TOL[torch.bfloat16]}); moe_dropped {aux['moe_dropped'].item():.4f}; "
          f"index dispatch {index_ms:.4f} ms, one-hot einsums {one_hot_ms:.4f} ms "
          f"({one_hot_ms / index_ms:.2f}x); expert FLOPs {expert_flops / 1e12:.3f} T, one-hot "
          f"dispatch + combine {onehot_flops / 1e12:.3f} T more")
    for name, top in tops.items():
        print(f"[moe] one MoE layer, {name} top kernels: {top}")
    return {"index_ms": index_ms, "one_hot_ms": one_hot_ms, "max_abs_err": err}


def _moe_float32_check(arch, cfg, few, dev) -> None:
    """The first layers of the served weights in float32, card vs CPU
    (``phase_float32_cuda_vs_cpu``), with every MoE call's routing
    compared: equal, or a token's expert set different only where its
    k-th and (k+1)-th probabilities (CPU) lie within twice the call's
    largest probability difference."""
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models import moe as moe_mod

    n_layers, prompt = MOE_F32[arch]
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    real, calls = moe_mod.route, {"cuda": [], "cpu": []}

    def watched(*args):
        r = real(*args)
        calls[r.probs.device.type].append([t.cpu() for t in (r.probs, r.expert_idx, r.keep)])
        return r

    flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
    moe_mod.route = watched
    try:
        phase_float32_cuda_vs_cpu(cut, few, dev, "[moe]", s=prompt)
    finally:
        moe_mod.route = real
    f32 = dict(flash_attention.kernel_launches)
    check(f32 == {ops.CUDA_CORE: n_layers, ops.TENSOR_CORE: 0},
          f"the float32 check launched {f32}, want {n_layers} on the CUDA-core kernel")
    check(len(calls["cuda"]) == len(calls["cpu"]) > 0, f"MoE calls {len(calls['cuda'])} "
          f"on cuda, {len(calls['cpu'])} on the CPU")
    k, flips, worst = cfg.moe.top_k, 0, 0.0
    for (pg, ig, kg), (pc, ic, kc) in zip(calls["cuda"], calls["cpu"]):
        delta = (pg - pc).abs().max().item()
        worst = max(worst, delta)
        differ = (ig.sort(-1).values != ic.sort(-1).values).any(-1)
        top = pc.topk(k + 1, dim=-1).values
        gap = top[..., k - 1] - top[..., k]
        check(bool((gap[differ] <= 2 * delta).all()), f"a routing flip at a gap of "
              f"{gap[differ].tolist()} > 2 x {delta}")
        check(torch.equal(kg, kc) or bool(differ.any()), "keep differs with no flip")
        flips += int(differ.sum())
    print(f"[moe] {arch} float32 check: {n_layers} layers, prompt {prompt}; {len(calls['cpu'])} "
          f"MoE calls a device, routing cuda vs cpu: {flips} token flips (each at a near tie), "
          f"probabilities max|Δ| {worst:.3g}; flash launches {f32}")


def phase_moe_serving(dev) -> tuple:
    """The MoE family's serving path; returns, per model, the flash launches
    of one bf16 ``generate`` by kernel with its head_dim, and the tensor-core
    kernel's times at both prefill layers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import common, transformer

    torch.cuda.empty_cache()
    # 16a. the serving launcher, REDUCED (neither model fits one card at full depth)
    for arch in MOE_LAYERS:
        flash_attention.launches = grid_argmin.launches = 0
        t0 = time.perf_counter()
        check(serve.main(["--arch", arch, "--device", "cuda"]) == 0, "serve.main failed")
        torch.cuda.synchronize()
        fa, ga = flash_attention.launches, grid_argmin.launches
        print(f"[moe] launch.serve --arch {arch} --device cuda (REDUCED): "
              f"{time.perf_counter() - t0:.2f} s, flash_attention launches {fa}, grid_argmin "
              f"launches {ga}")
        check(fa > 0 and ga > 0, "the serving launcher launched no flash_attention or grid_argmin")
    times = _padded_flash_times(MOE_FLASH_SHAPES, 6, dev, "[moe]")

    out = {}
    for arch, n_layers in MOE_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                    transformer.model_layout(cfg), dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for _, t in common.tree_leaves(params))
        kinds = [transformer._layer_kind(cfg, i) for i in range(n_layers)]
        a, m = cfg.attention, cfg.moe
        print(f"[moe] {arch}: {n_layers} of {get_config(arch).n_layers} layers "
              f"({kinds.count('dense')} dense, {kinds.count('moe')} MoE: {m.n_experts} experts "
              f"top-{m.top_k}, {m.n_shared} shared, d_ff_expert {m.d_ff_expert}), d_model "
              f"{cfg.d_model}, {a.kind} {a.n_heads}/{a.n_kv_heads} heads, vocab "
              f"{cfg.vocab_size}: {n_params} bf16 parameters, {2 * n_params} bytes, drawn in "
              f"{time.perf_counter() - t0:.2f} s")
        dims, real = [], attn_mod.flash_attention

        def spy(q, *args, **kw):
            dims.append(q.shape[-1])
            return real(q, *args, **kw)

        attn_mod.flash_attention = spy
        try:
            launches, by_kernel, cache = phase_generate(
                cfg, params, dev, flash_attention, "[moe]", b=MOE_BATCH, s=MOE_PROMPT,
                n_new=MOE_NEW, capacity=MOE_CAPACITY)
        finally:
            attn_mod.flash_attention = real
        del cache
        want = {ops.TENSOR_CORE: n_layers, ops.CUDA_CORE: 0}
        check(by_kernel == want, f"one bf16 generate launched {by_kernel}, want {want}")
        head_dim = dims[0]
        check(set(dims) == {attn_mod._flash_head_dim(
            a.qk_nope_dim + a.qk_rope_dim) if a.kind == "mla" else a.head_dim},
            f"flash head_dims {sorted(set(dims))}")
        print(f"[moe] {arch} flash launches per generate: {by_kernel} at D = {head_dim}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (bf16 "
              f"weights, activations, the decode cache)")
        dropped = _moe_prefill_check(cfg, params, dev)
        out[arch] = {"tensor_core": by_kernel[ops.TENSOR_CORE], "head_dim": head_dim,
                     "layers": n_layers, "prefill_moe_dropped": dropped}
        if arch == "qwen3-moe-235b-a22b":
            out[arch]["one_layer"] = _moe_layer_check(cfg, params, dev)

        # 16f. float32, card vs CPU, on the first layers of the same weights (copies, so
        # that the rest can go)
        prefix, _, _ = transformer.scanned_layers(cfg)
        n_slot = MOE_F32[arch][0] - prefix
        few = dict(params, slots=[common.tree_map(lambda t: t[:n_slot].clone(), sl)
                                  for sl in params["slots"]], rem=[])
        del params
        torch.cuda.empty_cache()
        _moe_float32_check(arch, cfg, few, dev)
        del few
        torch.cuda.empty_cache()
    return out, times


def _model_flash_check(cfg, run, n_calls: int, tag: str) -> None:
    """Every flash call of one bf16 prefill or forward (``run()``) against
    the plain version on the q, k, v the model gave it, and, where the model
    padded them (MLA's 192 / 128, heads of 80), cut back against the plain
    version on the unpadded tensors; ``n_calls`` calls, each at the padded
    head_dim and with the config's causality."""
    from repro_torch.models import attention as attn_mod

    a = cfg.attention
    dqk, dv = ((a.qk_nope_dim + a.qk_rope_dim, a.v_head_dim) if a.kind == "mla"
               else (a.head_dim, a.head_dim))
    real, errs, unpadded, calls = attn_mod.flash_attention, [], [], []

    def held(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append((q.shape[-1], kw["causal"]))
        errs.append((out.float() - _plain_attention(q, k, v, **kw)).abs().max().item())
        if q.shape[-1] != dqk or v.shape[-1] != dv:
            ref = _plain_attention(q[..., :dqk], k[..., :dqk], v[..., :dv], **kw)
            unpadded.append((out[..., :dv].float() - ref).abs().max().item())
        return out

    attn_mod.flash_attention = held
    try:
        with torch.inference_mode():
            run()
    finally:
        attn_mod.flash_attention = real
    tol = FLASH_TOL[torch.bfloat16]
    want = (attn_mod._flash_head_dim(max(dqk, dv)), cfg.causal)
    check(len(calls) == n_calls and set(calls) == {want},
          f"{cfg.name}: flash calls {sorted(set(calls))} x{len(calls)}, want {n_calls} of {want}")
    check(max(errs) <= tol, f"{cfg.name}: the kernel at the model's inputs, max|Δ| vs plain "
          f"by call {errs}")
    note = ""
    if unpadded:
        check(max(unpadded) <= tol, f"{cfg.name}: the padded call vs the unpadded plain "
              f"attention, max|Δ| by call {unpadded}")
        note = (f"; cut to {dv} columns vs the plain version on the unpadded q, k ({dqk}) and "
                f"v ({dv}): {max(unpadded):.3g}")
    print(f"{tag} {cfg.name} bf16, every flash call ({n_calls}, D = {want[0]}, "
          f"{'causal' if cfg.causal else 'non-causal'}) vs the plain version on the model's q, "
          f"k, v: max|Δ| {max(errs):.3g} (tol {tol}, calls {min(errs):.3g}-{max(errs):.3g}){note}")


def _ssd_share(engine, batch, prefill_s: float) -> None:
    """Device time of the 54 ``_ssd_matmul_scan`` calls of one prefill
    (``torch.profiler``, each call inside a ``record_function`` range)
    beside the prefill's device busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm as ssm_mod

    real = ssm_mod._ssd_matmul_scan

    def ranged(*args):
        with record_function("ssd_matmul_scan"):
            return real(*args)

    ssm_mod._ssd_matmul_scan = ranged
    try:
        torch.cuda.synchronize()
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine._prefill(engine._params, batch)
            torch.cuda.synchronize()
    finally:
        ssm_mod._ssd_matmul_scan = real
    events, cuda = prof.events(), torch.autograd.DeviceType.CUDA
    # the ranges also appear on the device's timeline as annotations: not kernels
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type == cuda and e.name != "ssd_matmul_scan")
    ssd = [e for e in events if e.name == "ssd_matmul_scan" and e.device_type != cuda]
    ssd_us = sum(e.device_time_total for e in ssd)
    if not busy or not ssd_us:
        print(f"[hybrid] zamba2 SSD share of prefill: not measured (the profiler saw "
              f"{busy:.0f} us of device work, {len(ssd)} SSD ranges with {ssd_us:.0f} us)")
        return
    print(f"[hybrid] zamba2 prefill profile: {len(ssd)} SSD calls, {ssd_us / 1e3:.2f} ms of "
          f"device time = {ssd_us / busy:.1%} of {busy / 1e3:.2f} ms busy "
          f"({busy / 1e3 / (prefill_s * 1e3):.1%} of the unprofiled {prefill_s * 1e3:.2f} ms "
          f"prefill)")


def _float32_forward_cuda_vs_cpu(cfg, params, batch, dev, tag: str) -> None:
    """One float32 forward of the same weights on ``batch`` (CPU tensors),
    card vs CPU: logits within F32_LOGIT_ATOL."""
    from repro_torch.models import common, transformer

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    logits = {}
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            tree = common.tree_map(lambda t: t.to(d), params)
            logits[d.type], _, _ = transformer.forward(tree, cfg32,
                                                       {k: t.to(d) for k, t in batch.items()})
    diff = (logits[dev.type].cpu() - logits["cpu"]).abs().max().item()
    check(diff <= F32_LOGIT_ATOL, f"{cfg.name} float32 forward cuda vs cpu: max|Δ| {diff}")
    shapes = ", ".join(f"{k} {tuple(t.shape)}" for k, t in batch.items())
    print(f"{tag} {cfg.name} float32, {cfg.n_layers} layers, {shapes}, cuda vs cpu: logits "
          f"max|Δ| {diff:.3g} (tol {F32_LOGIT_ATOL}); {time.perf_counter() - t0:.2f} s")


def _first_layers(cfg, params, n_layers: int):
    """The config cut to its first ``n_layers`` and copies of those layers'
    weights (the rest can then go)."""
    from repro_torch.models import common, transformer

    period = transformer.period_of(cfg)
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    few = dict(params, slots=[common.tree_map(lambda t: t[:n_layers // period].clone(), sl)
                              for sl in params["slots"]], rem=[])
    return cut, few


def _draw(cfg, dev, tag: str):
    from repro_torch.models import common, transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in common.tree_leaves(params))
    a = cfg.attention
    print(f"{tag} {cfg.name} full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{a.n_heads}/{a.n_kv_heads} heads of {a.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {n} float32 parameters ({4 * n} bytes) drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    return params, n


def _zamba2_cell(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import common, transformer
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("zamba2-2.7b")
    params, n = _draw(cfg, dev, "[hybrid]")
    check(n == 2_422_907_840, f"zamba2 holds {n} parameters")
    s = cfg.ssm
    print(f"[hybrid] zamba2: {cfg.n_layers} Mamba-2 layers (d_inner {s.d_inner(cfg.d_model)}, "
          f"{s.n_heads(cfg.d_model)} heads of {s.head_dim}, d_state {s.d_state}, chunk "
          f"{s.chunk}) and the shared block after each {cfg.shared_attn_every}: "
          f"{transformer.scanned_layers(cfg)[1]} shared calls a forward")
    n_shared = cfg.n_layers // cfg.shared_attn_every
    dims, real = [], attn_mod.flash_attention

    def spy(q, *args, **kw):
        dims.append(q.shape[-1])
        return real(q, *args, **kw)

    attn_mod.flash_attention = spy
    try:
        launches, by_kernel, cache = phase_generate(
            cfg, params, dev, flash_attention, "[hybrid]", b=HYBRID_BATCH, s=HYBRID_PROMPT,
            n_new=HYBRID_NEW, per_generate=n_shared)
    finally:
        attn_mod.flash_attention = real
    want = {ops.TENSOR_CORE: n_shared, ops.CUDA_CORE: 0}
    check(by_kernel == want, f"one bf16 generate launched {by_kernel}, want {want}")
    hd = attn_mod._flash_head_dim(cfg.attention.head_dim)
    check(set(dims) == {hd}, f"flash head_dims {sorted(set(dims))}, want {hd}")
    layout = dict(common.tree_leaves(transformer.cache_layout(
        cfg, HYBRID_BATCH, HYBRID_PROMPT + HYBRID_NEW)))
    leaves = dict(common.tree_leaves(cache))
    check({p: tuple(t.shape) for p, t in leaves.items()} == {p: d.shape for p, d in layout.items()},
          "the decode cache is not the layout's")
    print(f"[hybrid] zamba2 flash launches per generate: {by_kernel} at D = {hd} (heads of "
          f"{cfg.attention.head_dim}); decode cache: shared k {tuple(cache['shared']['k'].shape)}, Mamba-2 state "
          f"{tuple(cache['slots'][0]['h'].shape)} {cache['slots'][0]['h'].dtype}, "
          f"{sum(t.numel() * t.element_size() for t in leaves.values())} bytes; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (float32 weights, the "
          f"engine's bf16 copy, activations)")
    del cache
    engine = ServeEngine(cfg=cfg, params=params, capacity=HYBRID_PROMPT + HYBRID_NEW,
                         batch_size=HYBRID_BATCH, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT),
                                     device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))}
    with torch.inference_mode():
        prefill_s = _median_s(lambda: engine._prefill(engine._params, batch), 3)
    _ssd_share(engine, batch, prefill_s)
    _model_flash_check(cfg, lambda: engine._prefill(engine._params, batch), n_shared,
                       "[hybrid]")
    del engine
    torch.cuda.empty_cache()

    layers, prompt = HYBRID_F32[cfg.name]
    cut, few = _first_layers(cfg, params, layers)
    del params
    torch.cuda.empty_cache()
    # The SSD rounds its Gram matrix, M and δ·x to bf16 in a float32 model too (the
    # reference does): where the card's and the CPU's fp32 sums differ by an ulp, a value
    # at a bf16 rounding midpoint rounds the other way, by 2^-8 of itself.  So the float32
    # function is held at F32_LOGIT_ATOL with those roundings taken out on both devices,
    # and as it is at the bf16 tolerance.
    for label, rounding, atol in (("without the SSD's bf16 roundings", False, F32_LOGIT_ATOL),
                                  ("with them", True, FLASH_TOL[torch.bfloat16])):
        flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
        kept = ssm_mod._bf16
        if not rounding:
            ssm_mod._bf16 = lambda t: t  # noqa: E731
        try:
            phase_float32_cuda_vs_cpu(cut, few, dev, "[hybrid]", s=prompt, atol=atol)
        finally:
            ssm_mod._bf16 = kept
        f32 = dict(flash_attention.kernel_launches)
        check(f32 == {ops.CUDA_CORE: 1, ops.TENSOR_CORE: 0}, f"the float32 check launched "
              f"{f32}, want the shared block's 1 on the CUDA-core kernel")
        print(f"[hybrid] zamba2 float32 check {label}: the first period ({layers} Mamba-2 "
              f"layers and the shared block), prompt {prompt}; flash launches {f32}")
    return {"tensor_core": by_kernel[ops.TENSOR_CORE], "head_dim": hd, "layers": cfg.n_layers}


def _internvl2_cell(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("internvl2-1b")
    params, n = _draw(cfg, dev, "[hybrid]")
    check(n == 495_640_192, f"internvl2 holds {n} parameters")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), device=dev,
                           generator=gen)
    patches = torch.randn(HYBRID_BATCH, HYBRID_PATCHES, cfg.frontend_dim, device=dev,
                          generator=gen)
    engine = ServeEngine(cfg=cfg, params=params, capacity=HYBRID_PROMPT + HYBRID_NEW,
                         batch_size=HYBRID_BATCH, device=dev)
    batch = {"tokens": tokens, "patches": patches}
    with torch.inference_mode():
        prefill_s = _median_s(lambda: engine._prefill(engine._params, batch), 3)
        with_p, _ = engine._prefill(engine._params, batch)
        without, _ = engine._prefill(engine._params, {"tokens": tokens})
    moved = (with_p.float() - without.float()).abs().max().item()
    check(bool(torch.isfinite(with_p[:, :cfg.vocab_size]).all()) and moved > 0,
          f"internvl2 prefill with patches: logits moved by {moved}")
    print(f"[hybrid] internvl2 prefill with {HYBRID_PATCHES} patch positions (frontend_dim "
          f"{cfg.frontend_dim}) B={HYBRID_BATCH} prompt={HYBRID_PROMPT} (bf16): "
          f"{prefill_s * 1e3:.2f} ms (median of 3); the patches move the last logits by up to "
          f"{moved:.3g}")
    _model_flash_check(cfg, lambda: engine._prefill(engine._params, batch), cfg.n_layers,
                       "[hybrid]")
    del engine
    torch.cuda.empty_cache()
    dims, real = [], attn_mod.flash_attention

    def spy(q, *args, **kw):
        dims.append(q.shape[-1])
        return real(q, *args, **kw)

    attn_mod.flash_attention = spy
    try:
        launches, by_kernel, cache = phase_generate(
            cfg, params, dev, flash_attention, "[hybrid]", b=HYBRID_BATCH, s=HYBRID_PROMPT,
            n_new=HYBRID_NEW)
    finally:
        attn_mod.flash_attention = real
    del cache
    want = {ops.TENSOR_CORE: cfg.n_layers, ops.CUDA_CORE: 0}
    check(by_kernel == want, f"one bf16 generate launched {by_kernel}, want {want}")
    hd, a = attn_mod._flash_head_dim(cfg.attention.head_dim), cfg.attention
    check(set(dims) == {hd}, f"flash head_dims {sorted(set(dims))}, want {hd}")
    print(f"[hybrid] internvl2 flash launches per generate: {by_kernel} at D = {hd}, G = "
          f"{a.n_heads // a.n_kv_heads}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    layers, prompt = HYBRID_F32[cfg.name]
    cut, few = _first_layers(cfg, params, layers)
    del params
    flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
    phase_float32_cuda_vs_cpu(cut, few, dev, "[hybrid]", s=prompt,
                              extra={"patches": patches[:1].cpu()})
    f32 = dict(flash_attention.kernel_launches)
    check(f32 == {ops.CUDA_CORE: layers, ops.TENSOR_CORE: 0},
          f"the float32 check launched {f32}, want {layers} on the CUDA-core kernel")
    print(f"[hybrid] internvl2 float32 check: {layers} layers, prompt {prompt} with "
          f"{HYBRID_PATCHES} patch positions; flash launches {f32}")
    return {"tensor_core": by_kernel[ops.TENSOR_CORE], "head_dim": hd, "layers": cfg.n_layers}


def _hubert_cell(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer
    from repro_torch.serving.engine import _serving_copy

    cfg = get_config("hubert-xlarge")
    params, n = _draw(cfg, dev, "[hybrid]")
    check(n == 1_260_382_720, f"hubert holds {n} parameters")
    served = _serving_copy(params, torch.bfloat16, dev)
    feats = torch.randn(HYBRID_BATCH, HYBRID_PROMPT, cfg.frontend_dim, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))

    def run():
        return transformer.forward(served, cfg, {"features": feats})[0]

    with torch.inference_mode():
        run()                                             # warm
        flash_attention.launches = 0
        flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
        logits = run()
        torch.cuda.synchronize()
        by_kernel, total = dict(flash_attention.kernel_launches), flash_attention.launches
        fwd_s = _median_s(run, 3)
    want = {ops.TENSOR_CORE: cfg.n_layers, ops.CUDA_CORE: 0}
    check(by_kernel == want and total == cfg.n_layers,
          f"one hubert forward launched {by_kernel}, want {want}")
    check(tuple(logits.shape) == (HYBRID_BATCH, HYBRID_PROMPT, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()), "bad hubert logits")
    frames = HYBRID_BATCH * HYBRID_PROMPT
    print(f"[hybrid] hubert transformer.forward on features B={HYBRID_BATCH} S={HYBRID_PROMPT} "
          f"(bf16, {cfg.n_layers} layers): {fwd_s * 1e3:.2f} ms (median of 3), "
          f"{frames / fwd_s:.0f} frames/s; flash launches {by_kernel}, non-causal at D = "
          f"{attn_mod._flash_head_dim(cfg.attention.head_dim)}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.inference_mode():
        pre = _device_kernels(run)
    if pre:
        busy = sum(e.time_range.elapsed_us() for e in pre)
        mine = sum(e.time_range.elapsed_us() for e in pre if "flash_attention" in e.name)
        print(f"[hybrid] hubert forward profile: {len(pre)} device kernels, {busy / 1e3:.2f} ms "
              f"busy; flash_attention {mine / 1e3:.2f} ms = {mine / busy:.1%}; top: "
              f"{_top_kernels(pre, 1)}")
    _model_flash_check(cfg, run, cfg.n_layers, "[hybrid]")
    del served, logits
    torch.cuda.empty_cache()

    layers, prompt = HYBRID_F32[cfg.name]
    cut, few = _first_layers(cfg, params, layers)
    del params
    flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
    _float32_forward_cuda_vs_cpu(cut, few, {"features": feats[:1, :prompt].float().cpu()}, dev,
                                 "[hybrid]")
    f32 = dict(flash_attention.kernel_launches)
    check(f32 == {ops.CUDA_CORE: layers, ops.TENSOR_CORE: 0},
          f"the float32 check launched {f32}, want {layers} on the CUDA-core kernel")
    return {"tensor_core": by_kernel[ops.TENSOR_CORE],
            "head_dim": attn_mod._flash_head_dim(cfg.attention.head_dim), "layers": cfg.n_layers,
            "causal": False}


def phase_hybrid_serving(dev) -> tuple:
    """The hybrid and frontend families; returns, per model, the flash
    launches of one bf16 ``generate`` (hubert: one forward) with their
    head_dim, and the tensor-core kernel's times at the three prefill layers."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    # 17a. the serving launcher, REDUCED; the encoder-only arch refused
    for arch in ("zamba2-2.7b", "internvl2-1b"):
        flash_attention.launches = grid_argmin.launches = 0
        t0 = time.perf_counter()
        check(serve.main(["--arch", arch, "--device", "cuda"]) == 0, "serve.main failed")
        torch.cuda.synchronize()
        fa, ga = flash_attention.launches, grid_argmin.launches
        print(f"[hybrid] launch.serve --arch {arch} --device cuda (REDUCED): "
              f"{time.perf_counter() - t0:.2f} s, flash_attention launches {fa}, grid_argmin "
              f"launches {ga}")
        check(fa > 0 and ga > 0, "the serving launcher launched no flash_attention or grid_argmin")
    try:
        serve.main(["--arch", "hubert-xlarge", "--device", "cuda"])
        raise AssertionError("launch.serve served the encoder-only hubert-xlarge")
    except SystemExit as e:
        check("encoder-only arch has no decode step" in str(e), f"hubert refused with: {e}")
        print(f"[hybrid] launch.serve --arch hubert-xlarge refuses: {e}")
    times = _padded_flash_times(HYBRID_FLASH_SHAPES, 7, dev, "[hybrid]")
    out = {"zamba2-2.7b": _zamba2_cell(dev), "internvl2-1b": _internvl2_cell(dev),
           "hubert-xlarge": _hubert_cell(dev)}
    return out, times


# ---------------------------------------------------------------------------
# 18. training path
# ---------------------------------------------------------------------------


def _hold_train_state(got, want, bound, what: str) -> tuple:
    """float32 trees on the CPU: every leaf within 1e-5·(1 + |x|) at all but
    0.1 % of its elements (2 in a leaf of fewer than 2000) and within
    ``bound`` everywhere, or 2 % of the leaf's largest magnitude where
    ``bound`` is None (Adam divides a near-zero gradient's rounding noise
    by its own RMS: such an element moves by up to lr a step).  Returns the
    largest difference and the count of elements past 1e-5."""
    from repro_torch.models import common

    want = dict(common.tree_leaves(want))
    worst, n_off = 0.0, 0
    for path, a in common.tree_leaves(got):
        diff = (a.float() - want[path].float()).abs()
        off = int((diff > 1e-5 * (1 + want[path].float().abs())).sum())
        check(off <= max(2, TRAIN_OUTLIERS * diff.numel()),
              f"{what} {path}: {off} of {diff.numel()} elements past 1e-5")
        lim = bound if bound is not None else 0.02 * want[path].float().abs().max().item()
        check(diff.max().item() <= lim, f"{what} {path}: max|Δ| {diff.max().item()} > {lim}")
        worst, n_off = max(worst, diff.max().item()), n_off + off
    return worst, n_off


def _train_reduced_cli(dev) -> None:
    """18a. ``launch.train`` REDUCED on the card for every arch, 2 steps
    each (falcon-mamba-7b through the scan's forward and backward kernels);
    a grad-requiring bf16 scan call on the card refused (only float32
    trains there)."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import selective_scan
    from repro_torch.launch import train

    for arch in ARCH_NAMES:
        args = ["--arch", arch, "--device", "cuda", "--steps", "2", "--batch", "2", "--seq",
                "64", "--log-every", "1"]
        flash_attention.launches = flash_attention.bwd_launches = 0
        selective_scan.launches = selective_scan.bwd_launches = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(train.main(args) == 0, f"launch.train --arch {arch} failed")
        torch.cuda.synchronize()
        lines = buf.getvalue().strip().splitlines()
        check(len(lines) == 3 and lines[-1].startswith("loss "), f"{arch}: {lines}")
        cfg = get_config(arch, reduced=True)
        if cfg.ssm is not None and cfg.ssm.kind == "mamba1":
            check(selective_scan.launches > 0 and selective_scan.bwd_launches > 0,
                  f"{arch}: the training run launched no scan forward or backward kernel")
        else:
            check(flash_attention.launches > 0 and flash_attention.bwd_launches > 0,
                  f"{arch}: the training run launched no flash forward or backward kernel")
        print(f"[train] launch.train --arch {arch} --device cuda (REDUCED, 2 steps, B=2, "
              f"S=64): {time.perf_counter() - t0:.2f} s, flash launches "
              f"{flash_attention.launches} forward / {flash_attention.bwd_launches} backward, "
              f"scan launches {selective_scan.launches} forward / "
              f"{selective_scan.bwd_launches} backward; {lines[-1]}")
    x = torch.randn(1, 8, 16, device=dev).bfloat16().requires_grad_()
    b = torch.randn(1, 8, 4, device=dev).bfloat16()
    try:
        selective_scan(x, b, b, x, torch.randn(16, 4, device=dev))
        raise AssertionError("a grad-requiring bf16 selective_scan call on cuda was not refused")
    except TypeError as e:
        check("only float32 trains" in str(e), f"unexpected error: {e}")
        print(f"[train] a grad-requiring bf16 selective_scan call on cuda raises: "
              f"{str(e)[:90]}...")


def _train_flash_checks(cfg, params, batch, dev) -> None:
    """18c. One training forward at full width: every B2 call against the
    plain version, output and row stats, with the Function's output equal
    to the stats launch's; then the Function's dq, dk, dv on layer 0's own
    q, k, v (through the tensor-core backward kernel) against plain
    autograd through ``attention_ref``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import common
    from repro_torch.train.step import make_loss_fn

    real, errs, first = attn_mod.flash_attention, [], []

    def held(q, k, v, **kw):
        out = real(q, k, v, **kw)
        check(out.grad_fn is not None, "a training flash call has no grad_fn")
        fwd = {n: kw[n] for n in ("causal", "window", "softcap", "scale")}
        with torch.no_grad():
            o, m, l = ops.flash_attention_fwd(q, k, v, **fwd)
            ro, rm, rl = flash_attention_ref(q, k, v, return_stats=True, **fwd)
        check(torch.equal(o, out.detach()), "the Function's output is not its kernel's")
        # m: 1e-5·|m| plus the float32 dot product's rounding bound, 2·D·2^-24·scale·|q|·|k|
        # (the kernel and the plain version sum q·k in other orders; near m = 0 that term
        # is all there is)
        g = q.shape[2] // k.shape[2]
        qn = q.float().norm(dim=-1).transpose(1, 2)                             # [B,H,Sq]
        kn = k.float().norm(dim=-1).amax(1).repeat_interleave(g, 1)[..., None]  # [B,H,1]
        m_tol = 1e-5 * rm.abs() + 2 * q.shape[-1] * 2.0 ** -24 * fwd["scale"] * qn * kn
        errs.append(((o.float() - ro.float()).abs().max().item()
                     / max(1.0, ro.float().abs().max().item()),
                     ((m - rm).abs() / m_tol).max().item(),
                     ((l - rl).abs() / rl).max().item(),
                     (m - rm).abs().max().item()))
        del ro, rm, rl, qn, kn, m_tol
        if not first:
            first.append(([t.detach().clone() for t in (q, k, v)], kw))
        return out

    live = common.tree_map(lambda t: t.detach().requires_grad_(), params)
    attn_mod.flash_attention = held
    try:
        with torch.enable_grad():
            loss, _ = make_loss_fn(cfg, TrainConfig())(live, batch)
    finally:
        attn_mod.flash_attention = real
    del loss, live
    torch.cuda.empty_cache()
    worst = [max(e[i] for e in errs) for i in range(4)]
    check(len(errs) == cfg.n_layers, f"{len(errs)} flash calls in a forward")
    check(worst[0] <= FLASH_TOL[torch.bfloat16] and worst[1] <= 1.0
          and worst[2] <= TRAIN_L_RTOL, f"flash stats check: {errs}")
    print(f"[train] every flash call of one training forward ({len(errs)}, bf16) vs the plain "
          f"version: out max|Δ| {worst[0]:.3g} of max(1, max |o|) (tol "
          f"{FLASH_TOL[torch.bfloat16]}), m max|Δ| {worst[3]:.3g}, at most {worst[1]:.3g} of "
          f"its tolerance ({TRAIN_M_RTOL}·|m| + the fp32 dot product's rounding bound), l max "
          f"relative {worst[2]:.3g} (tol {TRAIN_L_RTOL})")

    (q, k, v), kw = first[0]
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev).to(q.dtype)
    grads = []
    bwd_before = dict(flash_attention.bwd_kernel_launches)
    for fn in (flash_attention, flash_attention_ref):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        opts = kw if fn is flash_attention else {n: kw[n] for n in
                                                 ("causal", "window", "softcap", "scale")}
        fn(*ins, **opts).backward(dout)
        grads.append([t.grad for t in ins])
        del ins
        torch.cuda.empty_cache()
    served = {n: flash_attention.bwd_kernel_launches[n] - bwd_before[n] for n in bwd_before}
    check(served == {ops.TENSOR_CORE_BWD: 1, ops.CUDA_CORE_BWD: 0},
          f"the Function's backward launched {served}, want one {ops.TENSOR_CORE_BWD}")
    report = []
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        scale = max(1.0, r.float().abs().max().item())
        err = (a.float() - r.float()).abs().max().item()
        check(a.dtype == r.dtype and err <= FLASH_TOL[torch.bfloat16] * scale,
              f"{name}: max|Δ| {err} > {FLASH_TOL[torch.bfloat16]} x {scale}")
        report.append(f"{name} max|Δ| {err:.3g} (max |g| {scale:.3g})")
    print(f"[train] the Function's backward ({ops.TENSOR_CORE_BWD}) on layer 0's q "
          f"{tuple(q.shape)} k {tuple(k.shape)} vs plain autograd through attention_ref: "
          + ", ".join(report)
          + f" (tol {FLASH_TOL[torch.bfloat16]} of max(1, max |g|))")


def _train_float32_cuda_vs_cpu(cfg, params, dev) -> dict:
    """18d. The model's first 2 layers at full width in float32, card vs
    CPU (llama3.2-1b through the CUDA-core kernel's stats store and the
    CUDA-core backward kernel,
    falcon-mamba-7b through the scan's storing forward and its backward
    kernel): the grads of one batch, then 2 steps: metrics, grads and
    params."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.ssm_scan import selective_scan
    from repro_torch.models import common
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_grad_fn, make_train_step

    n_layers, s, b = TRAIN_F32
    t0 = time.perf_counter()
    cut, few = _first_layers(cfg, params, n_layers)
    cut = dataclasses.replace(cut, dtype="float32")
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                                                 total_steps=10))
    pipe = SyntheticPipeline(DataConfig(global_batch=b, seq_len=s, vocab_size=cut.vocab_size,
                                        seed=3), cut)
    batches = [next(pipe) for _ in range(2)]
    pipe.close()
    runs = []
    flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
    flash_attention.bwd_kernel_launches.update(
        dict.fromkeys(flash_attention.bwd_kernel_launches, 0))
    selective_scan.launches = selective_scan.bwd_launches = 0
    for d in (dev, torch.device("cpu")):
        p = common.tree_map(lambda t: t.to(d), few)
        bs = [{k: torch.from_numpy(v).to(d) for k, v in x.items()} for x in batches]
        _, _, grads = make_grad_fn(cut, tcfg)(p, bs[0])
        st, step, metrics = adamw_init(p), make_train_step(cut, tcfg), []
        for x in bs:
            p, st, m = step(p, st, x)
            metrics.append({k: v.item() for k, v in m.items()})
        to_cpu = lambda t: t.cpu()  # noqa: E731
        runs.append((common.tree_map(to_cpu, grads), metrics, common.tree_map(to_cpu, p),
                     common.tree_map(to_cpu, st.m)))
    del few
    kl = dict(flash_attention.kernel_launches)
    if cfg.family == "ssm":
        kl = {"selective_scan": selective_scan.launches,
              "selective_scan_bwd": selective_scan.bwd_launches}
        check(all(kl.values()), f"float32 scan launches {kl}")
    else:
        kl.update(flash_attention.bwd_kernel_launches)
        check(kl[ops.CUDA_CORE] > 0 and kl[ops.TENSOR_CORE] == 0 and kl[ops.CUDA_CORE_BWD] > 0
              and kl[ops.TENSOR_CORE_BWD] == 0, f"float32 launches {kl}")
    (g_c, m_c, p_c, mo_c), (g_h, m_h, p_h, mo_h) = runs
    worst_m = 0.0
    for a, w in zip(m_c, m_h):
        for k, v in w.items():
            rel = abs(a[k] - v) / max(abs(v), 1e-30)
            check(rel <= 1e-5 or (k == "accuracy" and a[k] == v),
                  f"float32 metric {k}: cuda {a[k]} cpu {v}")
            worst_m = max(worst_m, rel)
    g_want = dict(common.tree_leaves(g_h))
    worst_g = 0.0
    for path, g in common.tree_leaves(g_c):
        check(g is not None and g_want[path] is not None, f"{path}: no gradient")
        tol = 1e-4 * g_want[path].abs().max().item()
        err = (g - g_want[path]).abs().max().item()
        check(err <= tol, f"float32 grad {path}: max|Δ| {err} > {tol}")
        worst_g = max(worst_g, err / max(tol / 1e-4, 1e-30))
    p_worst, p_off = _hold_train_state(p_c, p_h, 2 * TRAIN_LR * 2, "float32 params")
    m_worst, m_off = _hold_train_state(mo_c, mo_h, None, "float32 m")
    print(f"[train] float32 {cut.name} first {n_layers} layers at full width (B={b}, S={s}), "
          f"cuda vs cpu: metrics max relative {worst_m:.3g} (tol 1e-5), grads max|Δ| "
          f"{worst_g:.3g} of each leaf's max |g| (tol 1e-4), params after 2 steps (lr "
          f"{TRAIN_LR:g}) max|Δ| {p_worst:.3g} with {p_off} elements past 1e-5, m max|Δ| "
          f"{m_worst:.3g} ({m_off} past 1e-5); losses {[m['loss'] for m in m_c]}; kernel "
          f"launches {kl}; {time.perf_counter() - t0:.2f} s")
    return kl


def _train_restarts(dev) -> None:
    """18e. ``run_with_restarts`` with a ``FaultInjector`` and a temporary
    checkpoint directory ends with the same params as an unbroken run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import common, transformer
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault import FaultInjector, run_with_restarts
    from repro_torch.train import make_train_step

    cfg = get_config("llama3.2-1b", reduced=True)
    step_fn = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(
        learning_rate=1e-3, total_steps=12, warmup_steps=2)))
    pipe = SyntheticPipeline(DataConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size),
                             cfg)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
               for _ in range(12)]
    pipe.close()

    def one(state, step):
        p, o = state
        p, o, _ = step_fn(p, o, batches[step])
        return p, o

    out = {}
    for name, injector in (("unbroken", None), ("restarted", FaultInjector({5: 1, 10: 3}))):
        params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                    transformer.model_layout(cfg))
        with tempfile.TemporaryDirectory() as d:
            out[name] = run_with_restarts(one, (params, adamw_init(params)), n_steps=12,
                                          ckpt=CheckpointManager(d), ckpt_every=4,
                                          injector=injector)
    a, b = out["restarted"], out["unbroken"]
    check(a["restarts"] == 2 and b["restarts"] == 0 and a["steps"] == b["steps"] == 12,
          f"restarts {a['restarts']}, {b['restarts']}")
    pairs = list(zip(common.tree_leaves(a["state"][0]), common.tree_leaves(b["state"][0])))
    diff = max((x - y).abs().max().item() for (_, x), (_, y) in pairs)
    check(all(torch.equal(x, y) for (_, x), (_, y) in pairs),
          f"the restarted run's params differ from the unbroken run's: max|Δ| {diff}")
    print(f"[train] run_with_restarts (REDUCED llama3.2-1b on cuda, 12 steps, checkpoints every "
          f"4, failures at steps 5 and 10): {a['restarts']} restarts, params bit-equal to an "
          f"unbroken run")


def _b2_training_times(bwd: dict) -> None:
    """18f. B2 under autograd at llama's serving shape (bf16), as phase 5b
    measured it in this run (``bwd`` is 5b's tensor-core record): the
    forward with its stats store plus the backward kernel, beside
    ``scaled_dot_product_attention``'s forward + backward, in turns; the
    backward kernel alone and its bound."""
    from repro_torch.kernels.flash_attention import ops

    ours, sdpa = bwd["fwd_bwd_ms"], bwd["sdpa_fwd_bwd_ms"]
    print(f"[train] B2 under autograd at llama's shape {SERVING_SHAPE[:5]} bf16, causal (phase "
          f"5b's medians in turns): forward (stats store) + backward kernel {ours[0]:.4f} / "
          f"{ours[1]:.4f} ms, SDPA forward + backward {sdpa[0]:.4f} / {sdpa[1]:.4f} ms; the "
          f"backward alone ({ops.TENSOR_CORE_BWD}) {bwd['ms']:.4f} ms, "
          f"{bwd['ms'] / bwd['bound_ms']:.2f}x its bound {bwd['bound_ms']:.4f} ms "
          f"({bwd['bound_by']} at {BF16_OPS_PER_S / 1e12:g} TFLOP/s)")


def _train_step_line(tag, cfg, n_params, b, s, times, losses, peak, extra) -> float:
    """Print a training run's step time against the roofline module's 6·N·T
    compute bound on ``HW_H100``; returns the median step in seconds."""
    from repro_torch.analysis.roofline import model_flops_for, roofline_terms
    from repro_torch.configs.base import ShapeConfig

    step_s = float(np.median(times[1:]))
    mf = model_flops_for(cfg, ShapeConfig("train", s, b, "train"), n_params)
    roof = roofline_terms(mf, 0.0, 0.0, mf, 1, HW_H100)
    print(f"{tag} {cfg.name} ({cfg.n_layers} layers, {n_params} float32 parameters, "
          f"{4 * n_params / 1e9:.2f} GB; AdamW moments {cfg.moment_dtype}), bf16 activations, "
          f"remat, B={b} S={s}: {len(times)} steps of make_train_step through SyntheticPipeline, "
          f"{step_s * 1e3:.1f} ms a step (median of steps 2-{len(times)}; the first "
          f"{times[0] * 1e3:.1f} ms), {b * s / step_s:.0f} tokens/s, 6·N·T bound "
          f"{roof.t_compute * 1e3:.1f} ms at {HW_H100.peak_flops / 1e12:g} TFLOP/s "
          f"({roof.t_compute / step_s:.1%} of it: model-FLOPs utilization); peak device memory "
          f"{peak / 2**30:.2f} GiB; {extra}; losses " + " ".join(f"{x:.4f}" for x in losses))
    return step_s


def _train_mamba(dev) -> dict:
    """18g. Full-width falcon-mamba-7b cut to 8 layers: 8 training steps
    through the scan's kernels (16 forwards with remat and 8 backwards a
    step), the scan backward's share of a forward + backward, a finite
    gradient on every leaf; then its first 2 layers in float32, card vs
    CPU.  Returns the scan kernels' launches in the 8 steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels.ssm_scan import ops, selective_scan
    from repro_torch.models import common, transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_grad_fn, make_train_step

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MAMBA_ARCH), n_layers=MAMBA_TRAIN_LAYERS)
    check(cfg.remat and cfg.dtype == "bfloat16", f"{cfg.name}: want remat and bf16")
    b, s, n_steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=3e-4, warmup_steps=2,
                                                 total_steps=n_steps))
    torch.cuda.reset_peak_memory_stats()
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    n_params = sum(t.numel() for _, t in common.tree_leaves(params))
    opt = adamw_init(params, cfg.moment_dtype)
    step_fn = make_train_step(cfg, tcfg)
    pipe = SyntheticPipeline(DataConfig(global_batch=b, seq_len=s, vocab_size=cfg.vocab_size),
                             cfg)
    selective_scan.launches = selective_scan.bwd_launches = 0
    times, losses = [], []
    for _, batch in zip(range(n_steps), pipe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    pipe.close()
    launches = {"forward": selective_scan.launches, "backward": selective_scan.bwd_launches}
    check(launches == {"forward": 2 * cfg.n_layers * n_steps, "backward": cfg.n_layers * n_steps},
          f"{n_steps} remat steps launched the scan {launches}, want {2 * cfg.n_layers} "
          f"forwards and {cfg.n_layers} backwards a step")
    check(all(np.isfinite(losses)), f"losses {losses}")
    step_s = _train_step_line(
        "[train]", cfg, n_params, b, s, times, losses, torch.cuda.max_memory_allocated(),
        f"scan launches a step {launches['forward'] // n_steps} forward ({cfg.n_layers} + "
        f"{cfg.n_layers} under remat) + {launches['backward'] // n_steps} backward")

    # the scan backward's share of a step: CUDA events around each call
    real, spans = ops.selective_scan_bwd, []

    def timed_bwd(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    pipe = SyntheticPipeline(DataConfig(b, s, cfg.vocab_size, seed=1), cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    pipe.close()
    ops.selective_scan_bwd = timed_bwd
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, grads = make_grad_fn(cfg, tcfg)(params, batch)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
    finally:
        ops.selective_scan_bwd = real
    bwd_ms = sum(a.elapsed_time(z) for a, z in spans)
    check(len(spans) == cfg.n_layers, f"{len(spans)} scan backward calls in a backward")
    print(f"[train] {cfg.name}: one forward + backward {grad_s * 1e3:.1f} ms; the scan backward "
          f"kernel ({len(spans)} calls) {bwd_ms:.1f} ms = {bwd_ms / (grad_s * 1e3):.1%} of it, "
          f"{bwd_ms / (step_s * 1e3):.1%} of a step")
    leaves = list(common.tree_leaves(grads))
    bad = [p for p, g in leaves if g is None or not torch.isfinite(g).all()]
    check(not bad, f"parameters without a finite gradient on the card: {bad}")
    names = {p.rsplit("/", 1)[-1] for p, _ in leaves}
    want = {"A_log", "dt_bias", "D", "conv_w", "conv_b", "x_proj", "dt_proj", "in_proj",
            "out_proj"}
    check(want <= names, f"leaves {sorted(names)} lack {sorted(want - names)}")
    print(f"[train] {cfg.name}: every one of {len(leaves)} parameter leaves has a finite "
          f"gradient on the card, {sorted(want)} among them (largest |g| "
          f"{max(g.abs().max().item() for _, g in leaves):.3g})")
    del grads, leaves, opt
    torch.cuda.empty_cache()
    _train_float32_cuda_vs_cpu(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": {k: v // n_steps for k, v in launches.items()},
            "step_ms": step_s * 1e3, "scan_bwd_ms": bwd_ms}


def phase_training(dev, b2_bwd: dict) -> dict:
    """The training path, with ``b2_bwd`` phase 5b's tensor-core backward
    record; returns B2's launches per step of the full-width llama remat
    run, the backward kernels' launches, the step's time and the attention
    backward's share, and the scan kernels' launches in the full-width
    falcon-mamba run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.models import common, transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_grad_fn, make_train_step

    torch.cuda.empty_cache()
    _train_reduced_cli(dev)

    # 18b. full-width llama3.2-1b, float32 masters, bf16 activations, remat
    cfg = get_config("llama3.2-1b")
    check(cfg.remat and cfg.dtype == "bfloat16", "llama3.2-1b: want remat and bf16")
    b, s, n_steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=3e-4, warmup_steps=2,
                                                 total_steps=n_steps))
    torch.cuda.reset_peak_memory_stats()
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg))
    n_params = sum(t.numel() for _, t in common.tree_leaves(params))
    opt = adamw_init(params, cfg.moment_dtype)
    step_fn = make_train_step(cfg, tcfg)
    pipe = SyntheticPipeline(DataConfig(global_batch=b, seq_len=s, vocab_size=cfg.vocab_size),
                             cfg)
    flash_attention.launches = flash_attention.bwd_launches = 0
    flash_attention.kernel_launches.update(dict.fromkeys(flash_attention.kernel_launches, 0))
    flash_attention.bwd_kernel_launches.update(
        dict.fromkeys(flash_attention.bwd_kernel_launches, 0))
    times, losses = [], []
    for _, batch in zip(range(n_steps), pipe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    pipe.close()
    launches, by_kernel = flash_attention.launches, dict(flash_attention.kernel_launches)
    bwd_by_kernel = dict(flash_attention.bwd_kernel_launches)
    per_step = launches // n_steps
    check(launches == n_steps * 2 * cfg.n_layers and by_kernel[ops.CUDA_CORE] == 0,
          f"{n_steps} remat steps launched {launches} {by_kernel}, want "
          f"{2 * cfg.n_layers} a step on the tensor-core kernel")
    want_bwd = {ops.TENSOR_CORE_BWD: n_steps * cfg.n_layers, ops.CUDA_CORE_BWD: 0}
    check(bwd_by_kernel == want_bwd and flash_attention.bwd_launches == n_steps * cfg.n_layers,
          f"{n_steps} steps launched backward kernels {bwd_by_kernel}, want {want_bwd}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    step_s = _train_step_line(
        "[train]", cfg, n_params, b, s, times, losses, torch.cuda.max_memory_allocated(),
        f"flash launches {per_step} a step ({cfg.n_layers} forward + {cfg.n_layers} under "
        f"remat) {by_kernel}, backward kernel launches {bwd_by_kernel[ops.TENSOR_CORE_BWD] // n_steps} "
        f"a step {bwd_by_kernel}")

    # the attention backward's share of a step: CUDA events around each call
    real, spans = ops.flash_attention_bwd_kernel, []

    def timed_bwd(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    pipe = SyntheticPipeline(DataConfig(b, s, cfg.vocab_size, seed=1), cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    pipe.close()
    ops.flash_attention_bwd_kernel = timed_bwd
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, grads = make_grad_fn(cfg, tcfg)(params, batch)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
    finally:
        ops.flash_attention_bwd_kernel = real
    bwd_ms = sum(a.elapsed_time(z) for a, z in spans)
    check(len(spans) == cfg.n_layers, f"{len(spans)} backward kernel calls in a backward")
    print(f"[train] one forward + backward {grad_s * 1e3:.1f} ms; the attention backward "
          f"({ops.TENSOR_CORE_BWD}, {len(spans)} calls) {bwd_ms:.2f} ms = "
          f"{bwd_ms / (grad_s * 1e3):.1%} of it, {bwd_ms / (step_s * 1e3):.1%} of a step")
    leaves = list(common.tree_leaves(grads))
    bad = [p for p, g in leaves if g is None or not torch.isfinite(g).all()]
    check(not bad, f"parameters without a finite gradient on the card: {bad}")
    print(f"[train] every one of {len(leaves)} parameter leaves has a finite gradient on the "
          f"card (largest |g| {max(g.abs().max().item() for _, g in leaves):.3g})")
    del grads, leaves
    # where a forward + backward's device time goes: its top kernels in one profiled run
    grad_fn = make_grad_fn(cfg, tcfg)
    events = _device_kernels(lambda: grad_fn(params, batch))
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(f"[train] one profiled forward + backward: {len(events)} kernels, {busy_ms:.1f} ms of "
          f"device time; the largest: {_top_kernels(events, 1, k=8)}")
    del events
    torch.cuda.empty_cache()
    _train_flash_checks(cfg, params, batch, dev)
    del opt
    torch.cuda.empty_cache()
    f32 = _train_float32_cuda_vs_cpu(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    _train_restarts(dev)
    _b2_training_times(b2_bwd)
    mamba = _train_mamba(dev)
    return {"flash_per_step": per_step, "mamba": mamba,
            "bwd_per_step": bwd_by_kernel[ops.TENSOR_CORE_BWD] // n_steps,
            "bwd_launches": bwd_by_kernel[ops.TENSOR_CORE_BWD],
            "bwd_launches_f32": f32[ops.CUDA_CORE_BWD], "step_ms": step_s * 1e3,
            "attention_bwd_share": bwd_ms / (grad_s * 1e3)}


# ---------------------------------------------------------------------------
# 19. llama3-405b serving
# ---------------------------------------------------------------------------


def _llama405b_float32_layer(cfg, layer, dev) -> None:
    """19d. The first layer alone in float32, card vs CPU, on a seeded
    hidden state of 256 tokens (the 8.4 GB embedding stays off the CPU)."""
    from repro_torch.models import common, transformer

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    x = torch.randn(1, LLAMA405_F32_TOKENS, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    out = []
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            lp = common.tree_map(lambda t: t.to(device=d, dtype=torch.float32), layer)
            pos = torch.arange(LLAMA405_F32_TOKENS, device=d)[None, :]
            y, _, _ = transformer._apply_dense_or_moe(
                lp, x.to(d), cfg32, kind="dense", is_local=False, positions=pos, cache=None,
                cache_pos=None, return_state=False, cache_capacity=None)
            out.append(y.cpu())
            del lp
    scale = out[1].abs().max().item()
    diff = (out[0] - out[1]).abs().max().item()
    check(diff <= 1e-4 * scale, f"llama3-405b layer 0 float32 cuda vs cpu: max|Δ| {diff}")
    print(f"[405b] layer 0 in float32 on a seeded hidden state [1, {LLAMA405_F32_TOKENS}, "
          f"{cfg.d_model}], cuda vs cpu: max|Δ| {diff:.3g} (tol 1e-4 of the output's max "
          f"|y| {scale:.3g}); {time.perf_counter() - t0:.2f} s")


def phase_llama405b_serving(dev) -> tuple:
    """llama3-405b's serving path; returns its tensor-core launches per
    ``generate`` and B2's times at its prefill layer."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import count_params
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.grid_argmin import grid_argmin
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.serving.engine import ServeEngine

    torch.cuda.empty_cache()
    flash_attention.launches = grid_argmin.launches = 0
    t0 = time.perf_counter()
    check(serve.main(["--arch", "llama3-405b", "--device", "cuda"]) == 0, "serve.main failed")
    torch.cuda.synchronize()
    fa, ga = flash_attention.launches, grid_argmin.launches
    print(f"[405b] launch.serve --arch llama3-405b --device cuda (REDUCED): "
          f"{time.perf_counter() - t0:.2f} s, flash_attention launches {fa}, grid_argmin "
          f"launches {ga}")
    check(fa > 0 and ga > 0, "the serving launcher launched no flash_attention or grid_argmin")
    times = _padded_flash_times(LLAMA405_FLASH_SHAPES, 8, dev, "[405b]")

    full = get_config("llama3-405b")
    cfg = dataclasses.replace(full, n_layers=LLAMA405_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = common.init_params(torch.Generator(device=dev).manual_seed(0),
                                transformer.model_layout(cfg), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in common.tree_leaves(params))
    a = cfg.attention
    print(f"[405b] {cfg.name} full width cut to {cfg.n_layers} of {full.n_layers} layers "
          f"(d_model {cfg.d_model}, {a.n_heads}/{a.n_kv_heads} heads of {a.head_dim}, d_ff "
          f"{cfg.d_ff}, untied vocab {cfg.vocab_size}): count_params {count_params(cfg)} "
          f"({(count_params(cfg) - count_params(dataclasses.replace(cfg, n_layers=0))) // cfg.n_layers} "
          f"a layer; {n_params} drawn, with the norms), {2 * n_params / 1e9:.2f} GB of bf16 "
          f"weights drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    launches, by_kernel, cache = phase_generate(
        cfg, params, dev, flash_attention, "[405b]", b=LLAMA405_BATCH, s=LLAMA405_PROMPT,
        n_new=LLAMA405_NEW, capacity=LLAMA405_PROMPT + LLAMA405_NEW)
    del cache
    want = {ops.TENSOR_CORE: cfg.n_layers, ops.CUDA_CORE: 0}
    check(by_kernel == want, f"one bf16 generate launched {by_kernel}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    check(peak <= 75 * 2**30, f"peak device memory {peak / 2**30:.2f} GiB > 75 GiB")
    print(f"[405b] flash launches per generate: {by_kernel} at D = {a.head_dim}, G = "
          f"{a.n_heads // a.n_kv_heads}; peak device memory {peak / 2**30:.2f} GiB (bf16 "
          f"weights, activations, the decode cache)")
    engine = ServeEngine(cfg=cfg, params=params, capacity=LLAMA405_PROMPT + LLAMA405_NEW,
                         batch_size=LLAMA405_BATCH, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (LLAMA405_BATCH, LLAMA405_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    _model_flash_check(cfg, lambda: engine._prefill(engine._params, {"tokens": prompts}),
                       cfg.n_layers, "[405b]")
    layer0 = common.tree_map(lambda t: t[0].cpu(), params["slots"][0])
    del engine, params
    torch.cuda.empty_cache()
    _llama405b_float32_layer(cfg, layer0, dev)
    return by_kernel[ops.TENSOR_CORE], times


def _timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] phase {label}: {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi, name = _timed("1 device", phase_device)
    _timed("2 build", phase_build)
    argmin = _timed("3 kernels", phase_kernels, dev)
    argmin["launches"] = _timed("4 main path", phase_main_path, dev)
    flash = _timed("5 flash kernels", phase_flash_kernels, dev)
    flash_bwd = _timed("5b flash backward", phase_flash_backward, dev)
    flash_launches = _timed("6 serving path", phase_serving, dev)
    for record in flash:
        record["launches"] = flash_launches[record["name"]]
    scan, scan_bwd = _timed("7 scan kernels", phase_scan_kernels, dev)
    scan["launches"] = _timed("8 mamba serving path", phase_mamba_serving, dev)
    _timed("9 figures", phase_figures, dev)
    _timed("10 campaign", phase_campaign, dev)
    _timed("11 long stream", phase_long_stream, dev)
    _timed("12 predictors", phase_predictors, dev)
    _timed("13 composition", phase_composition, dev)
    _timed("14 serving loop", phase_serving_loop, dev)
    flash[0]["launches_gemma"] = _timed("15 local:global serving", phase_gemma_serving, dev)
    flash[0]["launches_moe"], flash[0]["moe_shapes"] = _timed("16 MoE serving",
                                                              phase_moe_serving, dev)
    flash[0]["launches_hybrid"], flash[0]["hybrid_shapes"] = _timed(
        "17 hybrid and frontends serving", phase_hybrid_serving, dev)
    train = _timed("18 training path", phase_training, dev, flash_bwd[0])
    flash[0]["launches_train"] = train["flash_per_step"]
    flash_bwd[0]["launches"], flash_bwd[0]["launches_train"] = (train["bwd_launches"],
                                                               train["bwd_per_step"])
    flash_bwd[0]["train_step_ms"] = train["step_ms"]
    flash_bwd[0]["attention_bwd_share"] = train["attention_bwd_share"]
    flash_bwd[1]["launches"] = flash_bwd[1]["launches_train"] = train["bwd_launches_f32"]
    scan["launches_train"] = train["mamba"]["per_step"]["forward"]
    scan_bwd["launches"] = train["mamba"]["launches"]["backward"]       # the whole run's
    scan_bwd["launches_train"] = train["mamba"]["per_step"]["backward"]
    flash[0]["launches_llama405b"], flash[0]["llama405b_shapes"] = _timed(
        "19 llama3-405b serving", phase_llama405b_serving, dev)
    records = [argmin, *flash, *flash_bwd, scan, scan_bwd]
    print(f"[time] all phases: {time.perf_counter() - t0:.2f} s")
    print("kernels: " + ", ".join(r["name"] for r in records))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
