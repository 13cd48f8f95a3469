"""zamba2-2.7b [hybrid] — Mamba-2 backbone + weight-shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 ssm_state=64 vocab=32000
[arXiv:2411.15242]

The shared transformer block (attention + FFN, one set of weights) is
applied every ``shared_attn_every`` Mamba-2 layers.  Zamba2's per-invocation
LoRA deltas on the shared block are omitted, as in the JAX package.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32_000,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=32, head_dim=80,
        rope_theta=10_000.0,
    ),
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  head_dim=64, chunk=256),
    shared_attn_every=6,
    act="gelu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=4,
                                  head_dim=16),
    ssm=dataclasses.replace(CONFIG.ssm, d_state=8, head_dim=16, chunk=16),
    shared_attn_every=2, q_chunk=32, kv_chunk=32,
)
