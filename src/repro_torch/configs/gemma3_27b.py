"""gemma3-27b [dense] — 5:1 local:global attention, QK-norm, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-*-pt]
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    d_ff=21504,
    vocab_size=262_144,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=16, head_dim=128,
        rope_theta=1_000_000.0,       # global layers
        rope_local_theta=10_000.0,    # local layers
        sliding_window=1024,
        pattern_period=6, pattern_local=5,  # 5 local : 1 global
        qk_norm=True,
    ),
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
    fsdp=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=2,
                                  head_dim=16, sliding_window=32),
    fsdp=False, q_chunk=32, kv_chunk=32,
)
