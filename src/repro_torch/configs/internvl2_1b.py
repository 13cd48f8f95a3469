"""internvl2-1b [vlm] — InternViT frontend (stub) + Qwen2-0.5B LM backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821]

The modality frontend is a stub: the caller passes precomputed ViT patch
embeddings (``patches``, width ``frontend_dim``) occupying the first
``frontend_len`` sequence positions; the in-model projector MLP maps
them into the LM embedding space.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151_655,
    attention=AttentionConfig(
        n_heads=14, n_kv_heads=2, head_dim=64,
        rope_theta=1_000_000.0,
        attn_bias=True,               # qwen2-style qkv bias
    ),
    act="silu",
    tie_embeddings=True,
    frontend="vit",
    frontend_dim=1024,                # InternViT-300M hidden size
    frontend_len=256,                 # patch tokens per image
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=2,
                                  head_dim=16),
    frontend_dim=32, frontend_len=8, q_chunk=32, kv_chunk=32,
)
