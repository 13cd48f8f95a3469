"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 [arXiv:2408.00118; hf]
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256_000,
    attention=AttentionConfig(
        n_heads=8, n_kv_heads=4, head_dim=256,
        rope_theta=10_000.0,
        sliding_window=4096,
        pattern_period=2, pattern_local=1,   # alternate local/global
        attn_softcap=50.0,
    ),
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=2,
                                  head_dim=16, sliding_window=32),
    q_chunk=32, kv_chunk=32,
)
