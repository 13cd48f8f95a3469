"""llama3.2-1b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B]

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=128_256,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=8, head_dim=64,
        rope_theta=500_000.0,
    ),
    act="silu",
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=2,
                                  head_dim=16),
    q_chunk=32, kv_chunk=32,
)
