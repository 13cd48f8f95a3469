"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256

``fsdp`` shards the masters and both moments over the data axis of
``launch.train``'s mesh; ``moment_dtype`` is read by ``optim.adamw_init``.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128_256,
    attention=AttentionConfig(
        n_heads=128, n_kv_heads=8, head_dim=128,
        rope_theta=500_000.0,
    ),
    act="silu",
    fsdp=True,
    moment_dtype="bfloat16",   # train state must fit 256 x 16 GB
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, d_ff=256, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=8, n_kv_heads=2,
                                  head_dim=16),
    fsdp=False, moment_dtype="float32", q_chunk=32, kv_chunk=32,
)
