"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, QK-norm.

94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert vocab=151936
[hf:Qwen/Qwen3-235B-A22B family]
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    d_ff=6144,                        # unused (all layers MoE); kept for 6ND
    vocab_size=151_936,
    attention=AttentionConfig(
        n_heads=64, n_kv_heads=4, head_dim=128,
        rope_theta=1_000_000.0,
        qk_norm=True,
    ),
    moe=MoEConfig(
        n_experts=128, top_k=8, d_ff_expert=1536,
        n_shared=0, capacity_factor=1.25,
    ),
    act="silu",
    fsdp=True,
    moment_dtype="bfloat16",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=2,
                                  head_dim=16),
    moe=dataclasses.replace(CONFIG.moe, n_experts=8, top_k=2, d_ff_expert=32,
                            group_size=64),
    fsdp=False, moment_dtype="float32", q_chunk=32, kv_chunk=32,
)
