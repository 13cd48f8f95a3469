"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff=1536/expert vocab=102400 [arXiv:2405.04434]
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    d_ff=12288,
    vocab_size=102_400,
    attention=AttentionConfig(
        kind="mla",
        n_heads=128, n_kv_heads=128, head_dim=192,  # qk_nope + qk_rope
        rope_theta=10_000.0,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160, top_k=6, d_ff_expert=1536,
        n_shared=2, capacity_factor=1.25,
        first_dense_layers=1, d_ff_dense=12288,
    ),
    act="silu",
    fsdp=True,
    moment_dtype="bfloat16",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, d_ff=128, vocab_size=512,
    attention=dataclasses.replace(
        CONFIG.attention, n_heads=4, n_kv_heads=4, head_dim=24,
        kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16),
    moe=dataclasses.replace(CONFIG.moe, n_experts=8, top_k=2, d_ff_expert=32,
                            n_shared=1, first_dense_layers=1, d_ff_dense=128,
                            group_size=64),
    fsdp=False, moment_dtype="float32", q_chunk=32, kv_chunk=32,
)
