"""hubert-xlarge [audio] — encoder-only transformer backbone.

48L d_model=1280 16H d_ff=5120 vocab=504 [arXiv:2106.07447]

The conv waveform frontend is a stub: the caller passes precomputed
frame embeddings (``features``, width ``frontend_dim``) for every
sequence position; the model projects them to d_model and runs the
bidirectional encoder.  The 504-way head is HuBERT's masked-unit
prediction target space.  Encoder-only ⇒ no decode shapes.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    attention=AttentionConfig(
        n_heads=16, n_kv_heads=16, head_dim=80,
        rope_theta=10_000.0,
    ),
    causal=False,
    act="gelu",
    frontend="audio",
    frontend_dim=512,                 # conv-stem output width (stubbed)
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, d_ff=128, vocab_size=64,
    attention=dataclasses.replace(CONFIG.attention, n_heads=4, n_kv_heads=4,
                                  head_dim=16),
    frontend_dim=32, q_chunk=32, kv_chunk=32,
)
