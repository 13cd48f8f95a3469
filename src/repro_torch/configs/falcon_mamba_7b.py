"""falcon-mamba-7b [ssm] — attention-free Mamba-1. [arXiv:2410.05355]

64L d_model=4096 ssm_state=16 vocab=65024
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    d_ff=0,                           # attention-free, no FFN blocks
    vocab_size=65_024,
    attention=None,
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, chunk=256),
    act="silu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab_size=512,
    ssm=dataclasses.replace(CONFIG.ssm, d_state=4, chunk=16),
)
