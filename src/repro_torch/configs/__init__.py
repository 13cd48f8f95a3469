"""Architecture registry of the port: ``--arch <id>`` resolution.

All ten of the JAX package's architectures are registered; any other name
raises a ``KeyError``.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (deepseek_v2_236b, falcon_mamba_7b, gemma2_2b, gemma3_27b,
                                 hubert_xlarge, internvl2_1b, llama3_2_1b, llama3_405b,
                                 qwen3_moe_235b_a22b, zamba2_2_7b)
from repro_torch.configs.base import (SHAPES, AttentionConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig, ShapeConfig,
                                      SSMConfig, TrainConfig, count_params,
                                      shape_applicable)

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "gemma2-2b": gemma2_2b,
    "gemma3-27b": gemma3_27b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "zamba2-2.7b": zamba2_2_7b,
    "internvl2-1b": internvl2_1b,
    "hubert-xlarge": hubert_xlarge,
    "llama3-405b": llama3_405b,
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> Dict[str, ModelConfig]:
    return {n: get_config(n, reduced) for n in ARCH_NAMES}


__all__ = ["AttentionConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
           "ShapeConfig", "SHAPES", "SSMConfig", "TrainConfig", "ARCH_NAMES",
           "get_config", "all_configs", "count_params",
           "shape_applicable"]
