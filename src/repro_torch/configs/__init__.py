"""Architecture registry of the port: ``--arch <id>`` resolution.

Nine of the JAX package's ten architectures are registered; llama3-405b
(dense, ROADMAP A12c) raises a ``KeyError`` that says it is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (deepseek_v2_236b, falcon_mamba_7b, gemma2_2b, gemma3_27b,
                                 hubert_xlarge, internvl2_1b, llama3_2_1b,
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
}

ARCH_NAMES: List[str] = list(_MODULES)

#: Architectures of the JAX package that the port cannot run yet.
NOT_PORTED = ("llama3-405b",)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; the port runs "
                       f"{ARCH_NAMES}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> Dict[str, ModelConfig]:
    return {n: get_config(n, reduced) for n in ARCH_NAMES}


__all__ = ["AttentionConfig", "ModelConfig", "MoEConfig", "OptimizerConfig",
           "ShapeConfig", "SHAPES", "SSMConfig", "TrainConfig", "ARCH_NAMES",
           "NOT_PORTED", "get_config", "all_configs", "count_params",
           "shape_applicable"]
