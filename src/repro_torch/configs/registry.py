"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (
    hymba_1_5b,
    granite_8b,
    qwen2_vl_72b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    deepseek_v2_236b,
    internlm2_20b,
    whisper_medium,
    qwen3_moe_235b_a22b,
    qwen2_5_3b,
)

_MODULES = (
    hymba_1_5b,
    granite_8b,
    qwen2_vl_72b,
    mamba2_2_7b,
    moonshot_v1_16b_a3b,
    deepseek_v2_236b,
    internlm2_20b,
    whisper_medium,
    qwen3_moe_235b_a22b,
    qwen2_5_3b,
)

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]
