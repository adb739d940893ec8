"""Architecture registry: ``--arch <id>`` resolution.

``REGISTRY`` holds the configurations the JAX package mirrors, key for
key (``ARCH_IDS`` is the JAX package's list); ``PORT_ONLY`` those that run
on the port alone (the published Hymba-1.5B). ``get_config`` finds both."""
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
    hymba_1_5b_base,
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

PORT_ONLY: dict[str, ModelConfig] = {hymba_1_5b_base.CONFIG.name: hymba_1_5b_base.CONFIG}


def get_config(arch: str) -> ModelConfig:
    if arch in PORT_ONLY:
        return PORT_ONLY[arch]
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY) + sorted(PORT_ONLY)}")
    return REGISTRY[arch]
