"""Mamba2-2.7B — attention-free state-space model using SSD
(state-space duality). [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # no separate FFN; the Mamba2 block is the whole mixer
    vocab=50_280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk_size=256),
    rope_type="none",
    source="arXiv:2405.21060 (Mamba2/SSD): 64L d2560 dstate128 v50280",
)
