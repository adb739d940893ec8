"""Granite-8B-Code — llama-architecture dense decoder, GQA kv=8.
[arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=49_152,
    rope_theta=10_000_000.0,
    source="arXiv:2405.04324 (Granite Code): 36L d4096 32H kv8 ff14336 v49152",
)
