"""Qwen2.5-3B — dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11_008,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-3B: 36L d2048 16H kv2 ff11008 v151936, QKV bias",
)
