"""Qwen2-VL-72B language backbone — dense GQA decoder with M-RoPE.
Vision encoder (ViT + merger) is a STUB: input_specs() provides
pre-projected patch embeddings (see DESIGN.md §5).
[arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab=152_064,
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),  # t/h/w halves of the 128-dim rotary space
    rope_theta=1_000_000.0,
    n_vision_tokens=256,
    source="arXiv:2409.12191 (Qwen2-VL): 80L d8192 64H kv8 ff29568 v152064, M-RoPE",
)
