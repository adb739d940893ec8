"""Moonlight-16B-A3B (moonshot) — DeepSeek-V3-style MoE: 64 routed experts
top-6 + 2 shared experts, dense layer 0, MHA (kv=16).
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="dense",  # dense attention; MoE FFN (assigned family tag: dense)
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11_264,  # dense FFN width used for the first (non-MoE) layer
    vocab=163_840,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared_experts=2,
        first_moe_layer=1,
    ),
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B: 48L d2048 16H kv16 64e top-6 ff_e1408 v163840",
)
