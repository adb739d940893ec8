"""Qwen3-MoE-235B-A22B — 128 routed experts top-8, GQA kv=4, head_dim 128,
q/k-norm. [hf:Qwen/Qwen3-30B-A3B scaled per assignment]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=12_288,  # (unused: all layers MoE; kept for reduced/dense fallback)
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        d_ff_expert=1536,
        n_shared_experts=0,
        first_moe_layer=0,
    ),
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-235B-A22B: 94L d4096 64H kv4 128e top-8 ff_e1536 v151936",
)
