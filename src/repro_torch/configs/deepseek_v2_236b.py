"""DeepSeek-V2-236B — MLA attention (kv_lora=512) + MoE with 2 shared and
160 routed experts (top-6); layer 0 has a dense FFN.
[arXiv:2405.04434]
"""
from repro_torch.configs.base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head KV derived from the shared latent
    d_ff=12_288,  # dense FFN width for layer 0
    vocab=102_400,
    head_dim=192,  # qk_nope(128) + qk_rope(64)
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared_experts=2,
        first_moe_layer=1,
    ),
    rope_theta=10_000.0,
    source="arXiv:2405.04434 (DeepSeek-V2): 60L d5120 128H MLA kv_lora512 160e top-6 v102400",
)
