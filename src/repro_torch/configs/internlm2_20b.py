"""InternLM2-20B — dense GQA decoder. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    arch_type="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab=92_544,
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297 (InternLM2): 48L d6144 48H kv8 ff16384 v92544",
)
