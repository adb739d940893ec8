"""Hymba-1.5B — hybrid-head architecture: parallel attention + Mamba heads
per layer, SWA everywhere except a few global-attention layers.
[arXiv:2411.13676]

This entry mirrors the JAX package's approximation, which the tests hold
the port's ``hybrid`` path to: Mamba2 SSD heads, a ``sigmoid(mix_gate)``
blend, an attention ``wo``, globals at {0, n/2, n-1}, no meta tokens and
no K/V sharing. It is not the published model; the published one is
``hymba_1_5b_base.py`` (``hymba-1.5b-base``, the registry's
``PORT_ONLY``), which the benchmark runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,  # GQA kv=5
    d_ff=5504,
    vocab=32_001,
    head_dim=64,  # 1600 / 25
    sliding_window=1024,
    global_attn_every=16,  # layers 0, 16 (and last) use global attention
    ssm=SSMConfig(d_state=16, headdim=64, expand=2, chunk_size=256),
    rope_theta=10_000.0,
    source="arXiv:2411.13676 (Hymba): 32L d1600 25H kv5 ff5504 v32001 s16",
)
