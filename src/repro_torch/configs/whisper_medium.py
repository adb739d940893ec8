"""Whisper-medium — encoder-decoder transformer backbone. The
mel-spectrogram + conv feature extractor is a STUB: input_specs() feeds
(B, 1500, d_model) precomputed frame embeddings (see DESIGN.md §5).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,  # decoder layers
    n_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51_865,
    rope_type="none",  # whisper uses learned/sinusoidal absolute positions
    encoder_seq_len=1500,
    qkv_bias=True,
    source="arXiv:2212.04356 (Whisper medium): 24+24L d1024 16H ff4096 v51865",
)
