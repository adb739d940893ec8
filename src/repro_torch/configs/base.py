"""Model configuration system (plain-data copy of ``repro.configs.base``).

Every assigned architecture is described by a single frozen ``ModelConfig``.
The model zoo (``repro_torch.models``) consumes only this dataclass — adding an
architecture means adding one config file, no model-code changes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN block."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    # index of first MoE layer; earlier layers use a dense FFN of d_ff
    first_moe_layer: int = 0
    router_aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    d_state: int
    headdim: int = 64
    expand: int = 2
    chunk_size: int = 256
    d_conv: int = 4
    # For hybrid models: the SSM branch can have its own inner width.
    d_inner: Optional[int] = None

    def inner(self, d_model: int) -> int:
        return self.d_inner if self.d_inner is not None else self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int
    q_lora_rank: int
    qk_rope_head_dim: int
    qk_nope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "rope"  # rope | mrope | none (e.g. whisper: learned pos)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w (qwen2-vl)
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA width for hybrid archs
    global_attn_every: int = 0  # 0 = never (all SWA) unless sliding_window None

    # optional blocks
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30s of audio at 50 fps after conv

    # multimodal stub frontends
    n_vision_tokens: int = 0  # vlm: number of patch embeddings per sample

    # norm / activation
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    source: str = ""  # citation for the config numbers

    # ---------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        p = self.vocab * d  # embedding
        if not self.tie_embeddings:
            p += self.vocab * d  # lm head

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                a = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_dim
                a += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                a += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                a += n_q * m.v_head_dim * d
                return a
            return d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d

        def ssm_params() -> int:
            if self.ssm is None:
                return 0
            di = self.ssm.inner(d)
            nh = self.ssm.n_ssm_heads(d)
            # in_proj (z, x, B, C, dt) + conv + out_proj
            conv_dim = di + 2 * self.ssm.d_state
            return (
                d * (2 * di + 2 * self.ssm.d_state + nh)
                + conv_dim * self.ssm.d_conv
                + di * d
                + 2 * nh  # A_log, D
            )

        def ffn_params(layer: int) -> int:
            if self.moe is not None and layer >= self.moe.first_moe_layer:
                e = self.moe
                per = 3 * d * e.d_ff_expert
                return (
                    e.n_experts * per
                    + e.n_shared_experts * per
                    + d * e.n_experts  # router
                )
            return 3 * d * self.d_ff  # gate/up/down

        for layer in range(self.n_layers):
            if self.arch_type == "ssm":
                p += ssm_params()
            elif self.arch_type == "hybrid":
                p += attn_params() + ssm_params()
            else:
                p += attn_params()
            if self.arch_type != "ssm":
                p += ffn_params(layer)
            p += 2 * d  # norms
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder already counted above,
            # add cross-attention per decoder layer.
            for _ in range(self.n_encoder_layers):
                p += attn_params() + 3 * d * self.d_ff + 2 * d
            p += self.n_layers * attn_params()  # cross attn
        return p

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        total = self.n_params()
        n_moe_layers = self.n_layers - e.first_moe_layer
        per = 3 * self.d_model * e.d_ff_expert
        inactive = n_moe_layers * (e.n_experts - e.top_k) * per
        return total - inactive

    def flops_per_token(self) -> float:
        """Dense-equivalent FLOPs to produce one token (2·active params —
        the standard matmul-dominated inference estimate)."""
        return 2.0 * self.n_active_params()

    def bytes_per_token(self, dtype_bytes: int = 2) -> float:
        """DRAM traffic per decode step: every active parameter streamed
        once (bf16 by default). Batch amortizes this, not multiplies it —
        the weight stream is shared across the batch."""
        return float(dtype_bytes) * self.n_active_params()

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (<=2 layers etc.)."""
        kw: dict = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=32 if self.head_dim is not None or self.mla else None,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else self.encoder_seq_len,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            sliding_window=16 if self.sliding_window else None,
        )
        if self.rope_type == "mrope":
            kw["mrope_sections"] = (4, 6, 6)  # sums to reduced head_dim/2

        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                first_moe_layer=min(self.moe.first_moe_layer, 1),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, headdim=16, chunk_size=8,
                d_inner=64 if self.ssm.d_inner is not None else None,
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32, q_lora_rank=48, qk_rope_head_dim=16,
                qk_nope_head_dim=16, v_head_dim=16,
            )
        if self.n_kv_heads == self.n_heads:
            kw["n_kv_heads"] = kw["n_heads"]
        return dataclasses.replace(self, **kw)
