"""DeepSeek-V2 Multi-head Latent Attention, arXiv:2405.04434 (the
counterpart of ``repro/models/mla.py``).

Prefill: the latent is expanded to per-head K/V and goes through the
port's ``attention``, so with ``use_kernels`` it reaches the flash
attention kernel with D = qk_nope + qk_rope (192 for DeepSeek-V2) and
Dv = v_head_dim (128): in bf16 the kernel's ``wgmma`` body, instantiated
for that (D, Dv) pair (other pairs, and float32, take its ``simt`` body).
V is a view of the expanded (B, S, H, nope + Dv) tensor, read in place
with its row stride. Decode: the reference's matrix-absorption
form, in float32: scores against the cached latent plus the shared RoPE
key, so a token costs O(W·r) rather than O(W·H·d). The cache holds only
(latent, k_rope), kv_lora_rank + qk_rope_head_dim values a token. Under
a mesh the absorbed scores and mix run on each rank's shard
(``_latent_sharded``), a cache split over its slots by attention's
flash-decode split.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.attention import NEG_INF, _mask, attention
from repro_torch.models.layers import ParamSpec, apply_rope, rms_norm
from repro_torch.sharding.specs import is_dtensor


def mla_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    L = (n_layers,)
    lx = ("layers",)
    return {
        "wq_a": ParamSpec(L + (d, m.q_lora_rank), lx + ("embed", None)),
        "q_norm": ParamSpec(L + (m.q_lora_rank,), lx + (None,), init="ones"),
        "wq_b": ParamSpec(
            L + (m.q_lora_rank, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            lx + (None, "heads_flat"),
        ),
        "wkv_a": ParamSpec(L + (d, m.kv_lora_rank + m.qk_rope_head_dim), lx + ("embed", None)),
        "kv_norm": ParamSpec(L + (m.kv_lora_rank,), lx + (None,), init="ones"),
        "wkv_b": ParamSpec(
            L + (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
            lx + (None, "heads_flat"),
        ),
        "wo": ParamSpec(L + (h * m.v_head_dim, d), lx + ("heads_flat", "embed")),
    }


def _queries(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr)), RoPE applied to the latter."""
    m = cfg.mla
    b, s, _ = x.shape
    ql = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (ql @ p["wq_b"].to(x.dtype)).reshape(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """(latent (B,S,r) normed, k_rope (B,S,dr) rotated): what the cache keeps."""
    m = cfg.mla
    kv = x @ p["wkv_a"].to(x.dtype)
    latent, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    latent = rms_norm(latent, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return latent, k_rope


def mla_full(
    cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor, rcfg: RunConfig
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence MLA (prefill). Returns (out, (latent, k_rope))."""
    m = cfg.mla
    h = cfg.n_heads
    b, s, _ = x.shape
    q_nope, q_rope = _queries(cfg, p, x, positions)
    latent, k_rope = _latent(cfg, p, x, positions)
    kv = (latent @ p["wkv_b"].to(x.dtype)).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)  # the reference's "bsr,rhe->bshe"
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)  # v: a strided view
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = attention(q, k, v, positions, positions, causal=True, rcfg=rcfg)
    out = out.reshape(b, s, h * m.v_head_dim) @ p["wo"].to(x.dtype)
    return out, (latent, k_rope)


def mla_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    positions: torch.Tensor,  # (B, 1)
    latent_cache: torch.Tensor,  # (B, W, r), the just-written token included
    krope_cache: torch.Tensor,  # (B, W, dr)
    kv_pos: torch.Tensor,  # (B, W) slot positions (negative = unwritten)
) -> torch.Tensor:
    """Absorbed single-token decode, scored and mixed in float32."""
    m = cfg.mla
    b = x.shape[0]
    q_nope, q_rope = _queries(cfg, p, x, positions)  # (B,1,H,dn), (B,1,H,dr)
    kvb = p["wkv_b"].to(x.dtype).reshape(
        m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    wk = kvb[:, :, : m.qk_nope_head_dim].float()  # (r, H, dn)
    wv = kvb[:, :, m.qk_nope_head_dim:].float()  # (r, H, dv)
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope.float(), wk)  # (B,1,H,r)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if is_dtensor(latent_cache):
        out_lat = _latent_sharded(q_eff, q_rope, latent_cache, krope_cache, positions, kv_pos,
                                  scale)
    else:
        lat = latent_cache.float()
        scores = (
            torch.einsum("bshr,bwr->bhsw", q_eff, lat)
            + torch.einsum("bshd,bwd->bhsw", q_rope.float(), krope_cache.float())
        ) * scale
        msk = _mask(positions, kv_pos, True, None)  # (B,1,W)
        scores = torch.where(msk[:, None, :, :], scores, NEG_INF)
        pr = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhsw,bwr->bshr", pr, lat)
    out = torch.einsum("bshr,rhv->bshv", out_lat, wv)
    out = out.to(x.dtype).reshape(b, 1, cfg.n_heads * m.v_head_dim)
    return out @ p["wo"].to(x.dtype)


def _latent_sharded(q_eff, q_rope, latent_cache, krope_cache, positions, kv_pos, scale):
    """The absorbed scores and the latent mix of ``mla_decode`` under a mesh,
    on each rank's shard: the latent and RoPE key are one key of r + dr
    features shared by every head, the latent its value; a cache split over
    its slots takes attention's flash-decode split. Returns (B, 1, H, r)."""
    from repro_torch.models.attention import _split_softmax
    from repro_torch.sharding.specs import Spec, batch_split, from_local, is_sharded_on, to_local

    mesh = latent_cache.device_mesh
    bs = batch_split(mesh, latent_cache.shape[0])
    slots = "model" if is_sharded_on(latent_cache, 1, "model") else None
    q = to_local(mesh, torch.cat([q_eff, q_rope.float()], dim=-1), Spec(bs, None, None, None))
    lat = to_local(mesh, latent_cache, Spec(bs, slots, None)).float()
    kr = to_local(mesh, krope_cache, Spec(bs, slots, None)).float()
    k = torch.cat([lat, kr], dim=-1)[:, :, None, :]
    out = _split_softmax(q, k, lat[:, :, None, :], to_local(mesh, positions, Spec(bs, None)),
                         to_local(mesh, kv_pos, Spec(bs, slots)), True, None,
                         mesh.get_group("model") if slots else None, scale)
    return from_local(mesh, out, Spec(bs, None, None, None), latent_cache)
