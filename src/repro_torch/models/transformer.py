"""Model assembly for the dense decoder (the counterpart of
``repro/models/transformer.py``).

Parameters keep the reference's tree: per-layer tensors carry a leading
``layers`` axis, so ``repro_torch.models.convert.params_from_jax`` maps
the JAX package's tree one to one. The reference applies the stack with
``lax.scan``; here ``run_stack`` is a Python loop over layers that indexes
each stacked tensor (a view, no copy).

Entry points:
  prefill(ctx, params, batch, capacity)   -> (cache, last_logits)
  decode_step(ctx, params, cache, tokens) -> (cache, logits)

KV cache. As in the reference, K and V are stored in bfloat16 whatever
the compute dtype, with shape (L, B, W, Hkv, D), the slot axis padded
with zeros to ``capacity``; decode writes ring slot ``t % W`` and masks
by ``_ring_kv_pos``. Where the reference builds a new cache with
``jnp.pad`` and ``dynamic_update_slice``, this port preallocates the
cache at prefill and writes each step's K/V in place, so ``decode_step``
mutates the tensors of the cache it is given (the returned dict shares
them). ``length`` is a Python int, so decode needs no device sync to find
its slot.

Only the dense decoder is ported. The MoE, SSM (Mamba2), hybrid, MLA,
encoder-decoder (audio) and M-RoPE (vision) branches raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    ParamSpec,
    apply_rope,
    init_params,
    rms_norm,
    swiglu,
)

KV_DTYPE = torch.bfloat16  # the reference's cache dtype, whatever the compute dtype


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Model + runtime configuration. The reference's ``mesh`` (SPMD
    sharding) waits for the multi-device slice (ROADMAP queue 1 item 16)."""

    cfg: ModelConfig
    rcfg: RunConfig


def require_dense(cfg: ModelConfig) -> None:
    """Raise for architecture branches this port does not have yet."""
    if cfg.arch_type in ("ssm", "hybrid") or cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 (SSM) blocks and the SSD kernel wait for "
            "ROADMAP queue 1 item 12"
        )
    waits = {
        "MoE FFN (models/moe.py)": cfg.moe is not None,
        "MLA attention (models/mla.py)": cfg.mla is not None,
        "the encoder-decoder (audio) path": cfg.is_encoder_decoder
        or cfg.arch_type == "audio",
        "M-RoPE (vision) positions": cfg.rope_type == "mrope",
    }
    for what, missing in waits.items():
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {what} waits for ROADMAP queue 1 item 13"
            )


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, n: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    L = (n,)
    lx = ("layers",)
    s = {
        "wq": ParamSpec(L + (d, hq * hd), lx + ("embed", "heads_flat")),
        "wk": ParamSpec(L + (d, hkv * hd), lx + ("embed", "kv_heads_flat")),
        "wv": ParamSpec(L + (d, hkv * hd), lx + ("embed", "kv_heads_flat")),
        "wo": ParamSpec(L + (hq * hd, d), lx + ("heads_flat", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(L + (hq * hd,), lx + ("heads_flat",), init="zeros")
        s["bk"] = ParamSpec(L + (hkv * hd,), lx + ("kv_heads_flat",), init="zeros")
        s["bv"] = ParamSpec(L + (hkv * hd,), lx + ("kv_heads_flat",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec(L + (hd,), lx + (None,), init="ones")
        s["k_norm"] = ParamSpec(L + (hd,), lx + (None,), init="ones")
    return s


def _ffn_specs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    L = (n,)
    lx = ("layers",)
    return {
        "wg": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
        "wu": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
        "wd": ParamSpec(L + (cfg.d_ff, d), lx + ("ff", "embed")),
    }


def _layer_specs(cfg: ModelConfig, n: int) -> dict:
    lx = ("layers",)
    return {
        "ln1": ParamSpec((n, cfg.d_model), lx + (None,), init="ones"),
        "attn": _attn_specs(cfg, n),
        "ln2": ParamSpec((n, cfg.d_model), lx + (None,), init="ones"),
        "ffn": _ffn_specs(cfg, n),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The dense decoder's ``ParamSpec`` tree (the reference's, key for key)."""
    require_dense(cfg)
    d = cfg.d_model
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=d**0.5),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "layers": _layer_specs(cfg, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Layer metadata (per-layer attention window)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> list:
    """Per-layer attention window (None = global attention)."""
    w = []
    globals_ = {0, cfg.n_layers // 2, cfg.n_layers - 1}
    for i in range(cfg.n_layers):
        if cfg.sliding_window is not None and i not in globals_:
            w.append(cfg.sliding_window)
        else:
            w.append(None)
    return w


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view of every stacked tensor."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


# ---------------------------------------------------------------------------
# Attention application
# ---------------------------------------------------------------------------


def _qkv(cfg: ModelConfig, ap: dict, x: torch.Tensor):
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ ap["wq"].to(dt)
    k = x @ ap["wk"].to(dt)
    v = x @ ap["wv"].to(dt)
    if "bq" in ap:
        q = q + ap["bq"].to(dt)
        k = k + ap["bk"].to(dt)
        v = v + ap["bv"].to(dt)
    q = q.reshape(*x.shape[:2], hq, hd)
    k = k.reshape(*x.shape[:2], hkv, hd)
    v = v.reshape(*x.shape[:2], hkv, hd)
    if "q_norm" in ap:
        q = rms_norm(q, ap["q_norm"], cfg.norm_eps)
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, positions):
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def attn_full(
    ctx: ApplyCtx, ap: dict, x, positions, window
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the whole sequence; returns (out, (k, v))."""
    cfg = ctx.cfg
    q, k, v = _qkv(cfg, ap, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = attention(
        q, k, v, positions, positions, causal=True, window=window, rcfg=ctx.rcfg
    )
    out = out.reshape(*x.shape[:2], -1)
    return out @ ap["wo"].to(x.dtype), (k, v)


# ---------------------------------------------------------------------------
# Full-sequence layer body (prefill)
# ---------------------------------------------------------------------------


def layer_full(
    ctx: ApplyCtx, lp: dict, window, h: torch.Tensor, positions
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer over the whole sequence; returns (h, (k, v))."""
    cfg = ctx.cfg
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    attn_out, kv = attn_full(ctx, lp["attn"], hn, positions, window)
    h = h + attn_out
    hn2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
    fp = lp["ffn"]
    return h + swiglu(hn2, fp["wg"], fp["wu"], fp["wd"]), kv


def run_stack(
    ctx: ApplyCtx,
    stack_params: dict,
    windows: list,
    h: torch.Tensor,
    positions,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Apply every layer in order. With ``cache`` ((L, B, W, Hkv, D) K and
    V buffers, W >= S), each layer's K/V are written to slots [0, S)."""
    s = h.shape[1]
    for i, win in enumerate(windows):
        h, (k, v) = layer_full(ctx, _layer(stack_params, i), win, h, positions)
        if cache is not None:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    return h


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed(ctx: ApplyCtx, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype."""
    return params["embed"][tokens.long()].to(ctx.rcfg.cdtype)


def unembed(ctx: ApplyCtx, params, h: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: (B, S, d) -> (B, S, vocab) in ``h.dtype``."""
    h = rms_norm(h, params["final_norm"], ctx.cfg.norm_eps)
    w = params["embed"].T if ctx.cfg.tie_embeddings else params["head"]
    return h @ w.to(h.dtype)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(ctx: ApplyCtx, params, batch, capacity: Optional[int] = None):
    """Fill a KV cache over the whole prompt. Returns (cache, last_logits).

    ``capacity`` reserves extra slots for subsequent decode steps (defaults
    to the prompt length; decode then ring-overwrites the oldest slots,
    which is only correct for pure sliding-window attention).
    """
    cfg = ctx.cfg
    require_dense(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    h = embed(ctx, params, tokens)
    w = max(s, capacity or 0)
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (cfg.n_layers, b, w, hkv, hd)
    main = {
        "k": torch.zeros(shape, dtype=KV_DTYPE, device=dev),
        "v": torch.zeros(shape, dtype=KV_DTYPE, device=dev),
    }
    h = run_stack(ctx, params["layers"], layer_windows(cfg), h, positions, main)
    logits = unembed(ctx, params, h[:, -1:])
    return {"main": main, "length": s}, logits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _ring_kv_pos(length: int, w: int, device=None) -> torch.Tensor:
    """Positions currently held by each ring slot after writing pos=length.

    Slot s holds position p = length - ((length - s) mod W); invalid (never
    written) slots yield negative p.
    """
    s = torch.arange(w, dtype=torch.int32, device=device)
    return length - torch.remainder(length - s, w)


def layer_decode(
    ctx: ApplyCtx, lp: dict, window, lcache: dict, h: torch.Tensor, pos, t: int
) -> torch.Tensor:
    """One-token decode through one layer at position ``t``: writes this
    step's K/V into ring slot ``t % W`` of ``lcache`` (in place) and
    returns the new hidden state."""
    cfg = ctx.cfg
    b = h.shape[0]
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp["attn"], hn)
    q, k = _rope_qk(cfg, q, k, pos)
    kc, vc = lcache["k"], lcache["v"]
    w = kc.shape[1]
    slot = t % w
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    kv_pos = _ring_kv_pos(t, w, h.device).expand(b, w)
    attn_out = attention(
        q, kc.to(hn.dtype), vc.to(hn.dtype), pos, kv_pos,
        causal=True, window=window, rcfg=ctx.rcfg,
    )
    h = h + attn_out.reshape(b, 1, -1) @ lp["attn"]["wo"].to(hn.dtype)
    hn2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
    fp = lp["ffn"]
    return h + swiglu(hn2, fp["wg"], fp["wu"], fp["wd"])


def decode_step(ctx: ApplyCtx, params, cache, tokens: torch.Tensor):
    """One decode step: tokens (B,1) + cache -> (new cache, logits (B,1,V)).
    The cache's K/V tensors are updated in place (see the module note)."""
    cfg = ctx.cfg
    b = tokens.shape[0]
    t = cache["length"]
    pos = torch.full((b, 1), t, dtype=torch.int32, device=tokens.device)
    h = embed(ctx, params, tokens)
    main = cache["main"]
    for i, win in enumerate(layer_windows(cfg)):
        lc = {"k": main["k"][i], "v": main["v"][i]}
        h = layer_decode(ctx, _layer(params["layers"], i), win, lc, h, pos, t)
    new_cache = dict(cache)
    new_cache["length"] = t + 1
    return new_cache, unembed(ctx, params, h)


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------


def init_model_params(
    cfg: ModelConfig, rcfg: RunConfig, generator: torch.Generator, device=None
) -> dict:
    """Random parameters in ``rcfg.pdtype`` drawn from ``generator``."""
    return init_params(param_specs(cfg), generator, rcfg.pdtype, device)
