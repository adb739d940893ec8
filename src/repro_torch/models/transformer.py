"""Model assembly for the dense decoder, the Mamba2 (SSM) stack, the
hybrid attention + Mamba2 stack and the DeepSeek family's MoE and MLA
branches (the counterpart of ``repro/models/transformer.py``).

Parameters keep the reference's tree: per-layer tensors carry a leading
``layers`` axis, so ``repro_torch.models.convert.params_from_jax`` maps
the JAX package's tree one to one. The reference applies the stack with
``lax.scan``; here ``run_stack`` is a Python loop over layers that indexes
each stacked tensor (a view, no copy). A model whose first MoE layer is
not layer 0 (DeepSeek-V2, Moonlight) keeps its leading dense-FFN layers
apart, in the ``"prologue"`` subtree, applied before the main stack as
the reference's ``run_prologue`` applies it (here ``run_stack`` runs both,
in the order ``_parts`` gives).

Entry points:
  prefill(ctx, params, batch, capacity, out) -> (cache, last_logits)
  decode_step(ctx, params, cache, tokens)     -> (cache, logits)

Cache. As in the reference, every cached tensor is bfloat16 whatever the
compute dtype. A dense model keeps K and V, (L, B, W, Hkv, D), the slot
axis padded with zeros to ``capacity``; decode writes ring slot ``t % W``
and masks by ``_ring_kv_pos`` and the layer's window, every layer over the
one cache width W, window or global. A Mamba2 model keeps no K/V but the
SSM state ``ssm`` (L, B, nh, hd, N) and the conv state ``conv``
(L, B, d_conv - 1, conv_dim); prefill stores the float32 final state
rounded to bf16, and decode widens it to float32, steps, and stores it
rounded again, at the reference's places. A hybrid (Hymba) layer keeps
both: K/V for its attention heads and ``ssm`` / ``conv`` for its Mamba2
heads, which read the same normed input side by side; their outputs are
mixed by ``sigmoid(mix_gate)`` in float32 and cast back to the compute
dtype, as in the reference. An MLA layer keeps no K/V but the normed
latent ``ckv`` (L, B, W, kv_lora_rank) and the rotated RoPE key ``krope``
(L, B, W, qk_rope_head_dim), on the same ring of W slots. The prologue's
layers have a cache of their own, ``"pro"``, beside ``"main"``. Where the
reference builds a new cache with ``jnp.pad`` and ``dynamic_update_slice``, this port
preallocates the cache at prefill and writes each layer's entries and
each step's K/V or states in place, so ``decode_step`` mutates the
tensors of the cache it is given (the returned dict shares them).
``length`` is an int32 scalar tensor on the cache's device: the step
builds its position, its ring slot and the slots' positions from it on
the device and reads nothing back to the host, so the whole step can be
captured once in a CUDA graph and replayed (``serving/engine.py``, whose
serve step advances ``length`` in place).

The dense decoder, the pure SSM stack, the hybrid stack, the MoE FFN
(``models/moe.py``), MLA (``models/mla.py``) and the dense prologue are
ported. The encoder-decoder (audio) and M-RoPE (vision) branches raise
``NotImplementedError`` naming the ROADMAP item that ports them. Hymba's
meta tokens and cross-layer KV sharing are not in the reference, so not
here either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import moe, ssm
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    ParamSpec,
    apply_rope,
    init_params,
    rms_norm,
    swiglu,
)
from repro_torch.models.mla import _latent, mla_decode, mla_full, mla_param_specs

KV_DTYPE = torch.bfloat16  # the reference's cache dtype, whatever the compute dtype


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Model + runtime configuration. The reference's ``mesh`` (SPMD
    sharding) waits for the multi-device slice (ROADMAP queue 1 item 16)."""

    cfg: ModelConfig
    rcfg: RunConfig


def require_ported(cfg: ModelConfig) -> None:
    """Raise for architecture branches this port does not have yet."""
    waits = {
        "the encoder-decoder (audio) path": cfg.is_encoder_decoder
        or cfg.arch_type == "audio",
        "M-RoPE (vision) positions": cfg.rope_type == "mrope",
    }
    for what, missing in waits.items():
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {what} waits for ROADMAP queue 1 item 13(b)"
            )


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, n: int) -> dict:
    if cfg.mla is not None:
        return mla_param_specs(cfg, n)
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


def _ffn_specs(cfg: ModelConfig, n: int, dense: bool) -> dict:
    if cfg.moe is not None and not dense:
        return moe.moe_param_specs(cfg, n)
    d = cfg.d_model
    L = (n,)
    lx = ("layers",)
    return {
        "wg": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
        "wu": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
        "wd": ParamSpec(L + (cfg.d_ff, d), lx + ("ff", "embed")),
    }


def _layer_specs(cfg: ModelConfig, n: int, dense_ffn: bool = False) -> dict:
    lx = ("layers",)
    ln1 = ParamSpec((n, cfg.d_model), lx + (None,), init="ones")
    if cfg.arch_type == "ssm":  # the Mamba2 block is the whole mixer
        return {"ln1": ln1, "ssm": ssm.ssm_param_specs(cfg, n)}
    s = {"ln1": ln1, "attn": _attn_specs(cfg, n)}
    if cfg.arch_type == "hybrid":  # Mamba2 heads beside the attention heads
        s["ssm"] = ssm.ssm_param_specs(cfg, n)
        s["mix_gate"] = ParamSpec((n, 2), lx + (None,), init="ones")
    s["ln2"] = ParamSpec((n, cfg.d_model), lx + (None,), init="ones")
    s["ffn"] = _ffn_specs(cfg, n, dense_ffn)
    return s


def _n_prologue(cfg: ModelConfig) -> int:
    """Leading dense-FFN layers before an MoE stack (0 without MoE)."""
    return cfg.moe.first_moe_layer if cfg.moe is not None else 0


def param_specs(cfg: ModelConfig) -> dict:
    """The model's ``ParamSpec`` tree (the reference's, key for key)."""
    require_ported(cfg)
    d = cfg.d_model
    n_pro = _n_prologue(cfg)
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=d**0.5),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "layers": _layer_specs(cfg, cfg.n_layers - n_pro),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    if n_pro:
        specs["prologue"] = _layer_specs(cfg, n_pro, dense_ffn=True)
    return specs


# ---------------------------------------------------------------------------
# Layer metadata (per-layer attention window)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig, n_layers: Optional[int] = None, offset: int = 0) -> list:
    """Per-layer attention window (None = global attention) of the
    ``n_layers`` layers (all by default) from layer ``offset`` on."""
    w = []
    globals_ = {0, cfg.n_layers // 2, cfg.n_layers - 1}
    n = cfg.n_layers if n_layers is None else n_layers
    for i in range(offset, offset + n):
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


def _mix(lp: dict, attn_out: torch.Tensor, ssm_out: torch.Tensor, dtype) -> torch.Tensor:
    """A hybrid layer's ``sigmoid(mix_gate)``-weighted sum of its attention
    and Mamba2 outputs, in float32 (the reference's float32 gate promotes
    the products), cast to ``dtype``."""
    g = torch.sigmoid(lp["mix_gate"].float())
    return (g[0] * attn_out.float() + g[1] * ssm_out.float()).to(dtype)


# ---------------------------------------------------------------------------
# Full-sequence layer body (prefill)
# ---------------------------------------------------------------------------


def layer_full(
    ctx: ApplyCtx,
    lp: dict,
    window,
    h: torch.Tensor,
    positions,
    lcache: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """One layer over the whole sequence; returns the new hidden state.
    With ``lcache`` (this layer's cache tensors), writes its entries in
    place: K/V (or MLA's latent and RoPE key) to slots [0, S), the SSM and
    conv states, or both."""
    cfg = ctx.cfg
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)

    def mamba2():
        out, state, proj = ssm.mamba2_prefill(cfg, lp["ssm"], hn, ctx.rcfg)
        if lcache is not None:
            lcache["ssm"].copy_(state)  # rounded to the bf16 cache
            lcache["conv"].copy_(ssm.conv_tail(cfg, proj))
        return out

    if cfg.arch_type == "ssm":
        return h + mamba2()
    s = h.shape[1]
    if cfg.mla is not None:
        attn_out, (latent, krope) = mla_full(cfg, lp["attn"], hn, positions, ctx.rcfg)
        if lcache is not None:
            lcache["ckv"][:, :s] = latent
            lcache["krope"][:, :s] = krope
    else:
        attn_out, (k, v) = attn_full(ctx, lp["attn"], hn, positions, window)
        if lcache is not None:
            lcache["k"][:, :s] = k
            lcache["v"][:, :s] = v
    if cfg.arch_type == "hybrid":
        attn_out = _mix(lp, attn_out, mamba2(), hn.dtype)
    h = h + attn_out
    return h + _ffn(ctx, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))


def _ffn(ctx: ApplyCtx, lp: dict, hn2: torch.Tensor) -> torch.Tensor:
    """The layer's FFN: the MoE FFN (its aux loss dropped, as the
    reference's prefill and decode drop it) or the dense SwiGLU."""
    fp = lp["ffn"]
    if "router" in fp:
        return moe.moe_ffn(ctx.cfg, ctx.rcfg, fp, hn2)[0]
    return swiglu(hn2, fp["wg"], fp["wu"], fp["wd"])


def run_stack(
    ctx: ApplyCtx,
    stack_params: dict,
    windows: list,
    h: torch.Tensor,
    positions,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Apply every layer in order. With ``cache`` (stacked (L, ...) cache
    tensors), each layer writes its entries in place (``layer_full``).
    The prologue (the reference's unrolled ``run_prologue``) and the main
    stack each run through here (``_parts``)."""
    for i, win in enumerate(windows):
        lcache = None if cache is None else {name: c[i] for name, c in cache.items()}
        h = layer_full(ctx, _layer(stack_params, i), win, h, positions, lcache)
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


RING_KEYS = ("k", "v", "ckv", "krope")  # the cache tensors with a slot axis


def _parts(cfg: ModelConfig) -> list:
    """(params key, cache key, windows) of each stack in order: the dense
    prologue, if the model has one, then the main stack, whose windows
    count its layers from past the prologue."""
    n_pro = _n_prologue(cfg)
    main = ("layers", "main", layer_windows(cfg, cfg.n_layers - n_pro, n_pro))
    return ([("prologue", "pro", layer_windows(cfg, n_pro))] if n_pro else []) + [main]


def _empty_cache(cfg: ModelConfig, n: int, b: int, w: int, dev) -> Dict[str, torch.Tensor]:
    """The stacked bf16 cache tensors of ``n`` layers and a batch of ``b``
    rows: K/V (or MLA's latent and RoPE key) with ``w`` slots,
    zero-filled, and/or the SSM and conv states of a Mamba2 or hybrid
    model (every layer's prefill overwrites them, so they start
    uninitialised)."""
    cache = {}
    if cfg.mla is not None:
        m = cfg.mla
        cache["ckv"] = torch.zeros((n, b, w, m.kv_lora_rank), dtype=KV_DTYPE, device=dev)
        cache["krope"] = torch.zeros((n, b, w, m.qk_rope_head_dim), dtype=KV_DTYPE, device=dev)
    elif cfg.arch_type != "ssm":
        shape = (n, b, w, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=KV_DTYPE, device=dev)
        cache["v"] = torch.zeros(shape, dtype=KV_DTYPE, device=dev)
    if cfg.arch_type in ("ssm", "hybrid"):
        s = cfg.ssm
        nh = s.n_ssm_heads(cfg.d_model)
        conv_dim = s.inner(cfg.d_model) + 2 * s.d_state
        cache["ssm"] = torch.empty((n, b, nh, s.headdim, s.d_state), dtype=KV_DTYPE, device=dev)
        cache["conv"] = torch.empty((n, b, s.d_conv - 1, conv_dim), dtype=KV_DTYPE, device=dev)
    return cache


def prefill(ctx: ApplyCtx, params, batch, capacity: Optional[int] = None,
            out: Optional[dict] = None):
    """Fill a KV cache over the whole prompt. Returns (cache, last_logits).

    ``capacity`` reserves extra slots for subsequent decode steps (defaults
    to the prompt length; decode then ring-overwrites the oldest slots,
    which is only correct for pure sliding-window attention). ``out`` is
    a cache of ``empty_cache`` to fill in place instead of a new one (its
    slot tensors, K/V or MLA's latent and RoPE key, prologue's included,
    are zeroed first, as a new cache's are: masked slots then hold zeros
    and not an earlier group's entries); it is returned.
    """
    cfg = ctx.cfg
    require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    h = embed(ctx, params, tokens)
    if out is None:
        out = empty_cache(cfg, b, max(s, capacity or 0), dev)
    else:  # a cache preallocated by the caller, prefilled in place
        for _, part, _ in _parts(cfg):
            for name in RING_KEYS:
                if name in out[part]:
                    out[part][name].zero_()
    for key, part, windows in _parts(cfg):
        h = run_stack(ctx, params[key], windows, h, positions, out[part])
    logits = unembed(ctx, params, h[:, -1:])
    out["length"].fill_(s)
    return out, logits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def empty_cache(cfg: ModelConfig, b: int, w: int, device=None) -> dict:
    """A cache of ``b`` rows and ``w`` K/V slots, for ``prefill(...,
    out=)``: the stacked tensors of the main stack (``"main"``) and of the
    prologue (``"pro"``, where the model has one), and a zero ``length``."""
    n_pro = _n_prologue(cfg)
    cache = {"main": _empty_cache(cfg, cfg.n_layers - n_pro, b, w, device)}
    if n_pro:
        cache["pro"] = _empty_cache(cfg, n_pro, b, w, device)
    cache["length"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _ring_kv_pos(length: torch.Tensor, w: int, device=None) -> torch.Tensor:
    """Positions currently held by each ring slot after writing pos=length.

    Slot s holds position p = length - ((length - s) mod W); invalid (never
    written) slots yield negative p.
    """
    s = torch.arange(w, dtype=torch.int32, device=device)
    return length - torch.remainder(length - s, w)


def _ring(t: torch.Tensor, w: int, b: int):
    """(slot, kv_pos) of a step at position ``t`` over ``w`` ring slots,
    shared by every layer (one cache width): the slot ``t % w`` as a (1,)
    int64 index and the (b, w) positions the slots hold once it is
    written, both on the device (no host read)."""
    slot = torch.remainder(t, w).reshape(1).long()
    return slot, _ring_kv_pos(t, w, t.device).expand(b, w)


def layer_decode(
    ctx: ApplyCtx, lp: dict, window, lcache: dict, h: torch.Tensor, pos, ring
) -> torch.Tensor:
    """One-token decode through one layer at positions ``pos``: writes this
    step's K/V (or MLA's latent and RoPE key) into ring slot ``slot`` of
    ``lcache``, where ``ring`` is (slot, kv_pos) from ``_ring`` (None for
    a model without a ring), and/or a Mamba2 layer's new states over its
    old ones (in place), and returns the new hidden state."""
    cfg = ctx.cfg
    b = h.shape[0]
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)

    def mamba2():
        out, st, cv = ssm.mamba2_decode(
            cfg, lp["ssm"], hn, lcache["ssm"].float(), lcache["conv"].to(hn.dtype)
        )
        lcache["ssm"].copy_(st)  # rounded to the bf16 cache
        lcache["conv"].copy_(cv)
        return out

    if cfg.arch_type == "ssm":
        return h + mamba2()
    slot, kv_pos = ring
    if cfg.mla is not None:
        latent, krope = _latent(cfg, lp["attn"], hn, pos)
        ckv, krc = lcache["ckv"], lcache["krope"]
        ckv.index_copy_(1, slot, latent.to(ckv.dtype))
        krc.index_copy_(1, slot, krope.to(krc.dtype))
        attn_out = mla_decode(cfg, lp["attn"], hn, pos, ckv.to(hn.dtype), krc.to(hn.dtype),
                              kv_pos)
    else:
        q, k, v = _qkv(cfg, lp["attn"], hn)
        q, k = _rope_qk(cfg, q, k, pos)
        kc, vc = lcache["k"], lcache["v"]
        kc.index_copy_(1, slot, k.to(kc.dtype))
        vc.index_copy_(1, slot, v.to(vc.dtype))
        attn_out = attention(
            q, kc.to(hn.dtype), vc.to(hn.dtype), pos, kv_pos,
            causal=True, window=window, rcfg=ctx.rcfg,
        )
        attn_out = attn_out.reshape(b, 1, -1) @ lp["attn"]["wo"].to(hn.dtype)
    if cfg.arch_type == "hybrid":
        attn_out = _mix(lp, attn_out, mamba2(), hn.dtype)
    h = h + attn_out
    return h + _ffn(ctx, lp, rms_norm(h, lp["ln2"], cfg.norm_eps))


def decode_step(ctx: ApplyCtx, params, cache, tokens: torch.Tensor):
    """One decode step: tokens (B,1) + cache -> (new cache, logits (B,1,V)).
    The cache's K/V and states are updated in place (see the module note);
    the returned dict holds them and a new ``length`` tensor, one past the
    old, which stays as it was (``serving.engine.make_serve_step`` copies
    it back into the cache's own, so that a captured step advances it in
    place). ``length`` may also be a host int (a cache built by hand). The
    step reads no device value on the host."""
    cfg = ctx.cfg
    b = tokens.shape[0]
    t = cache["length"]
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t, dtype=torch.int32, device=tokens.device)
    pos = t.reshape(1, 1).expand(b, 1)
    h = embed(ctx, params, tokens)
    main = cache["main"]
    slots = next((main[name] for name in ("k", "ckv") if name in main), None)
    ring = None if slots is None else _ring(t, slots.shape[2], b)  # one width for every layer
    for key, part, windows in _parts(cfg):  # the prologue's layers, then the main stack's
        for i, win in enumerate(windows):
            lc = {name: c[i] for name, c in cache[part].items()}
            h = layer_decode(ctx, _layer(params[key], i), win, lc, h, pos, ring)
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
