"""Model assembly for the dense decoder, the Mamba2 (SSM) stack, the
hybrid attention + Mamba2 stack, the DeepSeek family's MoE and MLA
branches, the encoder-decoder (Whisper) and M-RoPE (Qwen2-VL) branches
(the counterpart of ``repro/models/transformer.py``).

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
  forward_train(ctx, params, batch)          -> (logits, aux)
  prefill(ctx, params, batch, capacity, out) -> (cache, last_logits)
  decode_step(ctx, params, cache, tokens)     -> (cache, logits)
``batch`` holds ``tokens`` (B, S) and, as in the reference,
``enc_feats`` (B, T_enc, d_model) for an encoder-decoder model (the stub
frame embeddings the encoder reads) or ``vision_embeds`` (B, n, d_model)
for a vision model (the stub patch embeddings that replace the first n
token embeddings).

Encoder-decoder (Whisper). ``encode`` runs the encoder stack
(``params["encoder"]``: sinusoidal positions, bidirectional
self-attention, the GELU MLP, LayerNorms with biases) once per prefill;
each decoder layer adds a cross-attention block over its output, whose K
and V prefill stores in the layer's ``cross_k`` / ``cross_v`` cache,
(L, B, T_enc, Hkv, D), with no capacity padding; a decode step reads
them (one query against T_enc keys). Positions are sinusoidal, added to
the embeddings and computed on the device. M-RoPE (Qwen2-VL) rotates Q
and K by three position rows (t, h, w): vision patches on a 16-wide grid
at t = 0, text advancing t past the vision span
(``build_mrope_positions``); a decode step at cache position t sits at
t - n_vision_tokens + 1 on every row, as in the reference.

Cache. As in the reference, every cached tensor is bfloat16 whatever the
compute dtype. A dense model keeps K and V, (L, B, W, Hkv, D), the slot
axis padded with zeros to ``capacity``; decode writes ring slot ``t % W``
and masks by ``_ring_kv_pos`` and the layer's window, every layer over the
one cache width W, window or global. A Mamba2 model keeps no K/V but the
SSM state ``ssm`` (L, B, nh, hd, N) and the conv state ``conv``
(L, B, d_conv - 1, conv_dim); prefill stores the float32 final state
rounded to bf16, and decode widens it to float32, steps, and stores it
rounded again, at the reference's places (with ``use_kernels`` one
kernel launch a layer does all three, in place: ``kernels/ssm_decode``).
A hybrid (Hymba) layer keeps both: K/V for its attention heads and
``ssm`` / ``conv`` for its Mamba2 heads, which read the same normed input
side by side; their outputs are mixed by ``sigmoid(mix_gate)`` in
float32 and cast back to the compute dtype, as in the reference. An MLA layer keeps no K/V but the normed
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

Training (``forward_train``) takes each layer's parameters from one
``unbind`` of every stacked tensor per call (``_unbind``: the backward of
an indexed view costs a zero-filled copy of the whole stack per layer),
and each layer through ``_maybe_remat`` (``RunConfig.remat``). It reads
no kernel under grad: the wrappers raise there (``kernels/runtime.py``),
and the training launcher runs the plain paths, as the reference's does.

Every branch of the reference's model is ported. The ``hybrid`` branch
is the JAX package's Hymba, not the published one: Mamba2 SSD heads, a
``sigmoid(mix_gate)`` blend, an attention ``wo``, globals at {0, n/2,
n - 1}, no meta tokens, no K/V sharing. The published Hymba-1.5B
(``configs/hymba_1_5b_base.py``, arch ``"hymba"``: Mamba-1 heads, 128 meta
tokens, K/V caches shared across layers, a window whose sink keeps the
meta tokens) lives in ``models/hymba.py``; ``param_specs``, ``prefill``,
``decode_step`` and ``empty_cache`` hand a ``"hymba"`` model to it. It
has no training path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import moe, ssm
from repro_torch.models.attention import attention
from repro_torch.models.layers import (
    ParamSpec,
    abstract_params,
    apply_mrope,
    apply_rope,
    gelu_mlp,
    init_params,
    layer_norm,
    param_axes,
    rms_norm,
    swiglu,
)
from repro_torch.models.mla import _latent, mla_decode, mla_full, mla_param_specs
from repro_torch.sharding.specs import fit_dim, is_dtensor, select_layer, unbind_layers

KV_DTYPE = torch.bfloat16  # the reference's cache dtype, whatever the compute dtype


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Model + runtime configuration, and the ``DeviceMesh`` the parameters
    and activations are DTensors over (None: one device, plain tensors)."""

    cfg: ModelConfig
    rcfg: RunConfig
    mesh: Any = None


def constrain_batch(ctx: ApplyCtx, x: torch.Tensor) -> torch.Tensor:
    """Pin activations to batch sharding over the data axes (the
    reference's ``with_sharding_constraint``): a DTensor ``x`` is
    redistributed to its batch over the data axes, the rest replicated
    (a pending partial sum over ``"model"`` is reduced here). The identity
    without a mesh, for a plain tensor, in decode-TP mode on one token, or
    where the batch does not divide."""
    if ctx.mesh is None or not is_dtensor(x):
        return x
    if ctx.rcfg.decode_tp_over_data and x.shape[1] == 1:
        return x  # decode TP mode: leave single-token activations unpinned
    from repro_torch.sharding.specs import Spec, batch_split, placements

    da = batch_split(ctx.mesh, x.shape[0])
    if da is None:
        return x
    return x.redistribute(ctx.mesh, placements(ctx.mesh, Spec(da, *([None] * (x.ndim - 1)))))


def gather_weights(ctx: ApplyCtx, tree, h: torch.Tensor):
    """A layer's weights (a tree, or one tensor) with their shards over the
    data axes gathered, right before ``h`` goes through them (fsdp: gather
    on use, one layer at a time, and again in a rematerialised backward),
    so that the batch stays sharded over the data axes. The identity
    without a mesh, and in decode-TP mode on one token (the contraction
    then reduces activations instead)."""
    if ctx.mesh is None or (ctx.rcfg.decode_tp_over_data and h.shape[1] == 1):
        return tree
    from repro_torch.sharding.specs import gather_data

    if isinstance(tree, dict):
        return {k: gather_weights(ctx, v, h) for k, v in tree.items()}
    return gather_data(tree)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, n: int, cross: bool = False) -> dict:
    if cfg.mla is not None and not cross:
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
    if cfg.arch_type == "audio":  # Whisper's MLP: GELU with biases, no gate
        return {
            "wg": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
            "wd": ParamSpec(L + (cfg.d_ff, d), lx + ("ff", "embed")),
            "bg": ParamSpec(L + (cfg.d_ff,), lx + ("ff",), init="zeros"),
            "bd": ParamSpec(L + (d,), lx + (None,), init="zeros"),
        }
    return {
        "wg": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
        "wu": ParamSpec(L + (d, cfg.d_ff), lx + ("embed", "ff")),
        "wd": ParamSpec(L + (cfg.d_ff, d), lx + ("ff", "embed")),
    }


def _norm_specs(cfg: ModelConfig, n: int, name: str) -> dict:
    """A norm's weight and, for Whisper's LayerNorm, its bias ``name_b``."""
    lx = ("layers",)
    s = {name: ParamSpec((n, cfg.d_model), lx + (None,), init="ones")}
    if cfg.arch_type == "audio":
        s[name + "_b"] = ParamSpec((n, cfg.d_model), lx + (None,), init="zeros")
    return s


def _layer_specs(cfg: ModelConfig, n: int, dense_ffn: bool = False) -> dict:
    lx = ("layers",)
    s = _norm_specs(cfg, n, "ln1")
    if cfg.arch_type == "ssm":  # the Mamba2 block is the whole mixer
        return {**s, "ssm": ssm.ssm_param_specs(cfg, n)}
    s["attn"] = _attn_specs(cfg, n)
    if cfg.arch_type == "hybrid":  # Mamba2 heads beside the attention heads
        s["ssm"] = ssm.ssm_param_specs(cfg, n)
        s["mix_gate"] = ParamSpec((n, 2), lx + (None,), init="ones")
    s.update(_norm_specs(cfg, n, "ln2"))
    s["ffn"] = _ffn_specs(cfg, n, dense_ffn)
    if cfg.is_encoder_decoder:  # a decoder layer's cross attention
        s["cross"] = _attn_specs(cfg, n, cross=True)
        s.update(_norm_specs(cfg, n, "ln_cross"))
    return s


def _n_prologue(cfg: ModelConfig) -> int:
    """Leading dense-FFN layers before an MoE stack (0 without MoE)."""
    return cfg.moe.first_moe_layer if cfg.moe is not None else 0


def param_specs(cfg: ModelConfig) -> dict:
    """The model's ``ParamSpec`` tree (the reference's, key for key)."""
    if cfg.arch_type == "hymba":
        from repro_torch.models import hymba

        return hymba.param_specs(cfg)
    d = cfg.d_model
    n_pro = _n_prologue(cfg)
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=d**0.5),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "layers": _layer_specs(cfg, cfg.n_layers - n_pro),
    }
    if cfg.arch_type == "audio":
        specs["final_norm_b"] = ParamSpec((d,), (None,), init="zeros")
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    if n_pro:
        specs["prologue"] = _layer_specs(cfg, n_pro, dense_ffn=True)
    if cfg.is_encoder_decoder:  # the encoder's layers have no cross attention
        enc = _layer_specs(cfg, cfg.n_encoder_layers, dense_ffn=True)
        specs["encoder"] = {
            "layers": {k: v for k, v in enc.items() if k != "cross" and not k.startswith("ln_cross")},
            "final_norm": ParamSpec((d,), (None,), init="ones"),
            "final_norm_b": ParamSpec((d,), (None,), init="zeros"),
        }
    return specs


# ---------------------------------------------------------------------------
# Layer metadata (per-layer attention window)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig, n_layers: Optional[int] = None, offset: int = 0) -> list:
    """Per-layer attention window (None = global attention) of the
    ``n_layers`` layers (all by default) from layer ``offset`` on. The
    global layers are the configuration's ``global_layers`` where it lists
    them (the published Hymba), else {0, n // 2, n - 1}."""
    w = []
    globals_ = set(getattr(cfg, "global_layers", ())) or {0, cfg.n_layers // 2, cfg.n_layers - 1}
    n = cfg.n_layers if n_layers is None else n_layers
    for i in range(offset, offset + n):
        if cfg.sliding_window is not None and i not in globals_:
            w.append(cfg.sliding_window)
        else:
            w.append(None)
    return w


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view of every stacked tensor (prefill and
    decode)."""
    return {k: _layer(v, i) if isinstance(v, dict) else select_layer(v, i)
            for k, v in stack.items()}


def _unbind(stack: dict) -> list:
    """Every layer's parameters from one ``unbind`` of each stacked tensor
    (the training path). Autograd's backward of ``v[i]`` writes layer i's
    gradient into a zero tensor the size of the whole stack, L times per
    stack; the backward of ``unbind`` is one ``stack`` of the L gradients."""
    cols = {k: _unbind(v) if isinstance(v, dict) else unbind_layers(v) for k, v in stack.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Norm dispatch (RMS, or Whisper's LayerNorm with bias)
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig, lp: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if cfg.arch_type == "audio":
        return layer_norm(x, lp[name], lp[name + "_b"], cfg.norm_eps)
    return rms_norm(x, lp[name], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Attention application
# ---------------------------------------------------------------------------


def _heads(cfg: ModelConfig, ap: dict, x: torch.Tensor, name: str, n_heads: int):
    """``x @ w<name>`` plus its bias, where the model has one, as (B, S,
    n_heads, head_dim)."""
    y = x @ ap["w" + name].to(x.dtype)
    if "b" + name in ap:
        y = y + ap["b" + name].to(x.dtype)
    return fit_dim(y, -1, n_heads).reshape(*x.shape[:2], n_heads, cfg.resolved_head_dim)


def _q(cfg: ModelConfig, ap: dict, x: torch.Tensor) -> torch.Tensor:
    q = _heads(cfg, ap, x, "q", cfg.n_heads)
    return rms_norm(q, ap["q_norm"], cfg.norm_eps) if "q_norm" in ap else q


def _qkv(cfg: ModelConfig, ap: dict, x: torch.Tensor, kv_x: torch.Tensor):
    """Q from ``x``; K and V from ``kv_x`` (``x`` itself, or the encoder's
    output for cross attention)."""
    k = _heads(cfg, ap, kv_x, "k", cfg.n_kv_heads)
    if "k_norm" in ap:
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps)
    return _q(cfg, ap, x), k, _heads(cfg, ap, kv_x, "v", cfg.n_kv_heads)


def _rope_qk(cfg: ModelConfig, q, k, positions, pos3):
    """RoPE by ``positions`` (B, S), M-RoPE by ``pos3`` (3, B, S), or no
    rotation (Whisper's positions are added to the embeddings)."""
    if cfg.rope_type == "rope":
        return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    if cfg.rope_type == "mrope":
        return (apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))
    return q, k


def attn_full(
    ctx: ApplyCtx, ap: dict, x, positions, pos3, window, causal: bool = True
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the whole sequence; returns (out, (k, v))."""
    cfg = ctx.cfg
    q, k, v = _qkv(cfg, ap, x, x)
    q, k = _rope_qk(cfg, q, k, positions, pos3)
    out = attention(
        q, k, v, positions, positions, causal=causal, window=window, rcfg=ctx.rcfg
    )
    out = out.reshape(*x.shape[:2], -1)
    return out @ ap["wo"].to(x.dtype), (k, v)


def cross_attn_full(ctx: ApplyCtx, ap: dict, x, enc_out, enc_pos):
    """Cross attention of the decoder's ``x`` over the encoder's output:
    non-causal, every query at position 0; returns (out, (k, v))."""
    q, k, v = _qkv(ctx.cfg, ap, x, enc_out)
    b, s = x.shape[:2]
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    out = attention(q, k, v, q_pos, enc_pos, causal=False, rcfg=ctx.rcfg)
    return out.reshape(b, s, -1) @ ap["wo"].to(x.dtype), (k, v)


def _store(c: torch.Tensor, new: torch.Tensor, slot: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` (B, S, ...) into cache tensor ``c`` (B, W, ...) in
    place: into slots [0, S) (prefill), or into ring slot ``slot`` (a (1,)
    index; decode). Under a mesh the write is made on each rank's shard
    (``_store_sharded``)."""
    if is_dtensor(c):
        _store_sharded(c, new, slot)
    elif slot is None:
        c[:, :new.shape[1]] = new
    else:
        c.index_copy_(1, slot, new.to(c.dtype))


def _store_sharded(c, new, slot) -> None:
    """``_store`` on DTensors: ``new`` is redistributed to the cache's
    placements and copied into the local shard. Where the slot axis is
    split over mesh axes (the decode cache), a ring write lands only on
    the shard that holds the slot; the others rewrite what they hold."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = c.device_mesh
    cl = c.to_local()
    split = [i for i, p in enumerate(c.placements) if p == Shard(1)]
    nl = new.redistribute(mesh, [Replicate() if p == Shard(1) else p for p in c.placements])
    nl = nl.to_local().to(cl.dtype)
    if slot is None:
        if split:
            raise ValueError("a prefill writes into a cache whose slot axis is whole")
        cl[:, :nl.shape[1]] = nl
        return
    slot = slot.to_local() if is_dtensor(slot) else slot
    first = 0
    for i in split:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    local = slot - first * cl.shape[1]
    inside = (local >= 0) & (local < cl.shape[1])
    local = local.clamp(0, cl.shape[1] - 1)
    keep = cl.index_select(1, local)
    cl.index_copy_(1, local, torch.where(inside.reshape((1,) * cl.ndim), nl, keep))


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
    pos3=None,
    enc=None,
    lcache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer over the whole sequence; returns the new hidden state and
    the layer's MoE aux loss (None for a layer without a router).
    ``enc`` is the encoder's (output, positions) for a decoder layer's
    cross attention. With ``lcache`` (this layer's cache tensors), writes
    its entries in place: K/V (or MLA's latent and RoPE key) to slots
    [0, S), the SSM and conv states, or both, and the cross attention's
    K/V whole."""
    cfg = ctx.cfg
    lp = gather_weights(ctx, lp, h)
    hn = _norm(cfg, lp, "ln1", h)

    def mamba2():
        out, state, proj = ssm.mamba2_prefill(cfg, lp["ssm"], hn, ctx.rcfg)
        if lcache is not None:
            lcache["ssm"].copy_(state)  # rounded to the bf16 cache
            lcache["conv"].copy_(ssm.conv_tail(cfg, proj))
        return out

    if cfg.arch_type == "ssm":
        return h + mamba2(), None
    s = h.shape[1]
    if cfg.mla is not None:
        attn_out, (latent, krope) = mla_full(cfg, lp["attn"], hn, positions, ctx.rcfg)
        if lcache is not None:
            _store(lcache["ckv"], latent)
            _store(lcache["krope"], krope)
    else:
        attn_out, (k, v) = attn_full(ctx, lp["attn"], hn, positions, pos3, window)
        if lcache is not None:
            _store(lcache["k"], k)
            _store(lcache["v"], v)
    if cfg.arch_type == "hybrid":
        attn_out = _mix(lp, attn_out, mamba2(), hn.dtype)
    h = h + attn_out
    if enc is not None:
        c_out, (ck, cv) = cross_attn_full(ctx, lp["cross"], _norm(cfg, lp, "ln_cross", h), *enc)
        h = h + c_out
        if lcache is not None:
            lcache["cross_k"].copy_(ck)
            lcache["cross_v"].copy_(cv)
    ff, aux = _ffn(ctx, lp, _norm(cfg, lp, "ln2", h))
    return h + ff, aux


def _ffn(ctx: ApplyCtx, lp: dict, hn2: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN and its aux loss: the MoE FFN with its load-balance
    loss (which only ``forward_train`` sums; prefill and decode drop it, as
    the reference's do), or Whisper's GELU MLP or the dense SwiGLU, with
    None."""
    fp = lp["ffn"]
    if "router" in fp:
        return moe.moe_ffn(ctx.cfg, ctx.rcfg, ctx.mesh, fp, hn2)
    if ctx.cfg.arch_type == "audio":
        return gelu_mlp(hn2, fp["wg"], fp["bg"], fp["wd"], fp["bd"]), None
    return swiglu(hn2, fp["wg"], fp["wu"], fp["wd"]), None


def run_stack(
    ctx: ApplyCtx,
    stack_params: dict,
    windows: list,
    h: torch.Tensor,
    positions,
    pos3=None,
    enc=None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pin: bool = False,
) -> torch.Tensor:
    """Apply every layer in order. With ``cache`` (stacked (L, ...) cache
    tensors), each layer writes its entries in place (``layer_full``).
    The prologue (the reference's unrolled ``run_prologue``) and the main
    stack each run through here (``_parts``); ``pin`` (the main stack's)
    pins each layer's output to the batch sharding, as the reference's
    scanned body does."""
    for i, win in enumerate(windows):
        lcache = None if cache is None else {name: select_layer(c, i) for name, c in cache.items()}
        h, _ = layer_full(ctx, _layer(stack_params, i), win, h, positions, pos3, enc, lcache)
        if pin:
            h = constrain_batch(ctx, h)
    return h


# ---------------------------------------------------------------------------
# Embedding / positions
# ---------------------------------------------------------------------------


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) int -> (B, S, d) float32 sinusoidal embedding, computed on
    the positions' device (not a table)."""
    half = d // 2
    dim = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = torch.exp(-math.log(10_000.0) * dim / max(half - 1, 1))
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def build_mrope_positions(b: int, s: int, n_vision: int, offset: int = 0,
                          device=None) -> torch.Tensor:
    """(3, B, S) int32 t/h/w position ids: vision patches on a 16-wide grid
    at t = 0, text tokens advancing t past the vision span."""
    idx = torch.arange(s, device=device)
    is_vis = idx < n_vision
    t = torch.where(is_vis, 0, idx - n_vision + 1)
    hh = torch.where(is_vis, idx // 16, t)
    ww = torch.where(is_vis, idx % 16, t)
    pos = torch.stack([t, hh, ww]).to(torch.int32) + offset
    return pos[:, None, :].expand(3, b, s)


def embed(ctx: ApplyCtx, params, tokens: torch.Tensor, positions: torch.Tensor,
          vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings in the compute dtype; a vision model's first
    ``vision_embeds.shape[1]`` rows replaced by ``vision_embeds``, and
    Whisper's sinusoidal positions added."""
    cfg = ctx.cfg
    h = _lookup(params["embed"], tokens).to(ctx.rcfg.cdtype)
    if vision_embeds is not None and cfg.n_vision_tokens:
        nv = vision_embeds.shape[1]
        if nv > h.shape[1]:
            raise ValueError(f"{nv} vision embeds do not fit a prompt of {h.shape[1]} tokens")
        h = torch.cat([vision_embeds.to(h.dtype), h[:, nv:]], dim=1)
    if cfg.rope_type == "none" and cfg.arch_type != "ssm":
        h = h + sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
    return constrain_batch(ctx, h)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; under a mesh, vocab-parallel: the table's embed
    axis is gathered (fsdp), each ``"model"`` shard looks up the tokens in
    its slice of the vocabulary, and the rows are a partial sum over
    ``"model"`` (no gather of the whole table)."""
    if not is_dtensor(table):
        return table[tokens.long()]
    from repro_torch.sharding.specs import Spec, batch_split, from_local, is_sharded_on, to_local

    mesh = table.device_mesh
    bs = batch_split(mesh, tokens.shape[0])
    vs = "model" if is_sharded_on(table, 0, "model") else None
    tl = to_local(mesh, table, Spec(vs, None))
    idx = to_local(mesh, tokens, Spec(bs, None)).long()
    if vs:
        idx = idx - mesh.get_local_rank("model") * tl.shape[0]
    inside = (idx >= 0) & (idx < tl.shape[0])
    rows = tl[idx.clamp(0, tl.shape[0] - 1)] * inside[..., None].to(tl.dtype)
    return from_local(mesh, rows, Spec(bs, None, None), table, partial=("model",) if vs else ())


def unembed(ctx: ApplyCtx, params, h: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: (B, S, d) -> (B, S, vocab) in ``h.dtype``."""
    cfg = ctx.cfg
    if cfg.arch_type == "audio":
        h = layer_norm(h, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    else:
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ gather_weights(ctx, w, h).to(h.dtype)


def _encoder_layer(ctx: ApplyCtx, lp: dict, h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then the GELU MLP."""
    cfg = ctx.cfg
    lp = gather_weights(ctx, lp, h)
    out, _ = attn_full(ctx, lp["attn"], _norm(cfg, lp, "ln1", h), pos, None, None, causal=False)
    h = h + out
    return h + _ffn(ctx, lp, _norm(cfg, lp, "ln2", h))[0]


def encode(ctx: ApplyCtx, params, enc_feats: torch.Tensor, train: bool = False):
    """Whisper's encoder over the stub frame embeddings (B, T_enc, d):
    sinusoidal positions, then per layer bidirectional self-attention and
    the GELU MLP, then the encoder's final LayerNorm. Returns (output,
    positions (B, T_enc)). ``train`` (``forward_train``) takes the layers
    from ``_unbind`` and each through ``_maybe_remat``, as the reference's
    training path takes its scanned encoder body."""
    cfg = ctx.cfg
    b, t, _ = enc_feats.shape
    pos = torch.arange(t, dtype=torch.int32, device=enc_feats.device).expand(b, t)
    h = enc_feats.to(ctx.rcfg.cdtype)
    h = h + sinusoidal_pos(pos, cfg.d_model).to(h.dtype)
    ep = params["encoder"]
    if train:
        body = _maybe_remat(ctx.rcfg, _encoder_layer)
        for lp in _unbind(ep["layers"]):
            h = constrain_batch(ctx, body(ctx, lp, h, pos))
    else:
        for i in range(cfg.n_encoder_layers):
            h = constrain_batch(ctx, _encoder_layer(ctx, _layer(ep["layers"], i), h, pos))
    return layer_norm(h, ep["final_norm"], ep["final_norm_b"], cfg.norm_eps), pos


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep ``aten.mm`` outputs, recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(rcfg: RunConfig, fn):
    """``fn`` rematerialised by ``rcfg.remat`` when grad mode is on (the
    reference's ``_maybe_remat`` around its scanned layer body): ``"none"``
    keeps every activation; ``"full"`` wraps each call in
    ``torch.utils.checkpoint`` (non-reentrant), so backward recomputes the
    layer from its input; ``"dots"`` is the counterpart of
    ``checkpoint_dots_with_no_batch_dims``, a selective checkpoint that
    saves the outputs of ``aten.mm`` (the products of activations with
    weights) and recomputes everything else, ``bmm`` included (attention's
    products, and the MoE expert products, which torch runs as ``bmm``
    where XLA sees no batch dimension). With grad mode off ``fn`` runs as
    it is."""
    if rcfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {rcfg.remat!r}: none | full | dots")
    if rcfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if rcfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _save_weight_products)
    return functools.partial(torch_checkpoint.checkpoint, fn, use_reentrant=False, **kw)


def forward_train(ctx: ApplyCtx, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) [+ vision_embeds | enc_feats] -> (logits (B, S,
    vocab) in the compute dtype, aux: the MoE load-balance loss summed over
    the layers, float32).

    The reference's training forward: the encoder (each layer through
    ``_maybe_remat``), M-RoPE positions, the embeddings, the dense prologue
    (not rematerialised, as the reference's unrolled ``run_prologue``), then
    the main stack, each layer through ``_maybe_remat``. Each stack's
    parameters come from ``_unbind``, once per call. The aux loss is summed
    per stack in layer order, then the prologue's and the main stack's
    added, as the reference sums them."""
    cfg = ctx.cfg
    if cfg.arch_type == "hymba":
        raise NotImplementedError("the published Hymba has no training path")
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    pos3 = (build_mrope_positions(b, s, cfg.n_vision_tokens, device=dev)
            if cfg.rope_type == "mrope" else None)
    enc = encode(ctx, params, batch["enc_feats"], train=True) if cfg.is_encoder_decoder else None
    h = embed(ctx, params, tokens, positions, batch.get("vision_embeds"))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for key, _, windows in _parts(cfg):
        body = layer_full if key == "prologue" else _maybe_remat(ctx.rcfg, layer_full)
        part = torch.zeros((), dtype=torch.float32, device=dev)
        for lp, win in zip(_unbind(params[key]), windows):
            h, a = body(ctx, lp, win, h, positions, pos3, enc)
            if key == "layers":
                h = constrain_batch(ctx, h)
            if a is not None:
                part = part + a
        aux = aux + part
    return unembed(ctx, params, h), aux


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


def _empty_cache(cfg: ModelConfig, n: int, b: int, w: int, dev,
                 enc_len: int, mesh=None) -> Dict[str, torch.Tensor]:
    """The stacked bf16 cache tensors of ``n`` layers and a batch of ``b``
    rows: K/V (or MLA's latent and RoPE key) with ``w`` slots,
    zero-filled, and/or the SSM and conv states of a Mamba2 or hybrid
    model (every layer's prefill overwrites them, so they start
    uninitialised), and an encoder-decoder's cross-attention K/V over
    ``enc_len`` encoder positions (zero-filled; prefill overwrites them
    whole). Under ``mesh`` each is the DTensor of
    ``sharding.specs.prefill_cache_spec``, made shard by shard."""
    def new(name, shape, zero=True):
        if mesh is not None:
            from repro_torch.sharding.specs import prefill_cache_spec, sharded_new

            return sharded_new(mesh, shape, KV_DTYPE, prefill_cache_spec(mesh, name, shape, b),
                               dev, zero)
        return (torch.zeros if zero else torch.empty)(shape, dtype=KV_DTYPE, device=dev)

    cache = {}
    if cfg.mla is not None:
        m = cfg.mla
        cache["ckv"] = new("ckv", (n, b, w, m.kv_lora_rank))
        cache["krope"] = new("krope", (n, b, w, m.qk_rope_head_dim))
    elif cfg.arch_type != "ssm":
        shape = (n, b, w, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["k"] = new("k", shape)
        cache["v"] = new("v", shape)
    if cfg.arch_type in ("ssm", "hybrid"):
        s = cfg.ssm
        nh = s.n_ssm_heads(cfg.d_model)
        conv_dim = s.inner(cfg.d_model) + 2 * s.d_state
        cache["ssm"] = new("ssm", (n, b, nh, s.headdim, s.d_state), zero=False)
        cache["conv"] = new("conv", (n, b, s.d_conv - 1, conv_dim), zero=False)
    if cfg.is_encoder_decoder:
        shape = (n, b, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["cross_k"] = new("cross_k", shape)
        cache["cross_v"] = new("cross_v", shape)
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
    and not an earlier group's entries); it is returned. An
    encoder-decoder model needs ``batch["enc_feats"]``, of as many
    frames as ``out``'s cross-attention cache holds, or a ``ValueError``
    is raised before anything is written.
    """
    cfg = ctx.cfg
    if cfg.arch_type == "hymba":
        from repro_torch.models import hymba

        return hymba.prefill(ctx, params, batch["tokens"], capacity, out)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    enc_len = None
    if cfg.is_encoder_decoder:
        if batch.get("enc_feats") is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its prefill needs "
                             "batch['enc_feats'] (B, T_enc, d_model)")
        enc_len = batch["enc_feats"].shape[1]
        if out is not None and out["main"]["cross_k"].shape[2] != enc_len:
            raise ValueError(f"enc_feats of {enc_len} frames do not fit a cache whose cross "
                             f"attention holds {out['main']['cross_k'].shape[2]}")
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    pos3 = (build_mrope_positions(b, s, cfg.n_vision_tokens, device=dev)
            if cfg.rope_type == "mrope" else None)
    enc = encode(ctx, params, batch["enc_feats"]) if cfg.is_encoder_decoder else None
    h = embed(ctx, params, tokens, positions, batch.get("vision_embeds"))
    if out is None:
        out = empty_cache(cfg, b, max(s, capacity or 0), dev, enc_len, ctx.mesh)
    else:  # a cache preallocated by the caller, prefilled in place
        for _, part, _ in _parts(cfg):
            for name in RING_KEYS:
                if name in out[part]:
                    out[part][name].zero_()
    for key, part, windows in _parts(cfg):
        h = run_stack(ctx, params[key], windows, h, positions, pos3, enc, out[part],
                      pin=key == "layers")
    logits = unembed(ctx, params, h[:, -1:])
    out["length"].fill_(s)
    return out, logits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def empty_cache(cfg: ModelConfig, b: int, w: int, device=None,
                enc_len: Optional[int] = None, mesh=None) -> dict:
    """A cache of ``b`` rows and ``w`` K/V slots, for ``prefill(...,
    out=)``: the stacked tensors of the main stack (``"main"``) and of the
    prologue (``"pro"``, where the model has one), and a zero ``length``.
    An encoder-decoder model's layers also hold the cross-attention K/V
    of ``enc_len`` encoder positions (``cfg.encoder_seq_len`` by
    default), unpadded, as the reference's ``abstract_cache``. Under
    ``mesh`` (a prefill under a mesh) the tensors are DTensors. The
    published Hymba's cache is ``models/hymba.py``'s (one device)."""
    if cfg.arch_type == "hymba":
        from repro_torch.models import hymba

        if mesh is not None:
            raise ValueError("the published Hymba runs on one device")
        return hymba.empty_cache(cfg, b, w, device)
    n_pro = _n_prologue(cfg)
    enc_len = enc_len or cfg.encoder_seq_len
    cache = {"main": _empty_cache(cfg, cfg.n_layers - n_pro, b, w, device, enc_len, mesh)}
    if n_pro:
        cache["pro"] = _empty_cache(cfg, n_pro, b, w, device, enc_len, mesh)
    if mesh is not None:
        from repro_torch.sharding.specs import Spec, sharded_new

        cache["length"] = sharded_new(mesh, (), torch.int32, Spec(), device, True)
    else:
        cache["length"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def prefix_tokens(cfg: ModelConfig) -> int:
    """Positions a prefill puts before every prompt (the published Hymba's
    meta tokens; 0 for every other model)."""
    return getattr(cfg, "n_meta_tokens", 0)


def kv_cache_count(cfg: ModelConfig) -> int:
    """Distinct K/V (or MLA latent) cache entries a row keeps: one per
    attention layer, one per K/V group in the published Hymba, none in an
    attention-free model."""
    if cfg.arch_type == "hymba":
        return cfg.n_kv_caches
    return 0 if cfg.arch_type == "ssm" else cfg.n_layers


def abstract_cache(cfg: ModelConfig, batch: int, w: int, enc_len: Optional[int] = None) -> dict:
    """The cache tree of ``empty_cache`` as meta tensors (the reference's
    ``ShapeDtypeStruct`` cache): capacity ``w`` per attention layer."""
    return empty_cache(cfg, batch, w, "meta", enc_len)


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
    ctx: ApplyCtx, lp: dict, window, lcache: dict, h: torch.Tensor, pos, ring, pos3=None
) -> torch.Tensor:
    """One-token decode through one layer at positions ``pos`` (M-RoPE:
    ``pos3``): writes this step's K/V (or MLA's latent and RoPE key) into
    ring slot ``slot`` of ``lcache``, where ``ring`` is (slot, kv_pos)
    from ``_ring`` (None for a model without a ring), and/or a Mamba2
    layer's new states over its old ones (in place); a decoder layer then
    reads the cross-attention K/V its prefill cached. Returns the new
    hidden state."""
    cfg = ctx.cfg
    lp = gather_weights(ctx, lp, h)
    b = h.shape[0]
    hn = _norm(cfg, lp, "ln1", h)

    def mamba2():
        return ssm.mamba2_decode(cfg, lp["ssm"], hn, lcache, ctx.rcfg)

    if cfg.arch_type == "ssm":
        return h + mamba2()
    slot, kv_pos = ring
    if cfg.mla is not None:
        latent, krope = _latent(cfg, lp["attn"], hn, pos)
        ckv, krc = lcache["ckv"], lcache["krope"]
        _store(ckv, latent, slot)
        _store(krc, krope, slot)
        attn_out = mla_decode(cfg, lp["attn"], hn, pos, ckv.to(hn.dtype), krc.to(hn.dtype),
                              kv_pos)
    else:
        q, k, v = _qkv(cfg, lp["attn"], hn, hn)
        q, k = _rope_qk(cfg, q, k, pos, pos3)
        kc, vc = lcache["k"], lcache["v"]
        _store(kc, k, slot)
        _store(vc, v, slot)
        attn_out = attention(
            q, kc.to(hn.dtype), vc.to(hn.dtype), pos, kv_pos,
            causal=True, window=window, rcfg=ctx.rcfg,
        )
        attn_out = attn_out.reshape(b, 1, -1) @ lp["attn"]["wo"].to(hn.dtype)
    if cfg.arch_type == "hybrid":
        attn_out = _mix(lp, attn_out, mamba2(), hn.dtype)
    h = h + attn_out
    if cfg.is_encoder_decoder:
        q = _q(cfg, lp["cross"], _norm(cfg, lp, "ln_cross", h))
        ck, cv = lcache["cross_k"].to(hn.dtype), lcache["cross_v"].to(hn.dtype)
        el = ck.shape[1]
        enc_pos = torch.arange(el, dtype=torch.int32, device=h.device).expand(b, el)
        q_pos = torch.zeros((b, 1), dtype=torch.int32, device=h.device)
        out = attention(q, ck, cv, q_pos, enc_pos, causal=False, rcfg=ctx.rcfg)
        h = h + out.reshape(b, 1, -1) @ lp["cross"]["wo"].to(hn.dtype)
    ff, _ = _ffn(ctx, lp, _norm(cfg, lp, "ln2", h))
    return h + ff


def decode_step(ctx: ApplyCtx, params, cache, tokens: torch.Tensor):
    """One decode step: tokens (B,1) + cache -> (new cache, logits (B,1,V)).
    The cache's K/V and states are updated in place (see the module note);
    the returned dict holds them and a new ``length`` tensor, one past the
    old, which stays as it was (``serving.engine.make_serve_step`` copies
    it back into the cache's own, so that a captured step advances it in
    place). ``length`` may also be a host int (a cache built by hand). The
    step reads no device value on the host."""
    cfg = ctx.cfg
    if cfg.arch_type == "hymba":
        from repro_torch.models import hymba

        return hymba.decode_step(ctx, params, cache, tokens)
    b = tokens.shape[0]
    t = cache["length"]
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t, dtype=torch.int32, device=tokens.device)
    pos = t.reshape(1, 1).expand(b, 1)
    pos3 = None
    if cfg.rope_type == "mrope":  # text advances from 1 past the vision span
        t3 = t - cfg.n_vision_tokens + 1 if cfg.n_vision_tokens else t
        pos3 = t3.reshape(1, 1, 1).expand(3, b, 1)
    h = embed(ctx, params, tokens, pos)
    main = cache["main"]
    slots = next((main[name] for name in ("k", "ckv") if name in main), None)
    ring = None if slots is None else _ring(t, slots.shape[2], b)  # one width for every layer
    for key, part, windows in _parts(cfg):  # the prologue's layers, then the main stack's
        for i, win in enumerate(windows):
            lc = {name: select_layer(c, i) for name, c in cache[part].items()}
            h = layer_decode(ctx, _layer(params[key], i), win, lc, h, pos, ring, pos3)
            if key == "layers":
                h = constrain_batch(ctx, h)
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


def abstract_model_params(cfg: ModelConfig, rcfg: RunConfig) -> dict:
    return abstract_params(param_specs(cfg), rcfg.pdtype)


def model_param_axes(cfg: ModelConfig) -> dict:
    return param_axes(param_specs(cfg))
