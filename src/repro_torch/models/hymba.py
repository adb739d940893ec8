"""The published Hymba-1.5B (arXiv:2411.13676; ``configs/hymba_1_5b_base.py``):
its parameter tree, cache, prefill and decode step, reached through
``models/transformer.py``'s entry points for a ``HymbaConfig``.

The layer, in order: RMSNorm; one input projection to x, z and q (and,
in the first layer of a K/V group, a second one to k and v: the published
projection's K and V columns, stacked per group in ``kv_proj``); the
attention branch (RoPE on q and k, GQA 25 over 5, V 128 wide, a window of
1,024 whose sink keeps the meta tokens visible, or full attention in the
global layers); the Mamba-1 branch (``ssm.mamba1_prefill`` /
``mamba1_decode``); the two outputs each through its own RMSNorm
(``attn_norm``, ``ssm_norm``: β1 and β2), averaged in float32, through
``out_proj``; the residual; then ln2, the SwiGLU FFN and the residual.

Meta tokens. ``meta_tokens`` (M, d) stand before every prompt at
positions 0 .. M - 1, and the prompt starts at M: prefill embeds them per
row (exact; a shared precomputed meta prefix is later work), and the
cache's ``length`` counts them.

Cache. ``"main"`` holds K and V once per group, (n_kv_caches, B, W, Hkv,
·): the layers of a group index the same entry (``HymbaConfig.kv_slots``),
and only the group's first layer writes it; ``ssm`` (L, B, di, N) and
``conv`` (L, B, d_conv - 1, di) per layer, bf16, at the places the Mamba2
path keeps them. Window layers keep the one cache width W and mask by
window and sink. Prefill hands each group's unrounded K and V to the
layers that reuse them (the reference has no cache); a decode step writes
the new K/V into the group's entry and every layer of the group reads it.

While a profiler runs, the two branches of a prefill layer are named
``model.hybrid.attn`` and ``model.hybrid.ssm`` (``serving/tracing.py``).
Training (``forward_train``) does not take this model.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import ssm
from repro_torch.models.attention import attention
from repro_torch.models.layers import ParamSpec, apply_rope, rms_norm, swiglu
from repro_torch.models.transformer import (
    KV_DTYPE,
    ApplyCtx,
    _layer,
    _ring,
    _ring_kv_pos,
    _store,
    embed,
    layer_windows,
    unembed,
)
from repro_torch.serving.tracing import trace_range


def _dims(cfg):
    di = cfg.ssm.inner(cfg.d_model)
    return di, cfg.ssm.d_state, cfg.resolved_head_dim, cfg.v_head_dim


def param_specs(cfg) -> dict:
    """The published model's tree: ``embed``, ``final_norm``, ``meta_tokens``,
    ``kv_proj`` (one per K/V group) and the stacked ``layers``."""
    d, L = cfg.d_model, cfg.n_layers
    di, n, hd, dv = _dims(cfg)
    hq, hkv, r = cfg.n_heads, cfg.n_kv_heads, cfg.dt_rank
    if hq * dv != di:
        raise ValueError(f"the attention output ({hq} x {dv}) and the SSM's ({di}) must be "
                         "one width: out_proj takes their mean")

    def spec(*shape, init="normal"):
        return ParamSpec((L, *shape), ("layers",) + (None,) * len(shape), init=init)

    layers = {
        "ln1": spec(d, init="ones"),
        "in_proj": spec(d, 2 * di + hq * hd),  # x, z, q
        "conv_w": spec(cfg.ssm.d_conv, di),
        "conv_b": spec(di, init="zeros"),
        "x_proj": spec(di, r + 2 * n),  # dt, B, C
        "dt_norm": spec(r, init="ones"),
        "B_norm": spec(n, init="ones"),
        "C_norm": spec(n, init="ones"),
        "dt_proj": spec(r, di),
        "dt_bias": spec(di, init="zeros"),
        "A_log": spec(di, n, init="ones"),
        "D": spec(di, init="ones"),
        "attn_norm": spec(hq * dv, init="ones"),
        "ssm_norm": spec(di, init="ones"),
        "out_proj": spec(di, d),
        "ln2": spec(d, init="ones"),
        "ffn": {"wg": spec(d, cfg.d_ff), "wu": spec(d, cfg.d_ff), "wd": spec(cfg.d_ff, d)},
    }
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "meta_tokens": ParamSpec((cfg.n_meta_tokens, d), (None, "embed")),
        "kv_proj": ParamSpec((cfg.n_kv_caches, d, hkv * (hd + dv)), (None, "embed", None)),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    return specs


def empty_cache(cfg, b: int, w: int, device=None, dtype: torch.dtype = KV_DTYPE) -> dict:
    """K/V of ``w`` slots per group (zero-filled), and per layer the SSM and
    conv states (every prefill overwrites them), in ``dtype`` (bf16, as
    every cache of the port; the tests also build a float32 one, which
    rounds nothing); a zero ``length``."""
    di, n, hd, dv = _dims(cfg)
    kv, L = cfg.n_kv_caches, cfg.n_layers
    main = {
        "k": torch.zeros((kv, b, w, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((kv, b, w, cfg.n_kv_heads, dv), dtype=dtype, device=device),
        "ssm": torch.empty((L, b, di, n), dtype=dtype, device=device),
        "conv": torch.empty((L, b, cfg.ssm.d_conv - 1, di), dtype=dtype, device=device),
    }
    return {"main": main, "length": torch.zeros((), dtype=torch.int32, device=device)}


def _window(cfg, i: int):
    """Layer ``i``'s (window, sink): the global layers attend over every key."""
    window = layer_windows(cfg, 1, i)[0]
    return window, 0 if window is None else cfg.n_meta_tokens


def _mix(cfg, lp: dict, attn_out: torch.Tensor, ssm_out: torch.Tensor) -> torch.Tensor:
    """out_proj((norm_β1(attn) + norm_β2(ssm)) / 2), the mean in float32."""
    a = rms_norm(attn_out, lp["attn_norm"], cfg.norm_eps).float()
    s = rms_norm(ssm_out, lp["ssm_norm"], cfg.norm_eps).float()
    return ((a + s) * 0.5).to(attn_out.dtype) @ lp["out_proj"].to(attn_out.dtype)


def _split(cfg, lp: dict, hn: torch.Tensor):
    di, _, hd, _ = _dims(cfg)
    proj = hn @ lp["in_proj"].to(hn.dtype)
    x, z, q = proj.split([di, di, cfg.n_heads * hd], dim=-1)
    return x, z, q.reshape(*hn.shape[:2], cfg.n_heads, hd)


def _kv(cfg, params: dict, slot: int, hn: torch.Tensor, positions):
    """The group's K (rotated) and V from layer input ``hn``."""
    _, _, hd, dv = _dims(cfg)
    hkv = cfg.n_kv_heads
    kv = hn @ params["kv_proj"][slot].to(hn.dtype)
    k, v = kv.split([hkv * hd, hkv * dv], dim=-1)
    k = apply_rope(k.reshape(*hn.shape[:2], hkv, hd), positions, cfg.rope_theta)
    return k, v.reshape(*hn.shape[:2], hkv, dv)


def layer_full(ctx: ApplyCtx, params: dict, i: int, h: torch.Tensor, positions,
               cache: Optional[dict], shared: Dict[int, tuple]) -> torch.Tensor:
    """Layer ``i`` over the whole sequence (meta tokens included). Writes
    its group's K/V (first layer of a group only) and its own SSM and conv
    states into ``cache`` where one is given; ``shared`` carries each
    group's K and V from its first layer to the others."""
    cfg = ctx.cfg
    lp = _layer(params["layers"], i)
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    x, z, q = _split(cfg, lp, hn)
    slot = cfg.kv_slots()[i]
    if cfg.kv_owner(i) == i:
        shared[slot] = _kv(cfg, params, slot, hn, positions)
        if cache is not None:
            _store(cache["k"][slot], shared[slot][0])
            _store(cache["v"][slot], shared[slot][1])
    k, v = shared[slot]
    q = apply_rope(q, positions, cfg.rope_theta)
    window, sink = _window(cfg, i)
    with trace_range("model.hybrid.attn"):
        attn_out = attention(q, k, v, positions, positions, causal=True, window=window,
                             rcfg=ctx.rcfg, sink=sink)
    with trace_range("model.hybrid.ssm"):
        y = ssm.mamba1_prefill(cfg, lp, x, z, ctx.rcfg,
                               None if cache is None else cache["ssm"][i])
        if cache is not None:
            cache["conv"][i].copy_(ssm.mamba1_conv_tail(cfg, x))
    h = h + _mix(cfg, lp, attn_out.reshape(*h.shape[:2], -1), y)
    fp = lp["ffn"]
    return h + swiglu(rms_norm(h, lp["ln2"], cfg.norm_eps), fp["wg"], fp["wu"], fp["wd"])


def _with_meta(ctx: ApplyCtx, params: dict, tokens: torch.Tensor):
    """The meta tokens, then the prompt's embeddings: (B, M + S, d) in the
    compute dtype, and positions 0 .. M + S - 1."""
    cfg = ctx.cfg
    b, s = tokens.shape
    m = cfg.n_meta_tokens
    positions = torch.arange(m + s, dtype=torch.int32, device=tokens.device).expand(b, m + s)
    h = embed(ctx, params, tokens, positions[:, m:])
    meta = params["meta_tokens"].to(h.dtype)[None].expand(b, m, cfg.d_model)
    return torch.cat([meta, h], dim=1), positions


def forward(ctx: ApplyCtx, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, vocab) at every prompt position, no cache (the tests'
    whole-sequence pass)."""
    h, positions = _with_meta(ctx, params, tokens)
    shared: Dict[int, tuple] = {}
    for i in range(ctx.cfg.n_layers):
        h = layer_full(ctx, params, i, h, positions, None, shared)
    return unembed(ctx, params, h[:, ctx.cfg.n_meta_tokens:])


def prefill(ctx: ApplyCtx, params: dict, tokens: torch.Tensor, capacity: Optional[int] = None,
            out: Optional[dict] = None):
    """``transformer.prefill`` for the published Hymba: the meta tokens and
    the prompt through every layer, the cache filled in place (``out``, or
    a new one of ``max(M + S, capacity)`` slots). Returns (cache, the last
    position's logits); the cache's ``length`` is M + S."""
    cfg = ctx.cfg
    h, positions = _with_meta(ctx, params, tokens)
    t = h.shape[1]
    if out is None:
        out = empty_cache(cfg, tokens.shape[0], max(t, capacity or 0), tokens.device)
    else:
        if out["main"]["k"].shape[2] < t:
            raise ValueError(f"{t} positions (meta tokens included) overflow a cache of "
                             f"{out['main']['k'].shape[2]} slots")
        out["main"]["k"].zero_()
        out["main"]["v"].zero_()
    shared: Dict[int, tuple] = {}
    for i in range(cfg.n_layers):
        h = layer_full(ctx, params, i, h, positions, out["main"], shared)
    logits = unembed(ctx, params, h[:, -1:])
    out["length"].fill_(t)
    return out, logits


def _window_keys(t: torch.Tensor, w: int, window: int, sink: int, b: int):
    """The keys a window layer's decode query at position ``t`` can see,
    out of a cache of ``w`` ring slots: the slots of positions [0, sink)
    and of the window's last ``window`` positions, as a (sink + window,)
    index, and the (b, sink + window) positions they hold where a slot
    holds the one wanted, else -1 (never written, overwritten, or a window
    position inside the sink, which its first part already reads)."""
    dev = t.device
    want = torch.cat([torch.arange(sink, dtype=torch.int32, device=dev),
                      t - window + 1 + torch.arange(window, dtype=torch.int32, device=dev)])
    slot = torch.remainder(want, w)
    floor = torch.cat([torch.zeros(sink, dtype=torch.int32, device=dev),
                       torch.full((window,), sink, dtype=torch.int32, device=dev)])
    ok = (_ring_kv_pos(t, w, dev)[slot] == want) & (want >= floor)
    return slot.long(), torch.where(ok, want, -1).expand(b, -1)


def decode_step(ctx: ApplyCtx, params: dict, cache: dict, tokens: torch.Tensor):
    """``transformer.decode_step`` for the published Hymba: one token per
    row at position ``length``; the first layer of each group writes the
    group's K/V into ring slot ``length % W``; every layer steps its SSM and
    conv states in place. A window layer reads only the slots of its sink
    and window (``_window_keys``, gathered once a group), not all W: the
    keys its mask keeps are the same. Reads nothing back to the host."""
    cfg = ctx.cfg
    b = tokens.shape[0]
    t = cache["length"]
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t, dtype=torch.int32, device=tokens.device)
    pos = t.reshape(1, 1).expand(b, 1)
    main = cache["main"]
    w = main["k"].shape[2]
    ring_slot, kv_pos = _ring(t, w, b)
    window_keys = None
    if cfg.sliding_window is not None and cfg.sliding_window + cfg.n_meta_tokens < w:
        window_keys = _window_keys(t, w, cfg.sliding_window, cfg.n_meta_tokens, b)
    h = embed(ctx, params, tokens, pos)
    slots = cfg.kv_slots()
    gathered: Dict[int, tuple] = {}
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        x, z, q = _split(cfg, lp, hn)
        kc, vc = main["k"][slots[i]], main["v"][slots[i]]
        if cfg.kv_owner(i) == i:
            k, v = _kv(cfg, params, slots[i], hn, pos)
            _store(kc, k, ring_slot)
            _store(vc, v, ring_slot)
        window, sink = _window(cfg, i)
        keys = (kc, vc, kv_pos)
        if window is not None and window_keys is not None:
            if slots[i] not in gathered:
                idx, held = window_keys
                gathered[slots[i]] = (kc.index_select(1, idx), vc.index_select(1, idx), held)
            keys = gathered[slots[i]]
        kk, vv, kp = keys
        attn_out = attention(apply_rope(q, pos, cfg.rope_theta), kk.to(hn.dtype), vv.to(hn.dtype),
                             pos, kp, causal=True, window=window, rcfg=ctx.rcfg, sink=sink)
        y = ssm.mamba1_decode(cfg, lp, x, z, {"ssm": main["ssm"][i], "conv": main["conv"][i]})
        h = h + _mix(cfg, lp, attn_out.reshape(b, 1, -1), y)
        fp = lp["ffn"]
        h = h + swiglu(rms_norm(h, lp["ln2"], cfg.norm_eps), fp["wg"], fp["wu"], fp["wd"])
    new_cache = dict(cache)
    new_cache["length"] = t + 1
    return new_cache, unembed(ctx, params, h)
