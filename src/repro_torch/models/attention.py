"""Attention: GQA/MHA with causal + sliding-window masking (the
counterpart of ``repro/models/attention.py``).

Three execution paths, in the reference's dispatch order:
  * kernel  — ``RunConfig.use_kernels`` and Sq > 1 (prefill): the
              hand-written Hopper flash attention kernel
              (``repro_torch.kernels.flash_attention``; its plain version
              on CPU tensors);
  * blocked — online softmax over (block_q × block_k) tiles, for long
              sequences, so the S×S score matrix never materialises; a
              sliding-window prefill (``_blocked_swa``) visits only the
              key tiles that cover each query tile's window;
  * direct  — one einsum, for short KV (decode steps, smoke tests).

Under a mesh (DTensor inputs) attention runs on each rank's shard
(``_sharded``): the batch over the data axes, the heads over ``"model"``
where the KV heads divide (else the query heads, each shard taking the KV
heads its query heads read), and a decode cache whose slot axis is
sharded over ``"model"`` by the flash-decode split: each shard scores its
slots, and the softmax's max and sums reduce over ``"model"``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.runtime import RunConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.sharding.specs import is_dtensor

NEG_INF = -1e30


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int], sink: int = 0) -> torch.Tensor:
    """q_pos: (..., Sq), kv_pos: (..., Skv) -> bool (..., Sq, Skv). With a
    window, keys at positions below ``sink`` are never hidden by it."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = kp >= 0  # negative kv positions mark invalid (unwritten ring slots)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (((qp - kp) < window) | (kp < sink))
    return m


def _direct(q, k, v, q_pos, kv_pos, causal, window, scale, sink=0):
    # The reference multiplies bf16 operands with float32 accumulation
    # (preferred_element_type); widening the operands to float32 computes
    # the same products.
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    m = _mask(q_pos, kv_pos, causal, window, sink)  # (B,Sq,Skv)
    scores = torch.where(m[:, None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _pad_to_tiles(q, k, v, q_pos, kv_pos, bq, bk):
    """Pad the query axis to a multiple of ``bq`` (position 0) and the KV
    axis to one of ``bk`` (position -1, masked out)."""
    pq, pk = (-q.shape[1]) % bq, (-k.shape[1]) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=0)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        kv_pos = F.pad(kv_pos, (0, pk), value=-1)
    return q, k, v, q_pos, kv_pos


def _online_softmax(qi, qpi, k, v, kv_pos, tiles, bk, causal, window, scale, sink=0):
    """One query tile qi (B,bq,Hkv,G,D) against the key tiles ``tiles`` of
    (padded) k/v, by online softmax in float32; returns (B,bq,Hkv,G,Dv)."""
    b, bq, hkv, g, _ = qi.shape
    qi = qi.float()
    acc = torch.zeros((b, hkv, g, bq, v.shape[-1]), dtype=torch.float32, device=qi.device)
    mx = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32, device=qi.device)
    dn = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=qi.device)
    for j in tiles:
        ki = k[:, j * bk:(j + 1) * bk].float()
        vi = v[:, j * bk:(j + 1) * bk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
        m = _mask(qpi, kv_pos[:, j * bk:(j + 1) * bk], causal, window, sink)
        s = torch.where(m[:, None, None, :, :], s, NEG_INF)
        mx_new = torch.maximum(mx, s.amax(dim=-1))
        corr = torch.exp(mx - mx_new)
        p = torch.exp(s - mx_new[..., None])
        dn = dn * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
        mx = mx_new
    out = acc / torch.clamp_min(dn, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def _blocked(q, k, v, q_pos, kv_pos, causal, window, scale, bq, bk, sink=0):
    """Online-softmax attention over q/kv tiles (flash-style, plain torch)."""
    sq, skv = q.shape[1], k.shape[1]
    bq, bk = min(bq, sq), min(bk, skv)
    q, k, v, q_pos, kv_pos = _pad_to_tiles(q, k, v, q_pos, kv_pos, bq, bk)
    nq, nk = q.shape[1] // bq, k.shape[1] // bk
    out = torch.cat([
        _online_softmax(q[:, i * bq:(i + 1) * bq], q_pos[:, i * bq:(i + 1) * bq], k, v, kv_pos,
                        range(nk), bk, causal, window, scale, sink)
        for i in range(nq)
    ], dim=1)
    return out[:, :sq].to(v.dtype)


def _blocked_swa(q, k, v, q_pos, kv_pos, window, scale, bq, bk):
    """Sliding-window causal attention over the key tiles each query tile
    can see: for a window W and contiguous positions (prefill), query tile
    i visits the min(⌊(W + bq) / bk⌋ + 2, nk) key tiles from
    clip(⌊(i·bq − W) / bk⌋, 0, nk − span), O(S·W) work in place of a masked
    O(S²) grid, as the reference's ``_blocked_swa``."""
    sq, skv = q.shape[1], k.shape[1]
    bq, bk = min(bq, sq), min(bk, skv)
    q, k, v, q_pos, kv_pos = _pad_to_tiles(q, k, v, q_pos, kv_pos, bq, bk)
    nq, nk = q.shape[1] // bq, k.shape[1] // bk
    nspan = min((window + bq) // bk + 2, nk)
    blocks = []
    for i in range(nq):
        start = min(max((i * bq - window) // bk, 0), nk - nspan)
        blocks.append(_online_softmax(
            q[:, i * bq:(i + 1) * bq], q_pos[:, i * bq:(i + 1) * bq], k, v, kv_pos,
            range(start, start + nspan), bk, True, window, scale))
    out = torch.cat(blocks, dim=1)
    return out[:, :sq].to(v.dtype)


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    q_pos: torch.Tensor,  # (B, Sq) int
    kv_pos: torch.Tensor,  # (B, Skv) int (negative = invalid slot)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rcfg: RunConfig = RunConfig(),
    sink: int = 0,
) -> torch.Tensor:
    """Grouped-query attention. Returns (B, Sq, Hq, Dv) in ``v.dtype``.
    With a window, keys at positions below ``sink`` stay visible to every
    query (the published Hymba's meta tokens); the window's tile skipping
    (``_blocked_swa``) is then not taken."""
    if is_dtensor(q):
        if sink:
            raise ValueError("attention with a sink runs on one device")
        return _sharded(q, k, v, q_pos, kv_pos, causal, window, rcfg)
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scale = 1.0 / math.sqrt(d)

    if rcfg.use_kernels and sq > 1:
        out = fa_ops.flash_attention(
            qg, k, v, q_pos, kv_pos, causal=causal, window=window, sink=sink
        )
    elif sq * k.shape[1] > rcfg.attn_blocked_threshold**2:
        if causal and isinstance(window, int) and sq == k.shape[1] and window < sq and not sink:
            out = _blocked_swa(
                qg, k, v, q_pos, kv_pos, window, scale,
                rcfg.attn_block_q, rcfg.attn_block_k,
            )
        else:
            out = _blocked(
                qg, k, v, q_pos, kv_pos, causal, window, scale,
                rcfg.attn_block_q, rcfg.attn_block_k, sink,
            )
    else:
        out = _direct(qg, k, v, q_pos, kv_pos, causal, window, scale, sink)
    return out.reshape(b, sq, hq, v.shape[-1]).to(v.dtype)


def _split_softmax(q, k, v, q_pos, kv_pos, causal, window, group, scale=None) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, Hq, D) over this shard's slots of k/v
    (B, W_loc, Hkv, D), the softmax's max and sums reduced over ``group``
    (the flash-decode split; no reduction where ``group`` is None). Returns
    (B, Sq, Hq, Dv) in ``v.dtype``."""
    from torch.distributed import _functional_collectives as fc

    def reduce(t, op):
        return t if group is None else fc.wait_tensor(fc.all_reduce(t, op, group))

    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    m = _mask(q_pos, kv_pos, causal, window)
    scores = torch.where(m[:, None, None, :, :], scores, NEG_INF)
    mx = reduce(scores.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(scores - mx)
    dn = reduce(p.sum(dim=-1), "sum")
    acc = reduce(torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()), "sum")
    out = (acc / torch.clamp_min(dn, 1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, hq, v.shape[-1]).to(v.dtype)


def _sharded(q, k, v, q_pos, kv_pos, causal, window, rcfg) -> torch.Tensor:
    """``attention`` over DTensors, on each rank's shard (module note)."""
    from repro_torch.launch.hlo_analysis import memoized
    from repro_torch.sharding.specs import (
        Spec, batch_split, from_local, is_sharded_on, mesh_shape, to_local)

    mesh = q.device_mesh
    b, _, hq, _ = q.shape
    hkv = k.shape[2]
    bs = batch_split(mesh, b)
    n_model = mesh_shape(mesh).get("model", 1)
    if is_sharded_on(k, 1, "model"):  # a decode cache split over its slots
        out = _split_softmax(
            to_local(mesh, q, Spec(bs, None, None, None)),
            to_local(mesh, k, Spec(bs, "model", None, None)),
            to_local(mesh, v, Spec(bs, "model", None, None)),
            to_local(mesh, q_pos, Spec(bs, None)), to_local(mesh, kv_pos, Spec(bs, "model")),
            causal, window, mesh.get_group("model"))
        return from_local(mesh, out, Spec(bs, None, None, None), q)
    kv_heads = "model" if hkv % n_model == 0 else None
    q_heads = "model" if hq % n_model == 0 else None
    ql = to_local(mesh, q, Spec(bs, None, q_heads, None))
    kl = to_local(mesh, k, Spec(bs, None, kv_heads, None))
    vl = to_local(mesh, v, Spec(bs, None, kv_heads, None))
    if q_heads and not kv_heads:  # the KV heads this shard's query heads read
        hl = hq // n_model
        first = mesh.get_local_rank("model") * hl
        idx = (first + torch.arange(hl, device=kl.device)) // (hq // hkv)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    args = (ql, kl, vl, to_local(mesh, q_pos, Spec(bs, None)), to_local(mesh, kv_pos, Spec(bs, None)))
    key = ("attention", tuple((tuple(t.shape), t.dtype, t.stride()) for t in args), causal, window,
           rcfg.use_kernels, rcfg.attn_block_q, rcfg.attn_block_k, rcfg.attn_blocked_threshold)
    out = memoized(key, lambda *a: attention(*a, causal=causal, window=window, rcfg=rcfg), *args)
    return from_local(mesh, out, Spec(bs, None, q_heads, None), q)
