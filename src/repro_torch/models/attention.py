"""Attention: GQA/MHA with causal + sliding-window masking (the
counterpart of ``repro/models/attention.py``).

Three execution paths, in the reference's dispatch order:
  * kernel  — ``RunConfig.use_kernels`` and Sq > 1 (prefill): the
              hand-written Hopper flash attention kernel
              (``repro_torch.kernels.flash_attention``; its plain version
              on CPU tensors);
  * blocked — online softmax over (block_q × block_k) tiles, for long
              sequences, so the S×S score matrix never materialises;
  * direct  — one einsum, for short KV (decode steps, smoke tests).
The reference's ``_blocked_swa`` (static KV slicing for sliding-window
prefill) waits for a sliding-window model (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.runtime import RunConfig
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """q_pos: (..., Sq), kv_pos: (..., Skv) -> bool (..., Sq, Skv)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = kp >= 0  # negative kv positions mark invalid (unwritten ring slots)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & ((qp - kp) < window)
    return m


def _direct(q, k, v, q_pos, kv_pos, causal, window, scale):
    # The reference multiplies bf16 operands with float32 accumulation
    # (preferred_element_type); widening the operands to float32 computes
    # the same products.
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    m = _mask(q_pos, kv_pos, causal, window)  # (B,Sq,Skv)
    scores = torch.where(m[:, None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _blocked(q, k, v, q_pos, kv_pos, causal, window, scale, bq, bk):
    """Online-softmax attention over q/kv tiles (flash-style, plain torch)."""
    b, sq, hkv, g, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    bq = min(bq, sq)
    bk = min(bk, skv)
    pq, pk = (-sq) % bq, (-skv) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=0)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        kv_pos = F.pad(kv_pos, (0, pk), value=-1)
    nq, nk = (sq + pq) // bq, (skv + pk) // bk
    blocks = []
    for i in range(nq):
        qi = q[:, i * bq:(i + 1) * bq].float()  # (B,bq,Hkv,G,D)
        qpi = q_pos[:, i * bq:(i + 1) * bq]
        acc = torch.zeros((b, hkv, g, bq, dv), dtype=torch.float32, device=q.device)
        mx = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32, device=q.device)
        dn = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=q.device)
        for j in range(nk):
            ki = k[:, j * bk:(j + 1) * bk].float()
            vi = v[:, j * bk:(j + 1) * bk].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
            m = _mask(qpi, kv_pos[:, j * bk:(j + 1) * bk], causal, window)
            s = torch.where(m[:, None, None, :, :], s, NEG_INF)
            mx_new = torch.maximum(mx, s.amax(dim=-1))
            corr = torch.exp(mx - mx_new)
            p = torch.exp(s - mx_new[..., None])
            dn = dn * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vi)
            mx = mx_new
        out = acc / torch.clamp_min(dn, 1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4))  # (B,bq,Hkv,G,Dv)
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
) -> torch.Tensor:
    """Grouped-query attention. Returns (B, Sq, Hq, Dv) in ``v.dtype``."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scale = 1.0 / math.sqrt(d)

    if rcfg.use_kernels and sq > 1:
        out = fa_ops.flash_attention(
            qg, k, v, q_pos, kv_pos, causal=causal, window=window
        )
    elif sq * k.shape[1] > rcfg.attn_blocked_threshold**2:
        if causal and isinstance(window, int) and sq == k.shape[1] and window < sq:
            raise NotImplementedError(
                "sliding-window blocked prefill (_blocked_swa) waits for a "
                "sliding-window model: ROADMAP queue 1 item 13"
            )
        out = _blocked(
            qg, k, v, q_pos, kv_pos, causal, window, scale,
            rcfg.attn_block_q, rcfg.attn_block_k,
        )
    else:
        out = _direct(qg, k, v, q_pos, kv_pos, causal, window, scale)
    return out.reshape(b, sq, hq, v.shape[-1]).to(v.dtype)
