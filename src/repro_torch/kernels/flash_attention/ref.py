"""Plain PyTorch oracle for the flash attention kernel (the same function
as ``repro/kernels/flash_attention/ref.py::attention_ref``)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked softmax attention in float32, positions contiguous from 0;
    query head h reads KV head h // (Hq // Hkv). Returns (B, Hq, Sq, Dv)
    in ``v.dtype``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / (d**0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, v.shape[-1]).to(v.dtype)
