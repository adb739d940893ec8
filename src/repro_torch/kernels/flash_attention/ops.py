"""Model-side wrapper: the grouped layout (B, S, Hkv, G, D) ⇄ the kernel's
(B, H, S, D), as ``repro/kernels/flash_attention/ops.py``.

Both layouts are views of one another: the kernel reads strided inputs
and writes its output in (B, S, H, Dv) memory order, so no transpose is
copied on the card. Like the reference, ``q_pos`` and ``kv_pos`` are taken
and ignored: the kernel assumes positions contiguous from 0, which holds
for prefill.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bhsd


def flash_attention(
    qg: torch.Tensor,  # (B, Sq, Hkv, G, D) — model-side grouped layout
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    q_pos=None,
    kv_pos=None,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sink: int = 0,
) -> torch.Tensor:
    """Grouped-query flash attention; returns (B, Sq, Hkv, G, Dv). With a
    window, keys [0, sink) stay visible to every query."""
    b, sq, hkv, g, d = qg.shape
    q = qg.reshape(b, sq, hkv * g, d).transpose(1, 2)
    o = flash_attention_bhsd(
        q, k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window, sink=sink
    )
    return o.transpose(1, 2).reshape(b, sq, hkv, g, v.shape[-1])
