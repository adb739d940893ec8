"""Operations the plain references share: RMSNorm, and a matmul in float32
or in the fp8 control (float8 e4m3 weights per output column and inputs
per row, multiplied in float32: W8A8, the step below bfloat16)."""
from __future__ import annotations

import torch


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` in float32 after rounding to float8 e4m3 with one absmax scale
    per slice along ``dim``."""
    t = t.float()
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (T, k) @ w (k, n) in float32, or in the fp8 control."""
    if precision == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, 0)
    if precision != "float32":
        raise ValueError(f"unknown reference precision {precision!r}")
    return x @ w.float()
