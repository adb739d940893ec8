"""Mamba2 block via SSD (state-space duality), per arXiv:2405.21060 (the
counterpart of ``repro/models/ssm.py``).

Prefill uses the chunked dual form: intra-chunk attention-like (C Bᵀ ⊙ L)
products and an inter-chunk state recurrence, either through the
hand-written Hopper kernel (``rcfg.use_kernels``, the reference's
``use_pallas``) or its plain version ``kernels/ssd_scan/ref.py::ssd_ref``.
Decode is the pure recurrent step, with no kernel, as in the reference.

Dtypes follow the reference: x, B and C leave the convolution in the
compute dtype, dt and A are float32, the state and every product of the
scan are float32, and ``norm_w``, ``dt_bias`` and ``A_log`` are read in
float32 whatever the compute dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models.layers import ParamSpec, rms_norm


def ssm_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    """Stacked (leading ``layers`` axis) Mamba2 params."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.inner(d)
    nh = s.n_ssm_heads(d)
    conv_dim = di + 2 * s.d_state
    L = (n_layers,)
    lx = ("layers",)
    return {
        # z (gate), x, B, C, dt
        "in_proj": ParamSpec(
            L + (d, 2 * di + 2 * s.d_state + nh), lx + ("embed", "ssm_inner")
        ),
        "conv_w": ParamSpec(L + (s.d_conv, conv_dim), lx + (None, "ssm_inner")),
        "conv_b": ParamSpec(L + (conv_dim,), lx + ("ssm_inner",), init="zeros"),
        "dt_bias": ParamSpec(L + (nh,), lx + ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec(L + (nh,), lx + ("ssm_heads",), init="ones"),
        "D": ParamSpec(L + (nh,), lx + ("ssm_heads",), init="ones"),
        "norm_w": ParamSpec(L + (di,), lx + ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec(L + (di, d), lx + ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """The in-projection's (z, x, B, C, dt) as views, plus d_inner and the
    head count. x, B and C are adjacent, so ``xbc`` is their one view."""
    s = cfg.ssm
    di = s.inner(cfg.d_model)
    nh = s.n_ssm_heads(cfg.d_model)
    z, xi, Bm, Cm, dt = proj.split([di, di, s.d_state, s.d_state, nh], dim=-1)
    return z, xi, Bm, Cm, dt, di, nh


def _xbc(cfg: ModelConfig, proj: torch.Tensor) -> torch.Tensor:
    """concat(x, B, C) of the in-projection: one view, no copy."""
    di = cfg.ssm.inner(cfg.d_model)
    return proj[..., di : 2 * di + 2 * cfg.ssm.d_state]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: (B,S,C), w: (K,C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + xbc.shape[1], :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b[None, None, :])


def conv_tail(cfg: ModelConfig, proj: torch.Tensor) -> torch.Tensor:
    """Last (d_conv - 1) pre-activation conv inputs — the decode conv state,
    in bfloat16, front-padded with zeros for prompts shorter than that.
    Sliced from the in-projection that ``mamba2_prefill`` already made, the
    same product the reference's ``_conv_tail`` recomputes."""
    k = cfg.ssm.d_conv - 1
    tail = _xbc(cfg, proj)[:, -k:, :]
    pad = k - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return tail.to(torch.bfloat16)


def mamba2_prefill(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B,S,d)
    rcfg: RunConfig,
    initial_state=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block. Returns (out (B,S,d), final state
    (B,nh,hd,N) float32, the in-projection (B,S,·) for ``conv_tail``)."""
    s = cfg.ssm
    proj = x @ p["in_proj"].to(x.dtype)
    z, _, _, _, dt, di, nh = _split_proj(cfg, proj)
    xbc = _causal_conv(_xbc(cfg, proj), p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xi, Bm, Cm = xbc.split([di, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(*xi.shape[:2], nh, s.headdim)  # a strided view of xbc
    if rcfg.use_kernels:
        y, state = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=s.chunk_size,
                               initial_state=initial_state)
    else:
        y, state = ssd_ref(xh, dt, A, Bm, Cm, s.chunk_size, initial_state)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:2], di)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, state, proj


def mamba2_forward(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B,S,d)
    rcfg: RunConfig,
    initial_state=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block. Returns (out (B,S,d), final_state)."""
    out, state, _ = mamba2_prefill(cfg, p, x, rcfg, initial_state)
    return out, state


def mamba2_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B,1,d)
    ssm_state: torch.Tensor,  # (B,nh,hd,N)
    conv_state: torch.Tensor,  # (B,d_conv-1,conv_dim)
):
    """Single recurrent step. Returns (out (B,1,d), new_ssm, new_conv)."""
    s = cfg.ssm
    proj = x @ p["in_proj"].to(x.dtype)
    z, _, _, _, dt, di, nh = _split_proj(cfg, proj)
    window = torch.cat([conv_state, _xbc(cfg, proj)], dim=1)  # (B,d_conv,conv_dim)
    new_conv = window[:, 1:]
    w = p["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(x.dtype)
    xbc = F.silu(conv_out)[:, None, :]
    xi, Bm, Cm = xbc.split([di, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(x.shape[0], nh, s.headdim)  # (B,nh,hd)
    dt1 = dt[:, 0]  # (B,nh)
    dA = torch.exp(dt1 * A[None, :])  # (B,nh)
    dBx = torch.einsum("bn,bh,bhp->bhpn", Bm[:, 0].float(), dt1, xh.float())
    new_state = ssm_state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), new_state)
    y = y.to(x.dtype) + xh * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(x.shape[0], 1, di)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, new_state.to(ssm_state.dtype), new_conv
