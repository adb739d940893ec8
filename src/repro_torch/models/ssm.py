"""Mamba2 block via SSD (state-space duality), per arXiv:2405.21060 (the
counterpart of ``repro/models/ssm.py``), and the Mamba-1 heads of the
published Hymba (``mamba1_prefill`` / ``mamba1_decode``, at the end).

Prefill uses the chunked dual form: intra-chunk attention-like (C Bᵀ ⊙ L)
products and an inter-chunk state recurrence, either through the
hand-written Hopper kernel (``rcfg.use_kernels``, the reference's
``use_pallas``) or its plain version ``kernels/ssd_scan/ref.py::ssd_ref``.
Decode is the recurrent step. The reference's is plain ``jnp``; here, with
``rcfg.use_kernels``, its state step is the hand-written kernel
``kernels/ssm_decode`` (one pass over the bf16 cache, in place), and
without, the same plain lines (``kernels/ssm_decode/ref.py``) on the state
widened to float32.

Dtypes follow the reference: x, B and C leave the convolution in the
compute dtype, dt and A are float32, the state and every product of the
scan are float32, and ``norm_w``, ``dt_bias`` and ``A_log`` are read in
float32 whatever the compute dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref, selective_step_ref
from repro_torch.kernels.ssm_decode import ssm_decode, ssm_decode_ref
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.sharding.specs import is_dtensor


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


def _decode_in(cfg: ModelConfig, p: dict, x: torch.Tensor, conv_state: torch.Tensor):
    """A decode step's in-projection and convolution: (z, the heads' x
    (B,nh,hd) as a strided view of the convolution's output, raw dt (B,nh),
    B and C (B,N), the new conv state)."""
    s = cfg.ssm
    proj = x @ p["in_proj"].to(x.dtype)
    z, _, _, _, dt, di, nh = _split_proj(cfg, proj)
    window = torch.cat([conv_state, _xbc(cfg, proj)], dim=1)  # (B,d_conv,conv_dim)
    new_conv = window[:, 1:]
    w = p["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(x.dtype)
    xbc = F.silu(conv_out)[:, None, :]
    xi, Bm, Cm = xbc.split([di, s.d_state, s.d_state], dim=-1)
    xh = xi.reshape(x.shape[0], nh, s.headdim)  # (B,nh,hd)
    return z, xh, dt[:, 0], Bm[:, 0], Cm[:, 0], new_conv


def _decode_out(cfg: ModelConfig, p: dict, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """A decode step's gate, norm and out-projection of y (B,nh,hd)."""
    y = y.reshape(x.shape[0], 1, cfg.ssm.inner(cfg.d_model))
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype)


def _step_args(p: dict, xh, dt, Bm, Cm) -> tuple:
    return (xh, dt, p["dt_bias"], p["A_log"], Bm, Cm, p["D"])


def mamba2_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  rcfg: RunConfig) -> torch.Tensor:
    """Single recurrent step against a layer's cache (``ssm``, ``conv``),
    whose states are overwritten in place; returns out (B,1,d). With
    ``rcfg.use_kernels`` the state step is ``ssm_decode`` (the kernel on the
    card, its plain version on the CPU), else its plain version: the state
    widened to float32, stepped, and stored back in the cache's dtype
    (rounded to bf16 in the model's cache; a float32 cache keeps the
    float32 step, as the reference's ``mamba2_decode`` returns it)."""
    z, xh, dt, Bm, Cm, new_conv = _decode_in(cfg, p, x, cache["conv"].to(x.dtype))
    args = _step_args(p, xh, dt, Bm, Cm)
    if not rcfg.use_kernels:
        y = ssm_decode_ref(cache["ssm"], *args)
    elif is_dtensor(cache["ssm"]):
        y = _sharded_step(cache["ssm"], *args)
    else:
        y = ssm_decode(cache["ssm"], *args)
    cache["conv"].copy_(new_conv)
    return _decode_out(cfg, p, x, y, z)


def _sharded_step(state, xh, dt, dt_bias, A_log, Bm, Cm, D):
    """``ssm_decode`` over DTensors, on each rank's shard: rows and heads
    are independent, so each rank steps the rows and heads of its shard of
    the cache, in place, with x, dt and B, C, dt_bias, A_log, D brought to
    the same split. The cache's placements decide the split (the batch over
    the data axes, the heads over ``"model"``: ``sharding.specs``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = state.device_mesh
    split = state.placements
    if any(pl not in (Replicate(), Shard(0), Shard(1)) for pl in split):
        raise ValueError(f"the SSM cache splits only its rows and heads, got {split}")
    heads = [Shard(0) if pl == Shard(1) else Replicate() for pl in split]
    rows = [pl if pl == Shard(0) else Replicate() for pl in split]

    def local(t, placements):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements).to_local()

    y = ssm_decode(state.to_local(), local(xh, split), local(dt, split), local(dt_bias, heads),
                   local(A_log, heads), local(Bm, rows), local(Cm, rows), local(D, heads))
    return DTensor.from_local(y, mesh, split, run_check=False)


# ---------------------------------------------------------------------------
# Mamba-1 (the published Hymba's SSM heads; models/hymba.py)
# ---------------------------------------------------------------------------


def _mamba1_coeffs(cfg: ModelConfig, p: dict, xc: torch.Tensor):
    """dt (raw, before dt_bias and softplus), B and C from the convolved x:
    ``x_proj`` to dt_rank + N + N, each part RMS-normed (Hymba's inner
    norms), and dt through ``dt_proj``."""
    n = cfg.ssm.d_state
    dt, Bm, Cm = (xc @ p["x_proj"].to(xc.dtype)).split([cfg.dt_rank, n, n], dim=-1)
    dt = rms_norm(dt, p["dt_norm"], cfg.norm_eps)
    Bm = rms_norm(Bm, p["B_norm"], cfg.norm_eps)
    Cm = rms_norm(Cm, p["C_norm"], cfg.norm_eps)
    return dt @ p["dt_proj"].to(xc.dtype), Bm, Cm


def mamba1_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, z: torch.Tensor,
                   rcfg: RunConfig, state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Mamba-1 branch over the whole sequence: x and the gate z (B, S,
    di) from the layer's input projection; returns y (B, S, di) gated by
    SiLU(z). The final state is written over ``state`` (the layer's
    (B, di, N) slice of the bf16 cache) where one is given. With
    ``rcfg.use_kernels`` the scan is ``selective_scan`` (the kernel on the
    card), else its plain version."""
    xc = _causal_conv(x, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    dt, Bm, Cm = _mamba1_coeffs(cfg, p, xc)
    args = (xc, dt, p["dt_bias"], p["A_log"], Bm, Cm, p["D"], z)
    if rcfg.use_kernels:
        return selective_scan(*args, state)
    y, final = selective_scan_ref(*args)
    if state is not None:
        state.copy_(final)
    return y


def mamba1_conv_tail(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The last (d_conv - 1) conv inputs of x (B, S, di), front-padded with
    zeros for a sequence shorter than that: the decode conv state (the
    cache's ``copy_`` rounds it to the cache's dtype)."""
    k = cfg.ssm.d_conv - 1
    tail = x[:, -k:, :]
    if tail.shape[1] < k:
        tail = F.pad(tail, (0, 0, k - tail.shape[1], 0))
    return tail


def mamba1_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, z: torch.Tensor,
                  cache: dict) -> torch.Tensor:
    """One token of the Mamba-1 branch against a layer's cache (``ssm``
    (B, di, N), ``conv`` (B, d_conv - 1, di)), both overwritten in place:
    x and z are (B, 1, di); returns y (B, 1, di). Plain torch operations
    (``selective_step_ref``), captured with the rest of the step."""
    window = torch.cat([cache["conv"].to(x.dtype), x], dim=1)  # (B, d_conv, di)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(x.dtype)) + p["conv_b"].to(x.dtype)
    xc = F.silu(conv)
    dt, Bm, Cm = _mamba1_coeffs(cfg, p, xc)
    y = selective_step_ref(cache["ssm"], xc, dt, p["dt_bias"], p["A_log"], Bm, Cm, p["D"], z[:, 0])
    cache["conv"].copy_(window[:, 1:])
    return y[:, None]
