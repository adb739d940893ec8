"""Parameter specs + elementary layers (the counterpart of
``repro/models/layers.py``).

Every model declares a tree (nested dicts) of ``ParamSpec`` — shape,
logical axes, init — and ``init_params`` draws real parameters from it
with an explicit ``torch.Generator``. ``torch.Generator`` and
``jax.random`` give different numbers from one seed, so parity with the
JAX package goes through ``repro_torch.models.convert.params_from_jax``.
A leaf of more than ``WHOLE_DRAW_MAX`` elements is drawn slice by slice
along its leading axis, each slice in float32 and cast straight into the
leaf's dtype: Moonlight-16B-A3B's expert weights, (47, 64, 2048, 1408),
would take 34.7 GB in float32 drawn whole. That changes the numbers of
those leaves only: no leaf of the other served models (Qwen2.5-3B,
Mamba2-2.7B, Hymba-1.5B; the 2-layer DeepSeek-V2) is that large, so
their draws are what they were, and no CPU test depends on a draw.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.specs import settle

Tree = Any
WHOLE_DRAW_MAX = 1 << 31  # elements (8 GiB in float32) a leaf may have to be drawn whole


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier (normal: scale / sqrt(fan_in))

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_map_specs(fn: Callable[[ParamSpec], Any], specs: Tree) -> Tree:
    """Apply ``fn`` to every ``ParamSpec`` leaf, keys visited in sorted
    order (the order ``jax.tree`` flattens dicts in)."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: tree_map_specs(fn, specs[k]) for k in sorted(specs)}


def init_params(
    specs: Tree,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tree:
    """Draw parameters for ``specs`` on ``device`` (the generator's) from
    ``generator``: normal(0, scale / sqrt(fan_in)), zeros or ones. A leaf
    larger than ``WHOLE_DRAW_MAX`` is drawn one leading-axis slice at a
    time into a tensor of ``dtype`` (module note)."""
    device = generator.device if device is None else torch.device(device)

    def normal(shape, std) -> torch.Tensor:
        if int(np.prod(shape)) <= WHOLE_DRAW_MAX:
            x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            return (x * std).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], std)
        return out

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        return normal(s.shape, s.scale / np.sqrt(fan_in))

    return tree_map_specs(one, specs)


def abstract_params(specs: Tree, dtype: torch.dtype = torch.float32) -> Tree:
    """Meta tensors of every leaf's shape (the reference's
    ``ShapeDtypeStruct`` tree): no allocation."""
    return tree_map_specs(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def param_axes(specs: Tree) -> Tree:
    return tree_map_specs(lambda s: s.axes, specs)


# ---------------------------------------------------------------------------
# Elementary ops (pure functions over tensors)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm computed in float32, returned in ``x.dtype``."""
    dt = x.dtype
    x = settle(x).float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with bias (Whisper), computed in float32, returned in
    ``x.dtype``."""
    dt = x.dtype
    x = settle(x).float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def swiglu(
    x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor
) -> torch.Tensor:
    """Gated SiLU MLP in ``x.dtype``."""
    g = x @ wg.to(x.dtype)
    u = x @ wu.to(x.dtype)
    return (F.silu(g) * u) @ wd.to(x.dtype)


def gelu_mlp(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """Whisper's MLP in ``x.dtype``: GELU with biases, no gate. The
    reference's ``jax.nn.gelu`` defaults to the tanh form; ``F.gelu``'s
    default is the exact erf form, so the tanh form is asked for."""
    h = x @ w1.to(x.dtype) + b1.to(x.dtype)
    return F.gelu(h, approximate="tanh") @ w2.to(x.dtype) + b2.to(x.dtype)


def sinusoidal_positions(n: int, d: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position table (n, d), built in
    float64 with numpy as the reference builds it, then cast."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = np.exp(-np.log(10_000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies theta^(-2i/head_dim), float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotate-half RoPE in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * freqs  # (B,S,d/2)
    return _rotate(x, ang)


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, sections: Tuple[int, int, int]
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL). x: (B, S, H, D); positions: (3, B, S)
    int, the temporal, height and width position ids. The D/2 rotary
    frequencies are split into ``sections`` (t, h, w), and each section
    takes its angle from its own position row (the reference's
    ``take_along_axis`` over contiguous sections is this slicing)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not cover the {d // 2} frequencies")
    ang = positions[..., None].float() * rope_freqs(d, theta, x.device)  # (3,B,S,d/2)
    bounds = [0, *itertools.accumulate(sections)]
    ang = torch.cat([ang[i, ..., lo:hi] for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))],
                    dim=-1)  # (B,S,d/2)
    return _rotate(x, ang)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate-half of x (B, S, H, D) by angles (B, S, D/2), in float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
