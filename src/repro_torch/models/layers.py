"""Parameter specs + elementary layers (the dense decoder's subset of
``repro/models/layers.py``).

Every model declares a tree (nested dicts) of ``ParamSpec`` — shape,
logical axes, init — and ``init_params`` draws real parameters from it
with an explicit ``torch.Generator``. ``torch.Generator`` and
``jax.random`` give different numbers from one seed, so parity with the
JAX package goes through ``repro_torch.models.convert.params_from_jax``.
``layer_norm``, ``gelu_mlp``, M-RoPE and sinusoidal positions wait for
the models that use them (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Any


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
    ``generator``: normal(0, scale / sqrt(fan_in)), zeros or ones."""
    device = generator.device if device is None else torch.device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        std = s.scale / np.sqrt(fan_in)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * std).to(dtype)

    return tree_map_specs(one, specs)


# ---------------------------------------------------------------------------
# Elementary ops (pure functions over tensors)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm computed in float32, returned in ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def swiglu(
    x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor
) -> torch.Tensor:
    """Gated SiLU MLP in ``x.dtype``."""
    g = x @ wg.to(x.dtype)
    u = x @ wu.to(x.dtype)
    return (F.silu(g) * u) @ wd.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
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
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
