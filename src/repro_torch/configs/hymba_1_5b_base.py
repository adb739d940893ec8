"""Hymba-1.5B as published (nvidia/Hymba-1.5B-Base; arXiv:2411.13676):
attention heads and Mamba-1 SSM heads side by side in every layer on one
input projection, 128 learned meta tokens in front of every prompt, a
sliding window of 1,024 in all but three global layers (the meta tokens
visible to every query), and K/V caches shared by consecutive window
layers.

This is not the registry's ``hymba-1.5b``, which mirrors the JAX
package's approximation (Mamba2 SSD heads, a ``sigmoid(mix_gate)`` blend,
an attention ``wo``, globals at {0, n/2, n-1}, no meta tokens, no sharing)
and stays for the tests that hold the port to the JAX package. The JAX
package has no published Hymba, so this entry lives in the registry's
``PORT_ONLY`` table, apart from the mirrored ones (``registry.py``).

The layer (``models/hymba.py``): one input projection to x, z and q, and,
in the first layer of each K/V group, k and v; attention (GQA 25 over 5,
Q and K 64 wide, V 128 wide, RoPE θ 10,000); the Mamba-1 branch (depthwise
conv 4 with bias and SiLU, ``x_proj`` to dt_rank 100 + B 16 + C 16, each
RMS-normed, ``dt_proj`` 100 → 3,200 with ``dt_bias`` and softplus, A =
−exp(A_log) of (3,200, 16), the skip D, the gate SiLU(z)); the two branch
outputs each through its own RMSNorm, averaged, through ``out_proj``
(3,200 → 1,600); then the SwiGLU FFN.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig, SSMConfig


@dataclasses.dataclass(frozen=True)
class HymbaConfig(ModelConfig):
    """``ModelConfig`` with the published Hymba's own keys (a subclass, so
    that the mirrored configurations keep the JAX package's fields)."""

    v_head_dim: int = 128  # V and the attention output per head; Q and K are head_dim
    n_meta_tokens: int = 0  # learned embeddings at positions 0 .. n - 1 before every prompt
    global_layers: Tuple[int, ...] = ()  # layers of full attention; the rest slide the window
    # groups of consecutive layers that share one K/V cache; the first layer
    # of a group projects K and V, the others read them. A layer in no group
    # has a cache of its own.
    kv_groups: Tuple[Tuple[int, ...], ...] = ()
    dt_rank: int = 0  # Mamba-1's dt projection rank

    def kv_owner(self, layer: int) -> int:
        """The layer whose K and V ``layer`` attends over."""
        for g in self.kv_groups:
            if layer in g:
                return g[0]
        return layer

    def kv_slots(self) -> Tuple[int, ...]:
        """Per layer, the index of its K/V cache among the distinct ones."""
        owners = sorted({self.kv_owner(i) for i in range(self.n_layers)})
        return tuple(owners.index(self.kv_owner(i)) for i in range(self.n_layers))

    @property
    def n_kv_caches(self) -> int:
        return len(set(self.kv_slots()))


_GROUPS = tuple((i, i + 1) for i in range(1, 15, 2)) + ((16, 17, 18),) + tuple(
    (i, i + 1) for i in range(19, 31, 2))

CONFIG = HymbaConfig(
    name="hymba-1.5b-base",
    arch_type="hymba",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    head_dim=64,
    v_head_dim=128,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    kv_groups=_GROUPS,
    n_meta_tokens=128,
    dt_rank=100,
    ssm=SSMConfig(d_state=16, expand=2, d_conv=4),
    rope_theta=10_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
    source="arXiv:2411.13676; hf nvidia/Hymba-1.5B-Base: 32L d1600 25H kv5 qk64 v128 ff5504 "
           "v32001 mamba-1 N16 dt_rank100, 128 meta tokens, SWA 1024, 17 K/V caches",
)
