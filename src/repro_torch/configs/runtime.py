"""Runtime (non-architecture) configuration: dtypes, attention blocking
and the kernel switch.

The counterpart of ``repro/configs/runtime.py`` with torch dtypes in
place of ``jnp`` ones. The reference's ``use_pallas`` ("prefill attention
goes through the Pallas TPU kernel") is ``use_kernels`` here: prefill
attention (``Sq > 1``) goes through the hand-written Hopper flash
attention kernel, ``repro_torch.kernels.flash_attention``. Decode
(``Sq == 1``) takes the plain path in both packages. Fields that only the
JAX package's training, sharding and MoE paths read (remat, sharding
rules, MoE capacity, decode TP) wait for the slices that port them.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # tile sizes of the plain blocked (online-softmax) attention path
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    # use the blocked path above this many (query × KV) positions
    attn_blocked_threshold: int = 2048
    # prefill attention through the hand-written flash attention kernel
    # (the reference's TPU deployment flag ``use_pallas``)
    use_kernels: bool = False

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]
