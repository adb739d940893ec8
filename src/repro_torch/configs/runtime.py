"""Runtime (non-architecture) configuration: dtypes, attention blocking
and the kernel switch.

The counterpart of ``repro/configs/runtime.py`` with torch dtypes in
place of ``jnp`` ones. The reference's ``use_pallas`` ("prefill attention
goes through the Pallas TPU kernel") is ``use_kernels`` here: prefill
attention (``Sq > 1``) goes through the hand-written Hopper flash
attention kernel, ``repro_torch.kernels.flash_attention``. Decode
(``Sq == 1``) takes the plain path in both packages. ``moe_impl`` takes
the reference's one-device values, ``"auto"`` and ``"dense"`` (both the
compute-all-experts path: there is no mesh); its expert-parallel values
raise in ``models/moe.py``. ``remat`` is the training path's
rematerialisation policy (``models/transformer.py::forward_train``:
``"none"``, ``"full"`` or ``"dots"``), with the reference's default. The
fields that only the JAX package's sharding paths read (sharding rules,
MoE capacity, decode TP) wait for the multi-device slice (ROADMAP queue 1
item 16).
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
    # rematerialisation of each layer in forward_train: none | full | dots
    remat: str = "full"
    # prefill attention through the hand-written flash attention kernel
    # (the reference's TPU deployment flag ``use_pallas``)
    use_kernels: bool = False
    # MoE FFN: dense | auto (on one device, auto is dense) | expert_parallel[_2d]
    moe_impl: str = "auto"

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]
