"""Runtime (non-architecture) configuration: dtypes, attention blocking
and the kernel switch.

The counterpart of ``repro/configs/runtime.py`` with torch dtypes in
place of ``jnp`` ones. The reference's ``use_pallas`` ("prefill attention
goes through the Pallas TPU kernel") is ``use_kernels`` here: prefill
attention (``Sq > 1``) goes through the hand-written Hopper flash
attention kernel, ``repro_torch.kernels.flash_attention``. Decode
(``Sq == 1``) takes the plain path in both packages. ``moe_impl`` takes
the reference's values: ``"dense"`` (compute all experts),
``"expert_parallel"`` and ``"expert_parallel_2d"`` (experts over the
mesh's ``"model"`` axis; they need a mesh), and ``"auto"``
(expert-parallel where the mesh's ``"model"`` axis has more than one
device and divides the experts, else dense). ``remat`` is the training
path's rematerialisation policy (``models/transformer.py::forward_train``:
``"none"``, ``"full"`` or ``"dots"``), with the reference's default.
``sharding_rules``, ``capacity_factor`` and ``decode_tp_over_data`` are
read only under a mesh (``sharding/specs.py``, ``models/moe.py``,
``launch/dryrun.py``), with the reference's defaults.
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
    # decode cache width of long_500k (the sliding-window variant)
    long_context_window: int = 8192
    # prefill attention through the hand-written flash attention kernel
    # (the reference's TPU deployment flag ``use_pallas``)
    use_kernels: bool = False
    # sharding rule set name (see repro_torch.sharding.specs)
    sharding_rules: str = "megatron_fsdp"
    # MoE FFN: dense | expert_parallel | expert_parallel_2d | auto
    moe_impl: str = "auto"
    capacity_factor: float = 1.25
    # decode-time tensor-parallel mode: replicate the (small) activations
    # over the data axes and let the embed-dim contraction reduce with an
    # activation all-reduce, instead of fsdp-gathering the weights every step
    decode_tp_over_data: bool = False

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]
