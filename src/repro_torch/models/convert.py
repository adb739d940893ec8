"""Carry the JAX package's parameters over to this port.

The JAX model and this one share one parameter tree (nested dicts,
per-layer tensors with a leading ``layers`` axis), so the conversion is a
leaf-by-leaf copy. ``jax.random`` and ``torch.Generator`` give different
numbers from one seed, so the parity tests build both models on the same
numbers through this function. It takes numpy arrays (the caller turns
the JAX tree into numpy), so this module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(
    np_tree: Mapping[str, Any], device="cuda", dtype: torch.dtype = torch.float32
) -> dict:
    """Nested dict of numpy arrays -> the same tree of ``dtype`` tensors on
    ``device``. bfloat16 arrays (numpy's ``ml_dtypes`` extension type) are
    widened to float32 on the way, exactly."""

    def one(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return {
        k: params_from_jax(v, device, dtype) if isinstance(v, Mapping) else one(v)
        for k, v in np_tree.items()
    }
