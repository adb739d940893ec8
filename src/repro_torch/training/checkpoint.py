"""Flat-file checkpointing, npz + JSON manifest (the counterpart of
``repro/training/checkpoint.py``), in the reference's layout:
``params.npz``, ``opt_state.npz`` and ``manifest.json`` (``{"step",
"meta"}``) in one directory, each array under its tree path joined by
``"/"`` (``layers/attn/wq``, ``m/layers/attn/wq``, ``step``). So a
checkpoint that the JAX package writes restores here, and the reverse,
in float32.

numpy has no bfloat16, so a bfloat16 leaf is stored widened to float32
and narrowed back on restore into a bfloat16 template: both conversions
are exact. (The JAX package stores it as ``ml_dtypes``' bfloat16, which
this module does not read.)
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.training.adamw import flatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, params, opt_state=None, step: int = 0, meta: dict | None = None):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **{k: _to_numpy(v) for k, v in flatten(params).items()})
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"),
                 **{k: _to_numpy(v) for k, v in flatten(opt_state).items()})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "meta": meta or {}}, f, indent=2)


def _unflatten(npz, template, prefix: str = ""):
    if not isinstance(template, dict):
        arr = npz[prefix]
        if arr.shape != tuple(template.shape):
            raise ValueError(f"{prefix}: checkpoint shape {arr.shape}, "
                             f"template {tuple(template.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=template.device, dtype=template.dtype)
    return {k: _unflatten(npz, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template.items()}


def restore(path: str, params_template, opt_template=None) -> Tuple[Any, Any, int]:
    """Restore into the structure, dtypes and devices of the given
    templates. Returns (params, opt_state or None, step)."""
    with np.load(os.path.join(path, "params.npz")) as npz:
        params = _unflatten(npz, params_template)
    opt = None
    if opt_template is not None:
        with np.load(os.path.join(path, "opt_state.npz")) as npz:
            opt = _unflatten(npz, opt_template)
    with open(os.path.join(path, "manifest.json")) as f:
        step = json.load(f)["step"]
    return params, opt, step
