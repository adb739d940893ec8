"""Plain PyTorch version of Mamba2's decode state step: the CPU path of
``ssm_decode`` and what the kernel ``csrc/ssm_decode.cu`` is held to.

These are the port's Mamba2 decode lines (``models/ssm.py::mamba2_decode``,
the counterpart of the JAX package's plain ``jnp`` step), with the product
``dt · x · B`` written as one grouping, (B · dt) · x: the order in which
``torch.einsum("bn,bh,bhp->bhpn")`` multiplied it left to right, and the
one the kernel follows.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ssm_step_ref(
    state: torch.Tensor,  # (B, nh, hd, N) float32
    x: torch.Tensor,  # (B, nh, hd), compute dtype
    dt: torch.Tensor,  # (B, nh) raw, before dt_bias and softplus
    dt_bias: torch.Tensor,  # (nh,)
    A_log: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, N), compute dtype
    Cm: torch.Tensor,  # (B, N), compute dtype
    D: torch.Tensor,  # (nh,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step from a float32 state: (y (B, nh, hd) in
    ``x.dtype``, the new state (B, nh, hd, N) float32)."""
    dt = F.softplus(dt.float() + dt_bias[None, :])
    A = -torch.exp(A_log.float())
    dA = torch.exp(dt * A[None, :])  # (B,nh)
    dB = Bm.float()[:, None, :] * dt[:, :, None]  # (B,nh,N)
    dBx = dB[:, :, None, :] * x.float()[..., None]  # (B,nh,hd,N)
    new_state = state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), new_state)
    y = y.to(x.dtype) + x * D.to(x.dtype)[None, :, None]
    return y, new_state


def ssm_decode_ref(state: torch.Tensor, x, dt, dt_bias, A_log, Bm, Cm, D) -> torch.Tensor:
    """:func:`ssm_step_ref` on the cache ``state``, in place: the state
    widened to float32, stepped, and stored back in its dtype (rounded to
    bf16 in the model's cache, the ``copy_`` the model made). Returns y."""
    y, new_state = ssm_step_ref(state.float(), x, dt, dt_bias, A_log, Bm, Cm, D)
    state.copy_(new_state)
    return y
