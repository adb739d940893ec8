"""Plain PyTorch version of the Mamba-1 selective scan: the CPU path of
``selective_scan`` and what the kernel ``csrc/selective_scan.cu`` is held
to, and the decode step that continues it from a cached state.

Per row b, channel c and state n, in float32:

    dt_t  = softplus(dt_raw_t + dt_bias)           (PyTorch's threshold of 20)
    h_t   = exp(dt_t · A) · h_{t-1} + (dt_t · x_t) · B_t      A = -exp(A_log)
    y_t   = (Σ_n h_t · C_t + D · x_t) · silu(z_t)

x, dt, z (B, S, di) and B, C (B, S, N) come in the compute dtype; dt_bias
and D are (di,), A_log (di, N). The JAX package has no Mamba-1 layer, so
this is the port's own reference, written from the Mamba paper
(arXiv:2312.00752, Algorithm 2) as the published Hymba uses it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _coefficients(dt, dt_bias, A_log):
    """float32 dt after its bias and softplus, and A = -exp(A_log)."""
    return F.softplus(dt.float() + dt_bias.float()), -torch.exp(A_log.float())


def selective_scan_ref(
    x: torch.Tensor,  # (B, S, di)
    dt: torch.Tensor,  # (B, S, di) raw, before dt_bias and softplus
    dt_bias: torch.Tensor,  # (di,)
    A_log: torch.Tensor,  # (di, N)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    D: torch.Tensor,  # (di,)
    z: torch.Tensor,  # (B, S, di)
    initial_state: Optional[torch.Tensor] = None,  # (B, di, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, di) in ``x.dtype``, the final state (B, di, N) float32):
    the recurrence taken one position at a time."""
    dt, A = _coefficients(dt, dt_bias, A_log)
    xf, bf, cf = x.float(), Bm.float(), Cm.float()
    b, s, di = x.shape
    h = (torch.zeros((b, di, A.shape[-1]), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        h = h * torch.exp(dt[:, t, :, None] * A) + (dt[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()
    return (y * F.silu(z.float())).to(x.dtype), h


def selective_step_ref(state: torch.Tensor, x, dt, dt_bias, A_log, Bm, Cm, D, z) -> torch.Tensor:
    """One decode step of ``selective_scan_ref`` from the cache ``state``
    (B, di, N), in place: the state widened to float32, stepped, and stored
    back in its dtype (rounded to bf16 in the model's cache). x, dt, z are
    (B, di), B and C (B, N). Returns y (B, di) in ``x.dtype``."""
    y, new = selective_scan_ref(x[:, None], dt[:, None], dt_bias, A_log, Bm[:, None], Cm[:, None],
                                D, z[:, None], state)
    state.copy_(new)
    return y[:, 0]
