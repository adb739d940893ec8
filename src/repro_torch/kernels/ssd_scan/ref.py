"""Plain PyTorch oracle for the SSD chunked-scan kernel: the port of
``repro/models/ssm.py::ssd_chunked`` (which ``repro/kernels/ssd_scan/
ref.py::ssd_ref`` names), with the same padding of the ragged tail,
intra-chunk ``einsum``s and a Python loop over chunks for the inter-chunk
recurrence (the reference's ``lax.scan``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_ref(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh) — post-softplus
    A: torch.Tensor,  # (nh,) negative
    Bm: torch.Tensor,  # (B, S, N)  (ngroups=1)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns y (B, S, nh, hd) in ``x.dtype`` and the final state
    (B, nh, hd, N) in float32. Every product is taken in float32."""
    b, s, nh, hd = x.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xq = x.reshape(b, nc, chunk, nh, hd)
    dtq = dt.reshape(b, nc, chunk, nh)
    Bq = Bm.reshape(b, nc, chunk, n).float()
    Cq = Cm.reshape(b, nc, chunk, n).float()

    dA = dtq * A[None, None, None, :]  # (B,nc,Q,nh) <= 0
    cs = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk

    # intra-chunk (diagonal) blocks: Y_ij = C_i·B_j exp(cs_i - cs_j) dt_j x_j.
    # L is made by selection: exp(cs_i - cs_j) overflows for i < j.
    att = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # (b,c,q,k,h)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], decay, 0.0)
    xdt = (xq * dtq[..., None]).float()  # (b,c,q,h,p)
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", att, L, xdt)

    # chunk end-states: S_c = sum_j exp(cs_last - cs_j) B_j ⊗ (dt_j x_j)
    seg = torch.exp(cs[:, :, -1:, :] - cs)  # (b,c,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bq, seg, xdt)

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA.sum(dim=2))  # (b,c,h)
    state = (
        torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
        if initial_state is None
        else initial_state.float()
    )
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (b,c,h,p,n)

    # inter-chunk contribution: C_i · exp(cs_i) · S_prev
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cq, torch.exp(cs), prev_states)

    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hd)[:, :s]
    return y.to(x.dtype), state
