"""Plain PyTorch oracle for the SSD chunked-scan kernel: the port of
``repro/models/ssm.py::ssd_chunked`` (which ``repro/kernels/ssd_scan/
ref.py::ssd_ref`` names), with the same padding of the ragged tail,
intra-chunk ``einsum``s and a Python loop over chunks for the inter-chunk
recurrence (the reference's ``lax.scan``).

It is written as the SSD algorithm's three phases (arXiv:2405.21060
§6–7), one plain function each, which the kernel's ``wgmma`` body follows
kernel for kernel: :func:`ssd_chunk_states_ref` (cs and each chunk's end
state from zero), :func:`ssd_state_passing_ref` (the state entering each
chunk, and the final state) and :func:`ssd_chunk_outputs_ref` (y from the
chunk's own terms and the entering state); :func:`ssd_ref` is their
composition."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) zero-padded to whole chunks and cut to (B, NC, chunk, ...)."""
    pad = (-t.shape[1]) % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], t.shape[1] // chunk, chunk, *t.shape[2:])


def ssd_chunk_states_ref(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh)
    A: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1. Returns cs (B, NC, chunk, nh), the inclusive cumsum of
    dt·A within each chunk (the ragged tail padded with dt = 0); each
    chunk's end state from zero, S_c = Σ_j exp(cs_last − cs_j) B_j ⊗
    (dt_j x_j), (B, NC, nh, hd, N) float32; and each chunk's decay
    exp(Σ dt·A), (B, NC, nh)."""
    xq, dtq, Bq = _chunked(x, chunk), _chunked(dt, chunk), _chunked(Bm, chunk).float()
    dA = dtq * A[None, None, None, :]  # (B,nc,Q,nh) <= 0
    cs = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk
    xdt = (xq * dtq[..., None]).float()  # (b,c,q,h,p)
    seg = torch.exp(cs[:, :, -1:, :] - cs)  # (b,c,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bq, seg, xdt)
    return cs, states, torch.exp(dA.sum(dim=2))


def ssd_state_passing_ref(
    states: torch.Tensor,  # (B, NC, nh, hd, N) float32
    chunk_decay: torch.Tensor,  # (B, NC, nh)
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2, sequential over chunks: S_enter(0) = the initial state (or
    0), S_enter(c+1) = chunk_decay(c) S_enter(c) + S_c. Returns the
    entering states (B, NC, nh, hd, N) and the final state (B, nh, hd, N),
    float32."""
    b, nc, nh, hd, n = states.shape
    state = (
        torch.zeros((b, nh, hd, n), dtype=torch.float32, device=states.device)
        if initial_state is None
        else initial_state.float()
    )
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(entering, dim=1), state


def ssd_chunk_outputs_ref(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    cs: torch.Tensor,  # (B, NC, chunk, nh), from ssd_chunk_states_ref
    prev_states: torch.Tensor,  # (B, NC, nh, hd, N), from ssd_state_passing_ref
    chunk: int,
) -> torch.Tensor:
    """Phase 3. y (B, S, nh, hd) in ``x.dtype``: per chunk the intra-chunk
    blocks Y_ij = C_i·B_j exp(cs_i − cs_j) dt_j x_j for j ≤ i (L made by
    selection: exp(cs_i − cs_j) overflows for i < j) plus the inter-chunk
    term C_i · exp(cs_i) · S_enter."""
    b, s, nh, hd = x.shape
    xq, dtq = _chunked(x, chunk), _chunked(dt, chunk)
    Bq, Cq = _chunked(Bm, chunk).float(), _chunked(Cm, chunk).float()
    nc = xq.shape[1]
    att = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])  # (b,c,q,k,h)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.where(mask[None, None, :, :, None], decay, 0.0)
    xdt = (xq * dtq[..., None]).float()  # (b,c,q,h,p)
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", att, L, xdt)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cq, torch.exp(cs), prev_states)
    y = (y_diag + y_off).reshape(b, nc * chunk, nh, hd)[:, :s]
    return y.to(x.dtype)


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
    (B, nh, hd, N) in float32. Every product is taken in float32: the three
    phases in order."""
    cs, states, chunk_decay = ssd_chunk_states_ref(x, dt, A, Bm, chunk)
    prev_states, final = ssd_state_passing_ref(states, chunk_decay, initial_state)
    return ssd_chunk_outputs_ref(x, dt, Bm, Cm, cs, prev_states, chunk), final
