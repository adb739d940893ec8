"""Distance covariance / distance correlation (paper Eq. 1-4), in PyTorch.

Székely & Rizzo (2009), "Brownian Distance Covariance". Given n paired
observations of a metric m and a hardware setting s:

    a_ij = ||m_i - m_j||,  b_ij = ||s_i - s_j||              (Eq. 1)
    A_ij = a_ij - ā_i. - ā_.j + ā_..   (double centering)    (Eq. 2)
    dCov²(m,s) = (1/n²) Σ_ij A_ij B_ij                        (Eq. 3)
    dCor(m,s)  = dCov(m,s) / sqrt(dCov(m,m)·dCov(s,s))        (Eq. 4)

The port of ``repro.core.dcov``. The CORAL loop reaches dCor through one
function, :func:`dcor_all_cols`, which takes one (W, C) window or a batch
of B windows (B, W, C) with a per-episode ``n_valid``: the scalar spec
(``core/coral.py``, B = 1) and the batched engine (``core/episode.py``)
share it, and on a CUDA tensor it runs the Hopper dcov kernel
(``kernels/dcov``), one launch per call. Its result for an episode does
not depend on B, on the card or on the CPU (see ``kernels/dcov/ref.py``),
which keeps the two engines' decisions identical. ORACLE-scale samples
(thousands of rows, every row valid) go through
``kernels.dcov.dcor_all_blocked``.

The reference's fleet engine keeps the window's dCor sums incrementally
instead (``dcor_state_init``, ``dcor_state_from_window``,
``dcor_state_push``, ``dcor_state_corr``: O(W·C²) per pushed row). They
are ported below, with a leading batch axis, and held to the reference in
the tests, but the port's engine does not call them: its fleet step takes
the window from the history block and reaches dCor through
:func:`dcor_all_cols` like every other step kind. Rebuilding the window
each step was checked against the incremental sums in the JAX package
itself: all 1024 cold row traces of the fleet at ``BENCH_fleet.json``'s
settings, and its whole results block (warm cohort included), come out
the same. So the port keeps one dCor route, one dcov launch per fleet
step, and no (B, W, W, C) ring state.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dcov import dcov_gram_windows
from repro_torch.kernels.dcov.ref import dcor_from_sums

__all__ = [
    "centered_distance_stack",
    "dcor",
    "dcor_all",
    "dcor_all_cols",
    "dcor_from_sums",
    "dcor_state_corr",
    "dcor_state_from_window",
    "dcor_state_init",
    "dcor_state_push",
    "dcov2",
]


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """x: (n,) or (n, d) -> (n, n) euclidean distance matrix."""
    if x.dim() == 1:
        x = x[:, None]
    diff = (x[:, None, :] - x[None, :, :]).to(torch.float32)
    return torch.sqrt((diff**2).sum(dim=-1) + 0.0)


def _double_center(a: torch.Tensor) -> torch.Tensor:
    row = a.mean(dim=1, keepdim=True)
    col = a.mean(dim=0, keepdim=True)
    return a - row - col + a.mean()


def dcov2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distance covariance (Eq. 3). Non-negative up to fp error."""
    A = _double_center(_pairwise_dist(x))
    B = _double_center(_pairwise_dist(y))
    return (A * B).mean()


def dcor(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Distance correlation (Eq. 4) in [0, 1]; 0 for degenerate inputs."""
    A = _double_center(_pairwise_dist(x))
    B = _double_center(_pairwise_dist(y))
    return dcor_from_sums((A * B).mean(), (A * A).mean(), (B * B).mean(), eps)


def centered_distance_stack(cols: torch.Tensor, n_valid) -> torch.Tensor:
    """Double-centered distance matrices for every column at once.

    cols: (W, C) — C independent 1-d samples stacked column-wise; rows at
          index >= n_valid are padding and are masked out of every mean.
    returns: (W, W, C) stack of A matrices (Eq. 2), zero outside the valid
          n_valid × n_valid block.
    """
    w = cols.shape[0]
    n = torch.as_tensor(n_valid, device=cols.device)
    valid = torch.arange(w, device=cols.device) < n
    mask = (valid[:, None] & valid[None, :]).to(torch.float32)
    x = cols.to(torch.float32)
    d = (x[:, None, :] - x[None, :, :]).abs() * mask[:, :, None]
    inv_n = 1.0 / n.to(torch.float32)
    row = d.sum(dim=1, keepdim=True) * inv_n
    col = d.sum(dim=0, keepdim=True) * inv_n
    grand = d.sum(dim=(0, 1)) * inv_n * inv_n
    return (d - row - col + grand[None, None, :]) * mask[:, :, None]


def dcor_all(settings, metrics, n_valid, device="cuda") -> torch.Tensor:
    """All (setting dim, metric dim) correlation weights in one kernel call.

    settings: (W, D) sliding window of D hardware parameters, zero-padded
              to a fixed W (n_valid rows are real); or (B, W, D).
    metrics:  (W, M) matching window of M performance metrics; or (B, W, M).
    n_valid:  the number of real rows, an int or a (B,) int tensor.
    returns:  (D, M) dCor matrix (or (B, D, M)) on ``device`` — column 0 is
              α (throughput), column 1 is β (power) in the CORAL
              formulation (Eq. 9).
    """
    s = torch.as_tensor(settings, dtype=torch.float32, device=device)
    m = torch.as_tensor(metrics, dtype=torch.float32, device=device)
    return dcor_all_cols(torch.cat([s, m], dim=-1), n_valid, s.shape[-1])


def dcor_all_cols(cols: torch.Tensor, n_valid, d: int) -> torch.Tensor:
    """``dcor_all`` on a pre-stacked column block: (W, D+M) with an int
    ``n_valid``, or (B, W, D+M) with a (B,) ``n_valid``. The episode engine
    stores its observation window in exactly this layout; the scalar spec
    reaches the same block through ``dcor_all``. One Gram per window, from
    one kernel launch on the card; returns (D, M) or (B, D, M)."""
    batched = cols.dim() == 3
    x = (cols if batched else cols[None]).to(torch.float32)
    n = torch.as_tensor(n_valid, dtype=torch.int32, device=x.device).reshape(-1)
    gram = dcov_gram_windows(x, n)
    diag = torch.diagonal(gram, dim1=1, dim2=2)  # (B, C)
    corr = dcor_from_sums(gram[:, :d, d:], diag[:, :d, None], diag[:, None, d:])
    return corr if batched else corr[0]


# ---------------------------------------------------------------------------
# Incremental windowed dCor (the reference's fleet path)
#
# Replacing ring slot k of a window touches exactly row k and column k of
# every (symmetric) distance matrix, so the three sums dCor needs can be
# kept instead of recomputed:
#
#     cross_ab = Σ_ij d^a_ij · d^b_ij          (C, C)
#     rows_i   = Σ_j  d_ij                     (W, C)   (row sums)
#     S        = Σ_ij d_ij = Σ_i rows_i        (C,)
#
# and for the double-centred A of Eq. 2,
#
#     Σ_ij A^a_ij A^b_ij = cross_ab − (2/n)·Σ_i rows^a_i rows^b_i + S^a S^b / n².
#
# A state is a dict of ``win`` (W, C), ``dist`` (W, W, C), ``rows`` (W, C)
# and ``cross`` (C, C) float32 tensors, each with an optional leading batch
# axis (B, ...); ``n_valid``, ``slot`` and ``n_filled`` are then ints or
# (B,) tensors.
# ---------------------------------------------------------------------------


def dcor_state_init(window: int, c: int, device="cuda") -> dict:
    """Empty incremental-dCor state for a (window, c) column block (a
    batch of empty states: ``dcor_state_from_window`` with n_valid 0)."""

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "win": zeros(window, c),
        "dist": zeros(window, window, c),
        "rows": zeros(window, c),
        "cross": zeros(c, c),
    }


def dcor_state_from_window(cols: torch.Tensor, n_valid) -> dict:
    """Full O(W²·C) build from a (W, C) or (B, W, C) column block whose
    rows at index >= n_valid are padding: what ``n_valid`` sequential
    pushes of the same rows into an empty state hold (the same masked
    |·| distances)."""
    x = cols.to(torch.float32)
    w, c = x.shape[-2:]
    n = torch.as_tensor(n_valid, device=x.device)
    valid = torch.arange(w, device=x.device) < n[..., None]  # (..., W)
    mask = (valid[..., :, None] & valid[..., None, :]).to(torch.float32)
    dist = (x[..., :, None, :] - x[..., None, :, :]).abs() * mask[..., None]
    flat = dist.reshape(*dist.shape[:-3], w * w, c)
    return {
        "win": x * valid[..., None],
        "dist": dist,
        "rows": dist.sum(dim=-2),
        "cross": flat.transpose(-1, -2) @ flat,
    }


def dcor_state_push(state: dict, row: torch.Tensor, slot, n_filled) -> dict:
    """Replace ring slot ``slot`` with observation ``row`` ((C,) or (B, C))
    in O(W·C²). ``n_filled`` is the number of filled slots before this
    push (the ring discipline: slot = step mod W, n_filled = min(step, W),
    so the replaced slot is the first empty or the oldest filled one).
    Removing the old row/column subtracts its pair sums; adding the new one
    is a masked (W, C) distance row and rank-one updates of the row sums
    and the (C, C) cross products. Returns a new state."""
    batched = state["win"].dim() == 3
    st = state if batched else {k: v[None] for k, v in state.items()}
    win, dist = st["win"], st["dist"]
    b, w, _ = win.shape
    dev = win.device
    ar = torch.arange(b, device=dev)
    slot = torch.as_tensor(slot, device=dev).expand(b)
    n_filled = torch.as_tensor(n_filled, device=dev).expand(b)
    r = row.to(torch.float32).reshape(b, -1)
    idx = torch.arange(w, device=dev)[None, :]
    keep = ((idx < n_filled[:, None]) & (idx != slot[:, None])).to(torch.float32)[..., None]
    old = dist[ar, slot]  # (B, W, C); zero at unfilled slots
    new = (r[:, None, :] - win).abs() * keep
    cross = (
        st["cross"]
        - 2.0 * (old.transpose(1, 2) @ old)
        + 2.0 * (new.transpose(1, 2) @ new)
    )
    rows = st["rows"] - old + new
    rows[ar, slot] = new.sum(dim=1)
    dist = dist.clone()
    dist[ar, slot] = new
    dist[ar, :, slot] = new
    win = win.clone()
    win[ar, slot] = r
    out = {"win": win, "dist": dist, "rows": rows, "cross": cross}
    return out if batched else {k: v[0] for k, v in out.items()}


def dcor_state_corr(state: dict, n_valid, d: int) -> torch.Tensor:
    """The (D, M) dCor matrix (or (B, D, M)) from the kept sums: what
    :func:`dcor_all_cols` returns for the same window contents, without
    touching (W, W)."""
    rows, cross = state["rows"], state["cross"]
    n = torch.as_tensor(n_valid, device=rows.device).clamp_min(1).to(torch.float32)
    n = n[..., None, None]
    grand = rows.sum(dim=-2)
    sums = (
        cross
        - (2.0 / n) * (rows.transpose(-1, -2) @ rows)
        + grand[..., :, None] * grand[..., None, :] / (n * n)
    )
    diag = torch.diagonal(sums, dim1=-2, dim2=-1)
    return dcor_from_sums(sums[..., :d, d:], diag[..., :d, None], diag[..., None, d:])
