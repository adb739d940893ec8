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

The reference's incremental window state (``dcor_state_init``,
``dcor_state_from_window``, ``dcor_state_push``, ``dcor_state_corr``)
serves only its fleet engine and is not ported yet (ROADMAP queue 1
item 11).
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
