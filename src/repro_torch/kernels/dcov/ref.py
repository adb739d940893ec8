"""Plain PyTorch versions of the dcov kernels, after
``repro/kernels/dcov/ref.py`` and ``repro/core/dcov.py::dcor_all_cols``.

``dcov_gram_windows_ref`` is the plain version of the windows form (the
CORAL loop's per-step Gram over B zero-padded windows). It keeps
``dcor_all_cols``'s op order (``inv_n = 1/n`` multiplied in, the column
means the row means transposed, ``grand = Σ row · inv_n``) and takes
every sum in one fixed order, term by term — over j for each row i, then
over i — with elementwise tensor ops only. An elementwise op rounds each
element alone, so an episode's Gram is bitwise the same whatever B is and
wherever the episode sits in the batch, on the CPU as on the card; the
windows kernel sums in the same order and gives the same bits.

``dcov_gram_ref`` is the plain version of the ORACLE-scale form: the
(n, n, C) stack of centred distance matrices materialized, then one
contraction, as the reference's oracle does.
"""
from __future__ import annotations

import torch


def dcor_from_sums(
    sab: torch.Tensor, saa: torch.Tensor, sbb: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """dCor (Eq. 4) from ⟨A,B⟩ / ⟨A,A⟩ / ⟨B,B⟩ sums (broadcasting); 0 where
    the denominator is below ``eps`` (a constant column)."""
    denom = torch.sqrt(torch.clamp_min(saa * sbb, 0.0))
    val = torch.sqrt(torch.clamp_min(sab, 0.0) / torch.clamp_min(denom, eps))
    return torch.where(denom < eps, 0.0, torch.clamp(val, 0.0, 1.0))


def dcov_gram_windows_ref(cols: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(B, C, C) Grams ⟨A_c, A_c'⟩ of B windows.

    cols: (B, W, C) float32, rows at index >= n_valid[b] are padding and
    are masked out of every sum; n_valid: (B,) int32, at least 1.
    """
    x = cols.to(torch.float32)
    b, w, c = x.shape
    valid = torch.arange(w, device=x.device)[None, :] < n_valid[:, None]  # (B, W)
    mask = (valid[:, :, None] & valid[:, None, :]).to(torch.float32)  # (B, W, W)
    dist = (x[:, :, None, :] - x[:, None, :, :]).abs() * mask[..., None]  # (B, W, W, C)
    inv_n = 1.0 / n_valid.to(torch.float32)
    acc = torch.zeros((b, w, c), dtype=torch.float32, device=x.device)
    for j in range(w):
        acc = acc + dist[:, :, j, :]
    row = acc * inv_n[:, None, None]  # (B, W, C); the column means are its transpose
    tot = torch.zeros((b, c), dtype=torch.float32, device=x.device)
    for i in range(w):
        tot = tot + row[:, i, :]
    grand = tot * inv_n[:, None]
    centred = (dist - row[:, :, None, :]) - row[:, None, :, :]
    A = (centred + grand[:, None, None, :]) * mask[..., None]
    part = torch.zeros((b, w, c, c), dtype=torch.float32, device=x.device)
    for j in range(w):
        a = A[:, :, j, :]  # (B, W, C)
        part = part + a[:, :, :, None] * a[:, :, None, :]
    gram = torch.zeros((b, c, c), dtype=torch.float32, device=x.device)
    for i in range(w):
        gram = gram + part[:, i]
    return gram


def dcov_gram_ref(cols: torch.Tensor) -> torch.Tensor:
    """(C, C) Gram of ⟨A_c, A_c'⟩ sums of one (n, C) block, with the
    (n, n, C) centred distance stack materialized."""
    x = cols.to(torch.float32)
    n = x.shape[0]
    dist = (x[:, None, :] - x[None, :, :]).abs()
    inv_n = 1.0 / n
    row = dist.sum(dim=1, keepdim=True) * inv_n
    col = row.transpose(0, 1)
    grand = row.sum(dim=(0, 1)) * inv_n
    A = dist - row - col + grand[None, None, :]
    flat = A.reshape(n * n, -1)
    return flat.T @ flat


def dcov_sums_ref(x: torch.Tensor, y: torch.Tensor):
    """(Σ A·B, Σ A², Σ B²) of two (n,) samples, materialized."""
    gram = dcov_gram_ref(torch.stack([x, y], dim=1))
    return gram[0, 1], gram[0, 0], gram[1, 1]


def dcor_ref(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Distance correlation of two (n,) samples, materialized."""
    return dcor_from_sums(*dcov_sums_ref(x, y), eps)
