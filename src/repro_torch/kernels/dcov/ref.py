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
(n, n, C) stack of centred distance matrices materialized (in blocks of
rows), as the reference's oracle does, in float32 or float64, and every
sum taken pairwise in an order fixed here, so that its float32 Gram holds
to float64 on any host.
"""
from __future__ import annotations

import torch

STACK_BYTES = 1 << 30  # the most of dcov_gram_ref's (n, n, C) stack formed at once
BLOCK_ROWS = 256  # and the most rows i of it (a block that stays in the CPU's cache)


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


def _pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in an order this code fixes: the second half added
    to the first, elementwise, until one slice is left (an odd length's
    last slice folded into the first). The float32 error grows with
    log2 of the length, and the bits are the same on every host and on
    the card: each elementwise add rounds each element alone."""
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        s = t[:h] + t[h:2 * h]
        if t.shape[0] % 2:
            s[:1].add_(t[2 * h:])
        t = s
    return t[0]


def dcov_gram_ref(cols: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(C, C) Gram of ⟨A_c, A_c'⟩ sums of one (n, C) block, with the
    (n, n, C) centred distance stack materialized, computed in ``dtype``
    (the kernel's float32 by default; ``torch.float64`` is the yardstick
    the kernel is held to where the exact Gram has a zero off the
    diagonal).

    Every sum is pairwise over j for each row i, then pairwise over i
    (``_pairwise_sum``): the row sums, the grand mean and the Gram alike.
    No BLAS contraction takes part: its order over the n² stack rows is the
    host library's, and a serial one puts a 1440-row landscape's
    normalised float32 Gram ~1e-2 off float64. The stack is formed in
    blocks of at most ``BLOCK_ROWS`` rows i and ``STACK_BYTES`` (n = 16384,
    C = 8 would be 17 GB whole in float64), each column's products with
    all C columns no larger; the blocks set no part of the order, so the
    bits do not depend on them."""
    x = cols.to(dtype)
    n, c = x.shape
    block = max(1, min(BLOCK_ROWS, STACK_BYTES // max(1, n * c * x.element_size())))
    starts = range(0, n, block)
    inv_n = 1.0 / n

    def dist(i):  # (n, rows, C): |x_j - x_i| for the block's rows i, j first
        return (x[:, None, :] - x[None, i:i + block, :]).abs()

    row = torch.cat([_pairwise_sum(dist(i)) for i in starts]) * inv_n  # (n, C); the column means are its transpose
    grand = _pairwise_sum(row) * inv_n
    parts = []
    for i in starts:
        a = dist(i) - row[None, i:i + block, :] - row[:, None, :] + grand
        parts.append(torch.stack([_pairwise_sum(a[..., k:k + 1] * a) for k in range(c)], dim=1))
    return _pairwise_sum(torch.cat(parts))  # (rows, C, C) partials, then over i


def dcov_sums_ref(x: torch.Tensor, y: torch.Tensor):
    """(Σ A·B, Σ A², Σ B²) of two (n,) samples, materialized."""
    gram = dcov_gram_ref(torch.stack([x, y], dim=1))
    return gram[0, 1], gram[0, 0], gram[1, 1]


def dcor_ref(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Distance correlation of two (n,) samples, materialized."""
    return dcor_from_sums(*dcov_sums_ref(x, y), eps)
