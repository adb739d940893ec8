"""Public wrappers: distance correlation of ORACLE-scale samples through
the dcov kernel's single-block form, as ``repro/kernels/dcov/ops.py``.

``dcor_blocked`` and ``dcor_all_blocked`` are the counterparts of
``dcor_pallas`` and ``dcor_all_pallas``: full samples of thousands of
rows (every profiled config of a landscape), no n × n matrix in device
memory. The reference's ``block`` and ``interpret`` arguments have no
counterpart: the kernel fixes its tile, and the device of the tensors
decides between the kernel and its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dcov.dcov import dcov_gram, dcov_sums
from repro_torch.kernels.dcov.ref import dcor_from_sums


def dcor_blocked(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Distance correlation (Eq. 4) of two (n,) samples."""
    sab, saa, sbb = dcov_sums(x, y)
    return dcor_from_sums(sab, saa, sbb, eps)


def dcor_all_blocked(settings: torch.Tensor, metrics: torch.Tensor) -> torch.Tensor:
    """(D, M) dCor matrix of (n, D) settings against (n, M) metrics, every
    row valid, from one Gram: the counterpart of ``dcor_all_pallas`` (and,
    for full windows, of ``repro_torch.core.dcov.dcor_all``)."""
    d = settings.shape[1]
    cols = torch.cat([settings.to(torch.float32), metrics.to(torch.float32)], dim=1)
    gram = dcov_gram(cols)
    diag = torch.diagonal(gram)
    return dcor_from_sums(gram[:d, d:], diag[:d, None], diag[None, d:])
