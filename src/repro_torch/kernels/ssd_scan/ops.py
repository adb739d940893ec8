"""Model-side wrapper for the SSD scan, as ``repro/kernels/ssd_scan/ops.py``.

The model's layout is the kernel's, (B, S, NH, hd) with B and C shared by
every head, so this is a pass-through; ``models/ssm.py`` calls it where
the reference checks ``rcfg.use_pallas``. The reference's ``interpret``
argument has no counterpart: the device of the tensors decides.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
):
    """Chunked SSD scan; returns (y (B,S,NH,hd), final state (B,NH,hd,N))."""
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
