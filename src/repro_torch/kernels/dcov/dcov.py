"""Distance-covariance Gram for Hopper: the wrappers around the
hand-written CUDA kernel ``csrc/dcov.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/dcov/dcov.py::
_row_sum_batch_kernel`` and ``_gram_batch_kernel`` (entry
``dcov_gram_pallas``, two-column form ``dcov_sums_pallas``). Two forms:

* :func:`dcov_gram_windows` — B zero-padded (W, C) windows with a
  per-episode ``n_valid``, one block per episode (W <= 64, C <= 8): the
  CORAL loop's per-step dCor, for the scalar spec (B = 1) and the batched
  engine alike. Bitwise the plain version's result, whatever B is.
* :func:`dcov_gram` — one (n, C) block of ORACLE-scale n: a row-sum pass
  over the whole card, then a persistent Gram pass over the tile pairs
  whose last CTA adds the per-CTA partials in a fixed order (two
  launches, the second by programmatic dependent launch; scratch from
  here).

CUDA tensors launch the kernel or the wrapper raises; CPU tensors take
the plain versions in ``ref.py``. What bounds each form, and how the
kernel answers it, is in the CUDA source's header.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.dcov.ref import dcov_gram_ref, dcov_gram_windows_ref

NAME = "dcov"
MAX_WINDOW = 64  # rows of one window the windows form takes
MAX_COLS = 8  # columns both forms take (padded to 8 in shared memory)


def _entry(symbol: str, argtypes):
    lib = runtime.library(NAME)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def dcov_gram_windows(cols: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(B, C, C) float32 Grams ⟨A_c, A_c'⟩ of B windows.

    cols: (B, W, C) float32; rows at index >= n_valid[b] are padding.
    n_valid: (B,) int32, each at least 1 (the caller clamps, as the
    reference's engine does).
    """
    runtime.refuse_grad("dcov_gram_windows", cols, n_valid)
    if cols.dim() != 3 or n_valid.shape != cols.shape[:1]:
        raise ValueError(f"cols must be (B, W, C) and n_valid (B,), got "
                         f"{tuple(cols.shape)} and {tuple(n_valid.shape)}")
    if cols.dtype != torch.float32 or n_valid.dtype != torch.int32:
        raise TypeError(f"cols must be float32 and n_valid int32, got "
                        f"{cols.dtype}, {n_valid.dtype}")
    if not runtime.on_card(cols, n_valid):
        return dcov_gram_windows_ref(cols, n_valid)
    b, w, c = cols.shape
    if not (b >= 1 and 1 <= w <= MAX_WINDOW and 1 <= c <= MAX_COLS):
        raise ValueError(f"the windows kernel takes B >= 1, W <= {MAX_WINDOW} and "
                         f"C <= {MAX_COLS}, got {(b, w, c)}")
    cols, n_valid = cols.contiguous(), n_valid.contiguous()
    gram = torch.empty((b, c, c), dtype=torch.float32, device=cols.device)
    lib, fn = _entry("repro_dcov_windows", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    runtime.count_launch(NAME)
    rc = fn(runtime.ptr(cols), runtime.ptr(n_valid), runtime.ptr(gram), cols.device.index,
            b, w, c, runtime.stream_handle(cols.device))
    runtime.check(lib, rc, "dcov windows")
    return gram


def dcov_gram(cols: torch.Tensor) -> torch.Tensor:
    """(C, C) float32 Gram ⟨A_c, A_c'⟩ of one (n, C) block, every row valid.
    Diagonal entries are the dVar sums, off-diagonals the dCov sums (both
    unnormalized; dCor takes their ratio)."""
    runtime.refuse_grad("dcov_gram", cols)
    if cols.dim() != 2 or cols.shape[0] < 1:
        raise ValueError(f"cols must be (n, C) with n >= 1, got {tuple(cols.shape)}")
    if not runtime.on_card(cols):
        return dcov_gram_ref(cols)
    if cols.dtype != torch.float32:
        raise TypeError(f"cols must be float32 on the card, got {cols.dtype}")
    n, c = cols.shape
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"the dcov kernel takes C <= {MAX_COLS} columns, got {c}")
    cols = cols.contiguous()
    if cols.data_ptr() % 16:  # the kernel reads x as float4
        cols = cols.clone()
    dev = cols.device
    lib, fn = _entry("repro_dcov_gram", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    scratch = torch.empty((_scratch_bytes(lib, n, c),), dtype=torch.uint8, device=dev)
    gram = torch.empty((c, c), dtype=torch.float32, device=dev)
    runtime.count_launch(NAME)
    rc = fn(runtime.ptr(cols), runtime.ptr(scratch), runtime.ptr(gram), dev.index, n, c,
            runtime.stream_handle(dev))
    runtime.check(lib, rc, "dcov gram")
    return gram


def _scratch_bytes(lib, n: int, c: int) -> int:
    """Bytes of scratch the single-block form takes at (n, C): the kernel's
    own plan (row means, tile totals, [pair][CTA] partial Grams, the
    ticket), from the library."""
    fn = lib.repro_dcov_gram_scratch_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return fn(n, c)


def dcov_sums(x: torch.Tensor, y: torch.Tensor):
    """(Σ A·B, Σ A², Σ B²) of two (n,) samples: the two-column form of
    :func:`dcov_gram`, as ``dcov_sums_pallas`` is of ``dcov_gram_pallas``."""
    gram = dcov_gram(torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=1))
    return gram[0, 1], gram[0, 0], gram[1, 1]
