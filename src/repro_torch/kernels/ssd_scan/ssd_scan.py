"""Mamba2 SSD chunked scan for Hopper: the wrapper around the hand-written
CUDA kernel ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/ssd_scan.py::
_ssd_kernel`` (entry ``ssd_pallas``): per (batch, head), the chunks of the
sequence in order, with the intra-chunk dual form (C·Bᵀ ⊙ L)·(dt ⊙ x), the
inter-chunk term exp(cs) ⊙ C·Sᵀ, and the (hd × N) float32 state S carried
from chunk to chunk; ngroups = 1, an optional initial state, the ragged
tail masked.

What bounds it on the card: at the serving shape (B=4, S=512, NH=80,
hd=64, N=128, chunk 256, bf16) the least time is the memory side, about
54 MB at 3.35 TB/s; the causal half of the intra-chunk products at the
bf16 tensor-core rate takes less. The kernel runs one block per (batch,
head) that walks the chunks in order carrying the state, cut into 64-row
query and key tiles so that a block fits in 227 KB; key tiles above the
diagonal are skipped. In bf16 at the Mamba2 widths (hd 64, N 128) the
products run on the tensor cores (``mma.sync``), the state in float32
registers; the decayed scores are rounded to bf16 as the A operand of
their product with x (as the flash kernel rounds P), and the weighted x
of the state update is split into a bf16 high and low part, so the
carried state keeps float32-like accuracy. Every other case runs float32
FMAs on the CUDA cores. Both run well above that roofline (see PERF.md).

x, B and C are read through their strides, so the model's views of the
convolution output go in without a copy (only a last axis that is not
contiguous is copied). The kernel takes x, B and C in float32 or bfloat16
(one dtype for all three), dt and A in float32, any chunk, N and hd up to
:data:`MAX_HEAD_DIM` whose tiles fit in a block's shared memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan.ref import ssd_ref

NAME = "ssd_scan"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232_448  # what one Hopper block may use
_TILE = 64  # rows per query / key tile, fixed by the compiled kernel

_ARGTYPES = (
    [ctypes.c_void_p] * 8  # x, dt, A, B, C, s0, y, sfin
    + [ctypes.c_int] * 8  # dtype, device, B, S, NH, hd, N, chunk
    + [ctypes.c_longlong] * 13  # strides of x, dt, B, C, y
    + [ctypes.c_void_p]  # stream
)


def smem_bytes(chunk: int, hd: int, n: int) -> int:
    """Shared memory one block asks for (mirrors ``smem_floats`` in the
    CUDA source): cs, dt and seg over the chunk padded to the tile, the C
    and B tiles, the dt·x tile, the score tile and the state."""
    qp = -(-chunk // _TILE) * _TILE
    hdp = 16 * next(c for c in (1, 2, 4, 8) if 16 * c >= hd)
    floats = 3 * qp + 2 * _TILE * (n + 1) + _TILE * hdp + _TILE * (_TILE + 1) + hdp * (n + 1)
    return 4 * floats


def _entry():
    lib = runtime.library(NAME)
    fn = lib.repro_ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(x, dt, A, Bm, Cm, chunk, initial_state) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("x must be (B, S, NH, hd), dt (B, S, NH), A (NH,), B and C (B, S, N)")
    b, s, nh, hd = x.shape
    n = Bm.shape[-1]
    if dt.shape != (b, s, nh) or A.shape != (nh,) or Bm.shape != (b, s, n) or Cm.shape != Bm.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    if initial_state is not None and initial_state.shape != (b, nh, hd, n):
        raise ValueError(f"initial_state must be {(b, nh, hd, n)}, got {tuple(initial_state.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x, B, C must share one dtype of float32/bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if s < 1 or chunk < 1 or n < 1 or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"S={s}, chunk={chunk}, N={n}, hd={hd} not taken by the kernel "
                         f"(each >= 1, hd <= {MAX_HEAD_DIM})")
    if smem_bytes(chunk, hd, n) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk={chunk}, hd={hd}, N={n} need {smem_bytes(chunk, hd, n)} "
                         f"bytes of shared memory per block, more than {MAX_SMEM_BYTES}")


def ssd_scan(
    x: torch.Tensor,  # (B, S, NH, hd)
    dt: torch.Tensor,  # (B, S, NH) float32, post-softplus
    A: torch.Tensor,  # (NH,) float32, negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, NH, hd, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns y (B, S, NH, hd) in ``x.dtype`` and the final state
    (B, NH, hd, N) in float32. CUDA tensors launch the kernel; CPU tensors
    take ``ssd_ref``."""
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    extra = () if initial_state is None else (initial_state,)
    if not runtime.on_card(x, dt, A, Bm, Cm, *extra):
        return ssd_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm))
    A = A.contiguous()
    s0 = None if initial_state is None else initial_state.float().contiguous()
    b, s, nh, hd = x.shape
    n = Bm.shape[-1]
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=x.device)
    sfin = torch.empty((b, nh, hd, n), dtype=torch.float32, device=x.device)
    lib, fn = _entry()
    runtime.count_launch(NAME)
    rc = fn(
        runtime.ptr(x), runtime.ptr(dt), runtime.ptr(A), runtime.ptr(Bm), runtime.ptr(Cm),
        None if s0 is None else runtime.ptr(s0), runtime.ptr(y), runtime.ptr(sfin),
        _DTYPE_CODE[x.dtype], x.device.index, b, s, nh, hd, n, chunk,
        x.stride(0), x.stride(1), x.stride(2), *dt.stride(),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), *y.stride()[:3],
        runtime.stream_handle(x.device),
    )
    runtime.check(lib, rc, "ssd_scan")
    return y, sfin
