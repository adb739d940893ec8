"""Mamba2 SSD chunked scan for Hopper: the wrapper around the hand-written
CUDA kernel ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/ssd_scan.py::
_ssd_kernel`` (entry ``ssd_pallas``): per (batch, head), the intra-chunk
dual form (C·Bᵀ ⊙ L)·(dt ⊙ x), the inter-chunk term exp(cs) ⊙ C·Sᵀ, and
the (hd × N) float32 state S carried from chunk to chunk; ngroups = 1, an
optional initial state, the ragged tail masked.

What bounds it on the card: at the Mamba2-2.7B serving shape (B=4, S=512,
NH=80, hd=64, N=128, chunk 256, bf16) the least time is the memory side,
about 54 MB at 3.35 TB/s = 16 µs; the causal half of the intra-chunk
products at the bf16 tensor-core rate takes less. At Hymba-1.5B's (NH=50,
N=16) it is about 28 MB, 8 µs. The kernel has two bodies, and
:func:`body_for` names the one a call takes; the C entry launches exactly
that one or fails:

* ``"wgmma"`` — bf16 at hd 64 with N 128 (Mamba2) or N 16 (Hymba), chunk a
  multiple of 64, rows 16-byte aligned (the serving paths), each of its
  kernels compiled for both N: the SSD algorithm's
  chunk-parallel split, three kernels in one call. (1) Chunk states in
  parallel over (batch, chunk, head): cs and each chunk's end state from
  zero on ``wgmma``, the weighted x split into a bf16 high and low part so
  the float32 state keeps float32-like accuracy. (2) State passing, the
  float32 recurrence over chunks of :func:`~repro_torch.kernels.ssd_scan.
  ref.ssd_state_passing_ref`, writing each entering state in bf16 and the
  final state. (3) Outputs in parallel over (batch, chunk, 64-row query
  tile) × a group of four heads: C·Bᵀ formed once per CTA and reused by
  every head of the group, the decay (by selection), dt and the bf16
  rounding applied in registers (as the flash kernel rounds P), then the
  products with x and, where a state enters, exp(cs)·C·S_enterᵀ, on
  ``wgmma``, with tiles brought by TMA into shared-memory rings and y
  written by TMA. The tiles of B, C and the entering states are 64 × N:
  two 64-column boxes in the 128-byte swizzle at N = 128, one 16-column
  box in the 32-byte swizzle at N = 16. The scratch (cs and dt per chunk,
  the chunk states, the entering states) is allocated here with
  ``torch.empty``. About 4× its bound at the Mamba2 serving shape; see
  PERF.md.
* ``"simt"`` — every other case (float32, other widths, unaligned views):
  one block per (batch, head) walks the chunks in order carrying S,
  float32 FMAs on the CUDA cores.

x, B and C are read through their strides, so the model's views of the
convolution output go in without a copy (only a last axis that is not
contiguous is copied). The kernel takes x, B and C in float32 or bfloat16
(one dtype for all three), dt and A in float32, any chunk, N and hd up to
:data:`MAX_HEAD_DIM` whose tiles fit in a block's shared memory.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan.ref import ssd_ref

NAME = "ssd_scan"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("simt", "wgmma")  # the C entry's body codes 0, 1
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232_448  # what one Hopper block may use
_TILE = 64  # rows per query / key tile, fixed by the compiled kernel
WGMMA_WIDTHS = ((64, 16), (64, 128))  # the (hd, N) the wgmma body is compiled for
# the wgmma body's shared memory (mirrors ssd_scan.cu): x boxes of 64 x 64
# bf16 (8 KB), tiles of B, C and the entering states of 64 x N bf16 (2 KB at
# N = 16, 16 KB at N = 128); phase 1 a ring of 2 (B tile, x box) stages and
# its 4 barriers, phase 3 C, 2 wide (tile) and 4 narrow (box) slots, its 13
# barriers and cs, dt of SCAN_G = 4 heads; + 1024 to align
_BOX = 8192
_SCAN_G = 4


def _wgmma_fixed(n: int) -> Tuple[int, int]:
    """The wgmma body's shared memory besides the per-row floats: phase 1's,
    phase 3's."""
    tile = 64 * n * 2
    return (1024 + 2 * (tile + _BOX) + 16 * 2,
            1024 + (1 + 2) * tile + 4 * _BOX + 8 * (1 + 2 * 2 + 2 * 4))

_ARGTYPES = (
    [ctypes.c_void_p] * 12  # x, dt, A, B, C, s0, y, sfin; scratch cs, dt, states, senter
    + [ctypes.c_int] * 9  # dtype, body, device, B, S, NH, hd, N, chunk
    + [ctypes.c_longlong] * 13  # strides of x, dt, B, C, y
    + [ctypes.c_void_p]  # stream
)


def smem_bytes(chunk: int, hd: int, n: int, body: str = "simt") -> int:
    """Shared memory one block of ``body`` asks for (mirrors the CUDA
    source). ``"simt"`` (``smem_floats``): cs, dt and seg over the chunk
    padded to the tile, the C and B tiles, the dt·x tile, the score tile
    and the state. ``"wgmma"``: the larger of its chunk-states kernel (a
    ring of two B and x tiles, then dt, cs and the weights over the chunk)
    and its outputs kernel (C, the rings of entering states or B tiles and
    of x tiles, then cs and dt of a group of heads over the chunk), at the
    ``n`` given."""
    if body == "wgmma":
        p1, p3 = _wgmma_fixed(n)
        return max(p1 + 12 * chunk, p3 + 8 * _SCAN_G * chunk)
    qp = -(-chunk // _TILE) * _TILE
    hdp = 16 * next(c for c in (1, 2, 4, 8) if 16 * c >= hd)
    floats = 3 * qp + 2 * _TILE * (n + 1) + _TILE * hdp + _TILE * (_TILE + 1) + hdp * (n + 1)
    return 4 * floats


def body_for(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> str:
    """The body of the kernel that a call takes: ``"wgmma"`` for bf16 x, B
    and C with (hd, N) in :data:`WGMMA_WIDTHS` and a chunk that is a
    multiple of 64 whose tiles fit in shared memory, only where every base
    pointer is 16-byte aligned and every stride is a positive multiple of
    8 elements with the last axis contiguous (TMA boxes); ``"simt"``
    otherwise. A function of shapes, dtypes and strides alone, so the CPU
    tests can ask it too."""
    widths = (x.shape[-1], Bm.shape[-1])
    if (x.dtype != torch.bfloat16 or widths not in WGMMA_WIDTHS
            or chunk % _TILE or smem_bytes(chunk, *widths, "wgmma") > MAX_SMEM_BYTES):
        return "simt"
    aligned = all(
        t.data_ptr() % 16 == 0 and t.stride(-1) == 1
        and all(st > 0 and st % 8 == 0 for st in t.stride()[:-1])
        for t in (x, Bm, Cm)
    )
    return "wgmma" if aligned else "simt"


def body_launches() -> Dict[str, int]:
    """Launches of each body since the last ``runtime.reset_launch_counts``."""
    return runtime.body_launch_counts(NAME, BODIES)


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
    body = body_for(x, Bm, Cm, chunk)
    need = smem_bytes(chunk, hd, n, body)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"chunk={chunk}, hd={hd}, N={n} need {need} bytes of shared memory "
                         f"per block of the {body} body, more than {MAX_SMEM_BYTES}")


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
    (B, NH, hd, N) in float32. CUDA tensors launch the kernel's body that
    :func:`body_for` names; CPU tensors take ``ssd_ref``. Raises with an
    input that requires grad under grad mode (``runtime.refuse_grad``)."""
    runtime.refuse_grad("ssd_scan", x, dt, A, Bm, Cm, initial_state)
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    extra = () if initial_state is None else (initial_state,)
    if not runtime.on_card(x, dt, A, Bm, Cm, *extra):
        return ssd_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm))
    body = body_for(x, Bm, Cm, chunk)
    A = A.contiguous()
    s0 = None if initial_state is None else initial_state.float().contiguous()
    b, s, nh, hd = x.shape
    n = Bm.shape[-1]
    dev = x.device
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=dev)
    sfin = torch.empty((b, nh, hd, n), dtype=torch.float32, device=dev)
    scratch = (None,) * 4  # kept alive until the launch is enqueued
    if body == "wgmma":  # cs and dt per chunk, the chunk and entering states
        nc = -(-s // chunk)
        scratch = (
            torch.empty((b, nh, nc, chunk), dtype=torch.float32, device=dev),
            torch.empty((b, nh, nc, chunk), dtype=torch.float32, device=dev),
            torch.empty((b, nc, nh, hd, n), dtype=torch.float32, device=dev),
            torch.empty((b, nc, nh, hd, n), dtype=torch.bfloat16, device=dev),
        )
    lib, fn = _entry()
    runtime.count_launch(NAME, body)
    rc = fn(
        runtime.ptr(x), runtime.ptr(dt), runtime.ptr(A), runtime.ptr(Bm), runtime.ptr(Cm),
        None if s0 is None else runtime.ptr(s0), runtime.ptr(y), runtime.ptr(sfin),
        *(None if t is None else runtime.ptr(t) for t in scratch),
        _DTYPE_CODE[x.dtype], BODIES.index(body), dev.index, b, s, nh, hd, n, chunk,
        x.stride(0), x.stride(1), x.stride(2), *dt.stride(),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), *y.stride()[:3],
        runtime.stream_handle(dev),
    )
    runtime.check(lib, rc, f"ssd_scan ({body} body)")
    return y, sfin
