"""The Mamba-1 selective scan for Hopper: the wrapper around the
hand-written CUDA kernel ``csrc/selective_scan.cu`` (the published
Hymba-1.5B's SSM heads in prefill).

Replaces no Pallas kernel: the JAX package has no Mamba-1 layer, and no
kernel of the port computes a scan with a decay per channel and state
(the SSD scan takes one scalar A a head). One launch scans one layer: per
(row, channel) one pass over time, the N = 16 states in registers, dt's
bias and softplus, the skip D and the gate SiLU(z) fused, y written once
in bf16 and the final state written rounded to bf16 into the layer's
slice of the cache, in place.

x, dt, z, B and C are read through their strides (the model's views of
its projections go in without a copy; the last axis contiguous), in bf16;
dt_bias, A_log and D are read in float32. The launch allocates only y
and synchronises nothing. The library is built on first use, so only a
model that runs the scan builds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

NAME = "selective_scan"
STATES = 16  # N the kernel is compiled for (Hymba's mamba_d_state)

_ARGTYPES = (
    [ctypes.c_void_p] * 10  # x, dt, z, B, C, dt_bias, A_log, D, y, state
    + [ctypes.c_int] * 4  # B, S, di, N
    + [ctypes.c_longlong] * 10  # (row, position) strides of x, dt, z, B, C
    + [ctypes.c_void_p]  # stream
)


def _entry():
    lib = runtime.library(NAME)
    fn = lib.repro_selective_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(x, dt, dt_bias, A_log, Bm, Cm, D, z, state) -> None:
    if x.dim() != 3 or Bm.dim() != 3 or state is not None and state.dim() != 3:
        raise ValueError("x, dt, z must be (B, S, di), B and C (B, S, N), the state (B, di, N)")
    b, s, di = x.shape
    n = A_log.shape[-1]
    if (dt.shape != x.shape or z.shape != x.shape or Bm.shape != (b, s, n) or Cm.shape != Bm.shape
            or A_log.shape != (di, n) or dt_bias.shape != (di,) or D.shape != (di,)
            or state is not None and state.shape != (b, di, n)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)} dt {tuple(dt.shape)} z {tuple(z.shape)} "
            f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} A_log {tuple(A_log.shape)} "
            f"dt_bias {tuple(dt_bias.shape)} D {tuple(D.shape)}"
            + ("" if state is None else f" state {tuple(state.shape)}"))


def selective_scan(
    x: torch.Tensor,  # (B, S, di)
    dt: torch.Tensor,  # (B, S, di) raw, before dt_bias and softplus
    dt_bias: torch.Tensor,  # (di,)
    A_log: torch.Tensor,  # (di, N)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    D: torch.Tensor,  # (di,)
    z: torch.Tensor,  # (B, S, di)
    state: Optional[torch.Tensor] = None,  # (B, di, N), written in place
) -> torch.Tensor:
    """y (B, S, di) in ``x.dtype`` of the scan from a zero state; the final
    state is written over ``state`` where one is given (rounded to its
    dtype). CUDA tensors launch the kernel (bf16 inputs, N = 16, a
    contiguous 16-byte aligned bf16 state); CPU tensors take
    ``selective_scan_ref``. Raises on anything else, on inputs on more
    than one device, or on an input that requires grad under grad mode
    (``runtime.refuse_grad``)."""
    args = (x, dt, dt_bias, A_log, Bm, Cm, D, z)
    runtime.refuse_grad(NAME, *args)
    _check(*args, state)
    if not runtime.on_card(*args, *(() if state is None else (state,))):
        y, final = selective_scan_ref(*args)
        if state is not None:
            state.copy_(final)
        return y
    b, s, di = x.shape
    if A_log.shape[-1] != STATES:
        raise ValueError(f"selective_scan is compiled for N = {STATES}, not {A_log.shape[-1]}")
    if any(t.dtype != torch.bfloat16 for t in (x, dt, z, Bm, Cm)):
        raise TypeError("selective_scan takes x, dt, z, B and C in bfloat16")
    if state is None:
        state = torch.empty((b, di, STATES), dtype=torch.bfloat16, device=x.device)
    if state.dtype != torch.bfloat16 or not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("the state is written in place as 16-byte vectors: a contiguous, "
                         "16-byte aligned bf16 (B, di, N) tensor")
    x, dt, z, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, dt, z, Bm, Cm))
    dt_bias, A_log, D = (t.float().contiguous() for t in (dt_bias, A_log, D))
    y = torch.empty((b, s, di), dtype=x.dtype, device=x.device)
    lib, fn = _entry()
    runtime.count_launch(NAME)
    rc = fn(
        runtime.ptr(x), runtime.ptr(dt), runtime.ptr(z), runtime.ptr(Bm), runtime.ptr(Cm),
        runtime.ptr(dt_bias), runtime.ptr(A_log), runtime.ptr(D), runtime.ptr(y),
        runtime.ptr(state), b, s, di, STATES,
        *x.stride()[:2], *dt.stride()[:2], *z.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2],
        runtime.stream_handle(x.device),
    )
    runtime.check(lib, rc, NAME)
    return y
