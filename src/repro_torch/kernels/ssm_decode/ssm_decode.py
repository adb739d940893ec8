"""Mamba2's decode state step for Hopper: the wrapper around the
hand-written CUDA kernel ``csrc/ssm_decode.cu``.

Replaces no Pallas kernel: the JAX package's decode step is plain
``jnp``, and the port ran the same plain lines (``ref.py``), five
float32 passes over a widened copy of the state, and a copy back into the
bf16 cache. One launch does the step of one layer: per (row, head), dt
and dA in registers, the new state ``s·dA + dt·x·B`` in float32 in the
plain version's order and grouping, y from the unrounded new state, and
the new state written rounded to bf16 over the old one, in place. The
kernel is bound by bytes: at the Mamba2-2.7B serving shape (B 32, nh 80,
hd 64, N 128) it reads and writes 41.9 MB of state each, 25 µs at
3.35 TB/s.

x, dt, B and C are read through their strides (the model's views of the
projection and of the convolution's output go in without a copy), in the
compute dtype, float32 or bfloat16; dt is the raw projection, before
``dt_bias`` and the softplus. The state is the layer's contiguous slice
of the bf16 cache. The launch allocates only y and synchronises nothing,
so the serving engine captures it in its CUDA graph of the decode step.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref

NAME = "ssm_decode"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the (hd, N) the kernel is compiled for: Mamba2-2.7B's, Hymba-1.5B's and
# the reduced models'
WIDTHS = ((64, 128), (64, 16), (16, 16))

_ARGTYPES = (
    [ctypes.c_void_p] * 9  # state, x, dt, B, C, dt_bias, A_log, D, y
    + [ctypes.c_int] * 6  # dtype, device, B, nh, hd, N
    + [ctypes.c_longlong] * 5  # strides of x (row, head), dt, B, C (row)
    + [ctypes.c_void_p]  # stream
)


def _entry():
    lib = runtime.library(NAME)
    fn = lib.repro_ssm_decode
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(state, x, dt, dt_bias, A_log, Bm, Cm, D) -> None:
    if state.dim() != 4 or x.dim() != 3 or dt.dim() != 2 or Bm.dim() != 2:
        raise ValueError("state must be (B, nh, hd, N), x (B, nh, hd), dt (B, nh), B and C (B, N)")
    b, nh, hd, n = state.shape
    if (x.shape != (b, nh, hd) or dt.shape != (b, nh) or Bm.shape != (b, n)
            or Cm.shape != (b, n) or any(t.shape != (nh,) for t in (dt_bias, A_log, D))):
        raise ValueError(
            f"shape mismatch: state {tuple(state.shape)} x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} dt_bias {tuple(dt_bias.shape)} "
            f"A_log {tuple(A_log.shape)} D {tuple(D.shape)}")
    if (hd, n) not in WIDTHS:
        raise ValueError(f"ssm_decode is compiled for (hd, N) in {WIDTHS}, not ({hd}, {n})")
    if state.dtype != torch.bfloat16:
        raise TypeError(f"the state is the bf16 cache, got {state.dtype}")
    if not state.is_contiguous():
        raise ValueError("ssm_decode updates the state in place: it must be contiguous")
    if not (x.dtype == dt.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x, dt, B, C must share one dtype of float32/bfloat16, got "
                        f"{x.dtype}, {dt.dtype}, {Bm.dtype}, {Cm.dtype}")


def ssm_decode(
    state: torch.Tensor,  # (B, nh, hd, N) bf16, updated in place
    x: torch.Tensor,  # (B, nh, hd)
    dt: torch.Tensor,  # (B, nh) raw
    dt_bias: torch.Tensor,  # (nh,)
    A_log: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
    D: torch.Tensor,  # (nh,)
) -> torch.Tensor:
    """One decode state step of one layer: writes the new state over
    ``state`` and returns y (B, nh, hd) in ``x.dtype``. CUDA tensors launch
    the kernel; CPU tensors take ``ssm_decode_ref``. Raises on an
    unsupported (hd, N), a state that is not the contiguous bf16 cache,
    inputs on more than one device, or an input that requires grad under
    grad mode (``runtime.refuse_grad``)."""
    args = (state, x, dt, dt_bias, A_log, Bm, Cm, D)
    runtime.refuse_grad(NAME, *args)
    _check(*args)
    if not runtime.on_card(*args):
        return ssm_decode_ref(*args)
    if state.data_ptr() % 16:
        raise ValueError("ssm_decode reads the state in 16-byte vectors: it must be 16-byte aligned")
    x, dt, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, dt, Bm, Cm))
    dt_bias, A_log, D = (t.float().contiguous() for t in (dt_bias, A_log, D))
    b, nh, hd, n = state.shape
    dev = state.device
    y = torch.empty((b, nh, hd), dtype=x.dtype, device=dev)
    lib, fn = _entry()
    runtime.count_launch(NAME)
    rc = fn(
        runtime.ptr(state), runtime.ptr(x), runtime.ptr(dt), runtime.ptr(Bm), runtime.ptr(Cm),
        runtime.ptr(dt_bias), runtime.ptr(A_log), runtime.ptr(D), runtime.ptr(y),
        _DTYPE_CODE[x.dtype], dev.index, b, nh, hd, n,
        x.stride(0), x.stride(1), dt.stride(0), Bm.stride(0), Cm.stride(0),
        runtime.stream_handle(dev),
    )
    runtime.check(lib, rc, NAME)
    return y
