"""Flash attention for Hopper: the wrapper around the hand-written CUDA
kernel ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``
(entry ``flash_attention_bhsd``): causal, sliding-window and GQA
attention with an online softmax, float32 accumulators, whole tiles
skipped under the causal mask and the window, the ragged key tail
masked, positions contiguous from 0, output in ``v.dtype``.

What bounds it on the card: at the serving shape (B=4, Hq=16, Hkv=2,
S=512, D=128, bf16) the least time is the memory side, about 19 MB at
3.35 TB/s; the causal FLOPs at the bf16 tensor-core rate take less. The
design keeps the whole softmax state of a 64-row query tile in one
block's registers and stages each 64-key K/V tile in shared memory once,
so K and V are read once per query tile and Q once in all, and the GQA
group shares KV head h // g with no replication. This first version does
its products on the float32 CUDA cores, not with ``wgmma``, so it is
bound by shared-memory bandwidth and FMA issue well above that roofline
(see PERF.md); the tensor-core version is later work.

Tile sizes are fixed by the compiled kernel (64 × 64), so the reference's
``block_q``/``block_k``/``interpret`` arguments have no counterpart. The
kernel takes float32 or bfloat16 (q, k and v of one dtype), any D up to
:data:`MAX_HEAD_DIM` and Dv in :data:`VALUE_HEAD_DIMS`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import attention_ref

NAME = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VALUE_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in the CUDA source
MAX_HEAD_DIM = 256  # keeps the shared-memory tiles under the 227 KB a block may use

_ARGTYPES = (
    [ctypes.c_void_p] * 4  # q, k, v, o
    + [ctypes.c_int] * 9  # dtype, device, B, Hq, Hkv, Sq, Sk, D, Dv
    + [ctypes.c_longlong] * 12  # (batch, head, seq) strides of q, k, v, o
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def _entry():
    lib = runtime.library(NAME)
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, hq, _, d = q.shape
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM or v.shape[3] not in VALUE_HEAD_DIMS:
        raise ValueError(f"head widths D={d}, Dv={v.shape[3]} not taken by the kernel "
                         f"(D <= {MAX_HEAD_DIM}, Dv in {VALUE_HEAD_DIMS})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors; returns (B, Hq, Sq, Dv) in
    ``v.dtype``. CUDA tensors launch the kernel (the output is laid out in
    (B, Sq, Hq, Dv) memory order); CPU tensors take ``attention_ref``."""
    _check(q, k, v, window)
    if not runtime.on_card(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=v.device).transpose(1, 2)
    lib, fn = _entry()
    runtime.count_launch(NAME)
    rc = fn(
        runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
        _DTYPE_CODE[q.dtype], q.device.index, b, hq, hkv, sq, sk, d, dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), 0 if window is None else int(window),
        1.0 / math.sqrt(d), runtime.stream_handle(q.device),
    )
    runtime.check(lib, rc, "flash_attention_bhsd")
    return out
