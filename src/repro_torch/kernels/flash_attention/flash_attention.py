"""Flash attention for Hopper: the wrapper around the hand-written CUDA
kernel ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``
(entry ``flash_attention_bhsd``): causal, sliding-window and GQA
attention with an online softmax, float32 accumulators, whole tiles
skipped under the causal mask and the window, the ragged key tail
masked, positions contiguous from 0, output in ``v.dtype``.

What bounds it on the card: at the serving shape (B=4, Hq=16, Hkv=2,
S=512, D=128, bf16, causal) the least time is the memory side, 18.9 MB
at 3.35 TB/s = 5.63 µs; the 4.30 causal GFLOP at the bf16 tensor-core
rate take less. At DeepSeek-V2's MLA prefill (B=4, H=128, S=512, D=192,
Dv=128) it is the memory side too, 335.5 MB, 100.2 µs. The kernel has
three bodies, and :func:`body_for` names the one a call takes; the C
entry launches exactly that one or fails:

* ``"wgmma"`` — bf16, (D, Dv) in {(64, 64), (128, 128), (192, 128),
  (64, 128)}, rows 16-byte aligned (the serving path, MLA's D = qk_nope +
  qk_rope = 192 with Dv = 128, and the published Hymba's Q and K of 64
  with V of 128). A 128-row query tile per CTA: one producer thread
  loads Q once and 128-key K/V tiles into a shared-memory ring as deep as
  227 KB allows (four stages at D = 64, three at 128, two at 192) by TMA,
  with mbarriers, while two consumer warpgroups of 64 rows run S = Q·Kᵀ
  and O += P·V on ``wgmma`` (V read through the descriptor's transpose
  bit, P from registers) and the online softmax in f32 registers
  (``exp2`` of one FFMA; the mask only on tiles that cross the diagonal,
  the window edge or the tail); ``setmaxnreg`` moves registers from the
  producer to the consumers; causal tiles run heaviest first (at D = 192
  within each head, so a head's query tiles share its K/V through L2); O
  leaves through shared memory in 16-byte stores. The tensor maps are
  built over the strided views as given, so the model's (B, S, H, D)
  memory (and MLA's V, the Dv half of the expanded latent) is read in
  place; the entry does no device switch.
* ``"mma"`` — bf16, D == Dv in {16, 32}, aligned: ``mma.sync`` m16n8k16
  with ``cp.async`` double buffering over 64 × 64 tiles.
* ``"simt"`` — everything else (float32, other (D, Dv) pairs, unaligned
  views): float32 FMAs on the CUDA cores.

``sink`` (with a window): keys [0, sink) stay visible to every query
whatever the window, on every body (the published Hymba's meta tokens,
which its window layers never hide).

A query row that sees no key (a window with Sq ≥ Sk + window, no sink) gets
``attention_ref``'s answer on every body, the mean of V over the Sk keys:
the rows are known from the shapes, and the wrapper writes them after the
launch (:func:`first_blind_row`).

The reference's ``block_q``/``block_k``/``interpret`` arguments have no
counterpart (tile sizes are fixed per body). The kernel takes float32 or
bfloat16 (q, k and v of one dtype), any D up to :data:`MAX_HEAD_DIM` and
Dv in :data:`VALUE_HEAD_DIMS`.
"""
from __future__ import annotations

import ctypes
import math
import sys
from typing import Dict, Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import attention_ref

NAME = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VALUE_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in the CUDA source
BODIES = ("simt", "mma", "wgmma")  # the C entry's body codes 0, 1, 2
# (D, Dv) pairs each tensor-core body is instantiated for in the CUDA source
_TENSOR_CORE_DIMS = {"mma": {(16, 16), (32, 32)},
                     "wgmma": {(64, 64), (128, 128), (192, 128), (64, 128)}}
MAX_HEAD_DIM = 256  # keeps the shared-memory tiles under the 227 KB a block may use

_ARGTYPES = (
    [ctypes.c_void_p] * 4  # q, k, v, o
    + [ctypes.c_int] * 9  # dtype, body, B, Hq, Hkv, Sq, Sk, D, Dv
    + [ctypes.c_longlong] * 12  # (batch, head, seq) strides of q, k, v, o
    + [ctypes.c_int] * 3  # causal, window, sink
    + [ctypes.c_float, ctypes.c_void_p]
)


def _entry():
    lib = runtime.library(NAME)
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, sink: int = 0) -> None:
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
    if sink < 0:
        raise ValueError(f"sink must be >= 0, got {sink}")


def body_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window=None) -> str:
    """The body of the kernel that (B, H, S, D) inputs take: ``"wgmma"``
    for bf16 with (D, Dv) in {(64, 64), (128, 128), (192, 128), (64, 128)}, ``"mma"``
    for bf16 with (D, Dv) in {(16, 16), (32, 32)}, each only where every
    base pointer is 16-byte aligned and every stride is a positive
    multiple of 8 elements with the last axis contiguous (TMA boxes and
    16-byte vectors); ``"simt"`` otherwise. Every body takes the causal
    mask and any ``window``, so the window does not decide."""
    dims = (q.shape[-1], v.shape[-1])
    if q.dtype != torch.bfloat16:
        return "simt"
    aligned = all(
        t.data_ptr() % 16 == 0 and t.stride(-1) == 1
        and all(st > 0 and st % 8 == 0 for st in t.stride()[:-1])
        for t in (q, k, v)
    )
    if aligned:
        for body, pairs in _TENSOR_CORE_DIMS.items():
            if dims in pairs:
                return body
    return "simt"


def body_launches() -> Dict[str, int]:
    """Launches of each body since the last ``runtime.reset_launch_counts``."""
    return runtime.body_launch_counts(NAME, BODIES)


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sink: int = 0,
) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors; returns (B, Hq, Sq, Dv) in
    ``v.dtype``. CUDA tensors launch the kernel's body that
    :func:`body_for` names, on the current device (the output is laid out
    in (B, Sq, Hq, Dv) memory order); CPU tensors take ``attention_ref``.
    Raises with an input that requires grad under grad mode
    (``runtime.refuse_grad``)."""
    runtime.refuse_grad("flash_attention_bhsd", q, k, v)
    _check(q, k, v, window, sink)
    if not runtime.on_card(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, sink=sink)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    body = body_for(q, k, v, window)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=v.device).transpose(1, 2)
    lib, fn = _entry()
    runtime.count_launch(NAME, body)
    rc = fn(
        runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
        _DTYPE_CODE[q.dtype], BODIES.index(body), b, hq, hkv, sq, sk, d, dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), 0 if window is None else int(window), int(sink),
        1.0 / math.sqrt(d), runtime.stream_handle(q.device),
    )
    runtime.check(lib, rc, f"flash_attention_bhsd ({body} body)")
    blind = first_blind_row(sk, window, sink)
    if blind < sq:  # rows that see no key: attention_ref's mean of V over the Sk keys
        mean = v.float().mean(dim=2).repeat_interleave(hq // hkv, dim=1)  # (B, Hq, Dv)
        out[:, :, blind:] = mean[:, :, None, :].to(out.dtype)
    return out


def first_blind_row(sk: int, window: Optional[int], sink: int = 0) -> int:
    """The first query position that sees no key, with or without the
    causal mask: row q's nearest key is min(q, Sk - 1), out of the window
    iff q - (Sk - 1) >= window; with a sink, key 0 is seen by every row. ``attention_ref`` softmaxes such a row of
    -1e30 into the mean of V over the Sk keys; the bodies, which skip or
    mask every tile of it, do not, so the wrapper writes those rows."""
    return sys.maxsize if window is None or sink > 0 else sk - 1 + window
