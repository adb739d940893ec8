"""Assigned input shapes (the counterpart of ``repro/configs/shapes.py``).

Each shape selects which step function the dry run drives:
  train_4k    -> train_step   (tokens+labels, full sequence)
  prefill_32k -> prefill_step (fill a KV cache over the whole prompt)
  decode_32k  -> serve_step   (ONE new token against a seq_len cache)
  long_500k   -> serve_step   (sub-quadratic: SSM state or windowed cache)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Window used for full-attention archs on long_500k (the sub-quadratic
# variant); SSM and hybrid archs ignore it for their SSM state.
LONG_CONTEXT_WINDOW = 8_192
