"""``input_specs()``: meta-tensor stand-ins for every model input of every
(arch × input shape) pair (the counterpart of ``repro/launch/specs.py``,
whose ``ShapeDtypeStruct``s they replace): the reference's shapes and
dtypes, no allocation."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.transformer import abstract_cache


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _modality_extras(cfg: ModelConfig, b: int) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.n_vision_tokens:
        out["vision_embeds"] = sds((b, cfg.n_vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.is_encoder_decoder:
        out["enc_feats"] = sds((b, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16)
    return out


def cache_capacity(cfg: ModelConfig, shape: InputShape, rcfg: RunConfig) -> int:
    """Decode cache capacity: the full seq_len up to 32k; beyond that the
    sub-quadratic sliding-window variant."""
    if shape.seq_len > 32_768:
        return rcfg.long_context_window
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape, rcfg: RunConfig = RunConfig()) -> Dict[str, object]:
    """The kwargs tree of this shape's step function.

    train   -> {batch: {tokens, labels [, extras]}}
    prefill -> {batch: {tokens [, extras]}}
    decode  -> {cache: <abstract cache>, tokens: (B,1)}
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": sds((b, s), torch.int32), "labels": sds((b, s), torch.int32)}
        batch.update(_modality_extras(cfg, b))
        return {"batch": batch}
    if shape.kind == "prefill":
        batch = {"tokens": sds((b, s), torch.int32)}
        batch.update(_modality_extras(cfg, b))
        return {"batch": batch}
    if shape.kind == "decode":
        w = cache_capacity(cfg, shape, rcfg)
        return {"cache": abstract_cache(cfg, b, w), "tokens": sds((b, 1), torch.int32)}
    raise ValueError(shape.kind)
