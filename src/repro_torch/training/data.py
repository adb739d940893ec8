"""Synthetic data pipeline (the counterpart of ``repro/training/data.py``,
which imports no JAX; the port keeps its own copy).

A deterministic, shardable token stream: each (seed, step) pair derives
its batch from a counter-based numpy PRNG, so batches are reproducible
without a filesystem dataset, and bitwise the reference's. Structure (a
Zipf-ish unigram mixture + short-range copy structure) gives a
non-trivial, learnable distribution, so loss curves actually move.
Batches stay numpy: the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_prob: float = 0.35  # P(token t = token t-3): learnable structure

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """``tokens`` and next-token ``labels``, (global_batch, seq_len) int32."""
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        # Zipf-like unigram distribution over vocab
        base = rng.zipf(1.3, size=(b, s + 1)) % self.vocab
        # overlay copy structure: with prob copy_prob, token = token[t-3]
        copy = rng.random((b, s + 1)) < self.copy_prob
        tok = base.copy()
        tok[:, 3:] = np.where(copy[:, 3:], tok[:, :-3], tok[:, 3:])
        return {"tokens": tok[:, :-1].astype(np.int32), "labels": tok[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def multimodal_extras(cfg, batch: int, seed: int = 0, std: float = 0.02) -> Dict[str, np.ndarray]:
    """The stub modality front ends: patch embeddings ``vision_embeds``
    (B, n_vision_tokens, d_model) for a vision model, frame embeddings
    ``enc_feats`` (B, encoder_seq_len, d_model) for an encoder-decoder
    model, normal(0, ``std``) float32 from a numpy seed (the reference's
    draws at its fixed 0.02, the default)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_vision_tokens:
        out["vision_embeds"] = rng.normal(
            0, std, (batch, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["enc_feats"] = rng.normal(
            0, std, (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out
