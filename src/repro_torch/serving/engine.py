"""Serving engine: batched prefill + decode against a KV cache (the
counterpart of ``repro/serving/engine.py``).

PyTorch runs eagerly, so there are no jitted step functions: ``prefill``
and ``decode`` call ``repro_torch.models.transformer`` directly, under
``torch.inference_mode``. On the card every call only enqueues work; the
runtime keeps ``c`` decode groups in flight on the device queue.

Weights are cast once, at load. The reference keeps float32 parameters
and casts each one to the compute dtype where it is used
(``ap["wq"].astype(dt)``); at full width that moves ~20 GB per decode
step. The engine casts every weight the reference casts at use to the
compute dtype up front, which gives bit-identical results (a cast is
deterministic, and the model's per-use ``.to(dtype)`` is then a no-op).
Norm weights stay float32: ``rms_norm`` widens them to float32, and a
round trip through bf16 would not be exact.

Logits reach the host without waiting on other slots
(``fetch_last``): at dispatch, the last position is cast to float32 and
copied ``non_blocking`` into pinned host memory behind a CUDA event; at
retire only that event is waited on. A plain ``logits.cpu()`` would wait
for every decode queued before it on the stream and serialise the ring,
where the reference's device-to-host transfer skips the execute queue.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.transformer import ApplyCtx, decode_step, prefill

# parameters the reference keeps float32 at use (rms_norm widens them)
_NORM_KEYS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def cast_for_compute(params: dict, dtype: torch.dtype) -> dict:
    """Every weight cast to ``dtype`` except the norm weights."""
    return {
        k: cast_for_compute(v, dtype)
        if isinstance(v, dict)
        else (v if k in _NORM_KEYS else v.to(dtype))
        for k, v in params.items()
    }


class HostLogits:
    """Last-position logits on their way to the host.

    On the card: a float32 copy into pinned memory, started at dispatch
    behind a CUDA event; ``wait`` blocks on that event only. On the CPU
    the values are at hand."""

    __slots__ = ("_buf", "_event")

    def __init__(self, logits: torch.Tensor):
        last = logits[:, -1].float()
        if last.is_cuda:
            self._buf = torch.empty(last.shape, dtype=torch.float32, pin_memory=True)
            self._buf.copy_(last, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(last.device))
        else:
            self._buf = last
            self._event = None

    def wait(self) -> np.ndarray:
        """(B, vocab) float32 logits of the last position."""
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


class ServingEngine:
    """Greedy-decoding engine over batch-aligned request groups."""

    def __init__(self, ctx: ApplyCtx, params: dict, batch_size: int, max_len: int):
        self.ctx = ctx
        self.device = params["embed"].device  # the engine runs where its weights lie
        self.params = cast_for_compute(params, ctx.rcfg.cdtype)
        self.batch = batch_size
        self.max_len = max_len

    def tokens(self, a) -> torch.Tensor:
        """Host int tokens -> an int32 tensor on the engine's device. On
        the card the upload goes through pinned memory, ``non_blocking``,
        so it does not wait for the decodes already queued."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.inference_mode()
    def prefill(self, tokens):
        """Prompt (B, S) -> (cache, logits (B, 1, vocab)) on the device."""
        return prefill(
            self.ctx, self.params, {"tokens": self.tokens(tokens)}, capacity=self.max_len
        )

    @torch.inference_mode()
    def decode(self, cache, tokens):
        """One decode step. Dispatch is asynchronous on the card: the
        returned logits are a device tensor still being computed, which is
        what lets the runtime keep ``c`` groups in flight. The cache's
        K/V tensors are updated in place."""
        return decode_step(self.ctx, self.params, cache, self.tokens(tokens))

    @staticmethod
    def fetch_last(logits: torch.Tensor) -> HostLogits:
        """Start moving the last position's logits to the host."""
        return HostLogits(logits)

    def generate(
        self,
        prompt: np.ndarray,
        n_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """Greedy (``temperature <= 0``) or sampled generation of
        ``n_tokens`` tokens per row; returns (B, n_tokens) int32. Sampling
        draws from a ``torch.Generator`` seeded with ``seed``: the same
        distribution as the reference's ``jax.random.categorical``, not the
        same numbers."""
        cache, logits = self.prefill(prompt)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = self._sample(logits, temperature, gen)
        for _ in range(n_tokens):
            out.append(tok.cpu().numpy())
            cache, logits = self.decode(cache, tok)
            tok = self._sample(logits, temperature, gen)
        return np.concatenate(out, axis=1)

    @staticmethod
    def _sample(
        logits: torch.Tensor, temperature: float, gen: Optional[torch.Generator]
    ) -> torch.Tensor:
        last = logits[:, -1].float()
        if temperature <= 0.0:
            return last.argmax(dim=-1, keepdim=True).to(torch.int32)
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
