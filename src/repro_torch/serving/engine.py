"""Serving engine: batched prefill + decode against a cache (the
counterpart of ``repro/serving/engine.py``).

``make_prefill_step`` and ``make_serve_step`` are the step functions, as
in the reference, where they are jitted. Here the prefill step runs
eagerly, and on the card the serve (decode) step is captured once in a
CUDA graph and replayed: an eager decode step enqueues thousands of
kernels from the host, and its wall time is that enqueue, so a second
in-flight group had nothing to hide behind. A replay is one launch.

Graphs hold fixed addresses, so the engine owns a pool of caches
(``acquire`` / ``release``), each allocated once, of ``batch_size`` rows
and ``max_len`` slots: a runtime slot binds to one entry for the life of
its group and prefills into it in place (the cache tree of
``transformer.empty_cache``: the main stack's, and the dense prologue's
``"pro"`` for an MoE model that has one). The runtime ``reserve``s as
many entries as its rings have slots whenever it sets them, so that no
capture falls inside a served interval; ``acquire`` adds an entry when
all are busy. Each entry has a static (B, 1) int32 token buffer, and on
the card its graph (captured when the entry is made, behind a warm-up
on a side stream, before any prefill writes into it) and the graph's
static logits. Captures are counted (``capture_counts``), as kernel
launches are, and so are the engine's replays (``replays``). An engine
with graphs decodes only pool-entry caches: ``graphs=False`` is the one
way to the eager step on the card (a timing comparison); on the CPU the
eager step is the only path. A failed capture raises; nothing falls
back.

Every call only enqueues work on the card; the runtime keeps ``c``
decode groups in flight on one device queue (the current stream).

``prefill`` and ``generate`` take the reference's ``extras``: the
encoder's frame embeddings ``enc_feats`` of an encoder-decoder model
(Whisper), or a vision model's ``vision_embeds`` (Qwen2-VL), passed
through to the model's prefill. A pool entry's cache holds Whisper's
cross-attention K/V over ``cfg.encoder_seq_len`` encoder positions, so
its graph captures the cross-attention read too; ``enc_feats`` of
another length do not fit an entry, and its prefill raises. The runtime
passes no extras, as the reference's does not.

The published Hymba (``models/hymba.py``) puts its meta tokens before
every prompt: a pool entry's ``max_len`` slots hold them, the prompt and
the decoded tokens (``prefix_tokens`` a row), and its cache keeps one K/V
entry per group of layers that share one (``kv_caches``, 17 for 32
layers), which the captured decode step reads as the eager one does.

Weights are cast once, at load. The reference keeps float32 parameters
and casts each one to the compute dtype where it is used
(``ap["wq"].astype(dt)``); at full width that moves ~20 GB per decode
step. The engine casts every weight the reference casts at use to the
compute dtype up front, which gives bit-identical results (a cast is
deterministic, and the model's per-use ``.to(dtype)`` is then a no-op).
What the reference reads in float32 stays float32, since a round trip
through bf16 would not be exact: the norm weights (``rms_norm`` widens
them, Mamba2's ``norm_w`` too; Whisper's ``layer_norm`` its weights and
biases), Mamba2's ``dt_bias`` (added to the
float32 dt) and ``A_log`` (cast to float32 before ``exp``), a hybrid
layer's ``mix_gate`` (cast to float32 before ``sigmoid``), an MoE layer's
``router`` (the reference routes with float32 logits from float32 router
weights; bf16 weights would change what top-k ranks) and MLA's
``kv_norm`` and ``q_norm`` (read by ``rms_norm``).

Logits reach the host without waiting on other slots
(``fetch_last``): at dispatch, the last position is cast to float32 and
copied ``non_blocking`` into pinned host memory behind a CUDA event; at
retire only that event is waited on. A plain ``logits.cpu()`` would wait
for every decode queued before it on the stream and serialise the ring,
where the reference's device-to-host transfer skips the execute queue.
"""
from __future__ import annotations

import collections
import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import (
    ApplyCtx,
    decode_step,
    empty_cache,
    kv_cache_count,
    prefill,
    prefix_tokens,
)
from repro_torch.serving.tracing import trace_range

# parameters the reference reads in float32 at use: the norm weights
# (rms_norm widens them; MLA's kv_norm too; layer_norm its weights and
# biases), Mamba2's dt_bias (added to the float32 dt) and A_log (cast to
# float32 before exp), the hybrid mix_gate (before sigmoid), the MoE router
# (float32 routing logits); the published Hymba's inner and branch norms
_NORMS = ("ln1", "ln2", "ln_cross", "final_norm", "dt_norm", "B_norm", "C_norm", "attn_norm",
          "ssm_norm")
_FLOAT32_KEYS = (*_NORMS, *(n + "_b" for n in _NORMS), "q_norm", "k_norm", "kv_norm", "norm_w",
                 "dt_bias", "A_log", "mix_gate", "router")


def cast_for_compute(params: dict, dtype: torch.dtype) -> dict:
    """Every weight cast to ``dtype`` except those read in float32."""
    return {
        k: cast_for_compute(v, dtype)
        if isinstance(v, dict)
        else (v if k in _FLOAT32_KEYS else v.to(dtype))
        for k, v in params.items()
    }


class HostLogits:
    """Last-position logits on their way to the host.

    On the card: a float32 copy into pinned memory, started at dispatch
    behind a CUDA event; ``wait`` blocks on that event only. On the CPU
    the values are at hand."""

    __slots__ = ("_buf", "_event")

    def __init__(self, logits: torch.Tensor):
        with trace_range("serving.logits.copy"):
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


# graph captures per model (cfg.name) since the last reset
_CAPTURES: collections.Counter = collections.Counter()
WARMUP_STEPS = 3  # eager steps on a side stream before a capture, as PyTorch asks


def capture_counts() -> Dict[str, int]:
    """CUDA graph captures per model since :func:`reset_capture_counts`."""
    return dict(_CAPTURES)


def reset_capture_counts() -> None:
    _CAPTURES.clear()


def make_prefill_step(ctx: ApplyCtx, capacity=None):
    """Prefill step ``(params, batch, out=None) -> (cache, logits)`` for a
    fixed model context; ``capacity`` pads the KV cache length, ``out`` is
    a preallocated cache to fill in place."""

    def prefill_step(params, batch, out=None):
        return prefill(ctx, params, batch, capacity=capacity, out=out)

    return prefill_step


def make_serve_step(ctx: ApplyCtx):
    """Single-token decode step ``(params, cache, tokens) -> (cache,
    logits)``. It writes the cache in place, ``length`` included, and
    reads no device value on the host, so it can be captured in a CUDA
    graph and replayed against the same tensors."""

    def serve_step(params, cache, tokens):
        new, logits = decode_step(ctx, params, cache, tokens)
        cache["length"].copy_(new["length"])
        return cache, logits

    return serve_step


class _Entry:
    """One pool entry: a cache, its static token buffer and, on the card,
    its captured serve step and that graph's static logits."""

    __slots__ = ("cache", "tokens", "graph", "logits", "busy")

    def __init__(self, cache: dict, tokens: torch.Tensor):
        self.cache = cache
        self.tokens = tokens
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.busy = False


class ServingEngine:
    """Greedy-decoding engine over batch-aligned request groups."""

    def __init__(self, ctx: ApplyCtx, params: dict, batch_size: int, max_len: int,
                 graphs: Optional[bool] = None):
        self.ctx = ctx
        self.device = params["embed"].device  # the engine runs where its weights lie
        self.params = cast_for_compute(params, ctx.rcfg.cdtype)
        self.batch = batch_size
        self.max_len = max_len
        self.prefix_tokens = prefix_tokens(ctx.cfg)  # positions before every prompt
        self.kv_caches = kv_cache_count(ctx.cfg)  # distinct K/V entries a row keeps
        on_card = self.device.type == "cuda"
        self.graphs = on_card if graphs is None else bool(graphs)
        if self.graphs and not on_card:
            raise ValueError("CUDA graphs need the engine's weights on the card")
        self._prefill = make_prefill_step(ctx, capacity=max_len)
        self._serve = make_serve_step(ctx)
        self.pool: List[_Entry] = []
        self.replays = 0  # graph replays, one per graphed decode

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

    def features(self, a) -> torch.Tensor:
        """Host or device float features (``enc_feats``, ``vision_embeds``)
        -> a tensor on the engine's device, uploaded as ``tokens`` are
        (pinned, ``non_blocking`` on the card); the model casts them to
        the compute dtype."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -------------------------------------------------------------- pool
    def acquire(self) -> int:
        """A free pool entry's index, marked busy; the pool grows by one
        entry (and, with graphs, one capture) when every entry is busy."""
        k = next((k for k, e in enumerate(self.pool) if not e.busy), None)
        if k is None:
            k = self._grow()
        self.pool[k].busy = True
        return k

    def reserve(self, n: int) -> None:
        """Grow the pool to at least ``n`` entries (with graphs, one
        capture each)."""
        while len(self.pool) < n:
            self._grow()

    def _grow(self) -> int:
        """Add a pool entry (capturing its graph, with graphs); its index."""
        with torch.inference_mode():
            cache = empty_cache(self.ctx.cfg, self.batch, self.max_len, self.device)
            cache["entry"] = len(self.pool)
            e = _Entry(cache, torch.zeros((self.batch, 1), dtype=torch.int32,
                                          device=self.device))
        if self.graphs:
            self._capture(e)
        self.pool.append(e)
        return len(self.pool) - 1

    def release(self, k: int) -> None:
        """Give pool entry ``k`` back (its group has finished)."""
        self.pool[k].busy = False

    def _capture(self, e: _Entry) -> None:
        """Capture the serve step against entry ``e``'s cache and token
        buffer. The warm-up steps and the capture run on the entry's
        zeroed cache, before any prefill writes into it (a prefill
        overwrites every tensor of it). The garbage collector is run
        first and held off during the capture: a graph freed while
        another is being captured (an engine left in a reference cycle)
        invalidates that capture."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.inference_mode():
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._serve(self.params, e.cache, e.tokens)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    _, e.logits = self._serve(self.params, e.cache, e.tokens)
            finally:
                if collecting:
                    gc.enable()
        e.graph = graph
        _CAPTURES[self.ctx.cfg.name] += 1

    # ------------------------------------------------------------- steps
    @torch.inference_mode()
    def prefill(self, tokens, extras: Optional[Dict] = None, entry: Optional[int] = None):
        """Prompt (B, S) -> (cache, logits (B, 1, vocab)) on the device.
        ``extras`` (``enc_feats``, ``vision_embeds``: arrays or tensors)
        go to the model's prefill beside the tokens. With ``entry`` (from
        ``acquire``) the prompt is prefilled into that pool entry's cache,
        whose ``max_len`` slots must hold it (and whose cross-attention
        cache the ``enc_feats``); without, into a new cache."""
        batch = {"tokens": self.tokens(tokens)}
        for name, a in (extras or {}).items():
            batch[name] = self.features(a)
        if entry is None:
            return self._prefill(self.params, batch)
        s = batch["tokens"].shape[1] + self.prefix_tokens
        if s > self.max_len:
            raise ValueError(f"a prompt of {s} positions overflows a pool entry of "
                             f"{self.max_len} slots")
        return self._prefill(self.params, batch, out=self.pool[entry].cache)

    @torch.inference_mode()
    def decode(self, cache, tokens):
        """One decode step. Dispatch is asynchronous on the card: the
        returned logits are a device tensor still being computed, which is
        what lets the runtime keep ``c`` groups in flight. The cache's
        tensors are updated in place.

        A pool entry's cache on an engine with graphs replays the entry's
        graph: the tokens go into its static buffer, and the logits
        returned are the graph's static buffer, which the entry's next
        replay overwrites. So a caller reads them (``fetch_last``) before
        it decodes that entry again; the runtime does, since it decodes a
        slot only from that slot's retire, after it has waited on the
        copy of the slot's logits."""
        if not self.graphs:
            return self._serve(self.params, cache, self.tokens(tokens))
        k = cache.get("entry")
        if k is None:
            raise ValueError("an engine with CUDA graphs decodes only pool-entry caches: "
                             "prefill with entry=acquire(), or build it with graphs=False")
        e = self.pool[k]
        with trace_range("serving.decode.upload"):
            e.tokens.copy_(self.tokens(tokens), non_blocking=True)
        with trace_range("serving.decode.replay"):
            e.graph.replay()
        self.replays += 1
        return e.cache, e.logits

    @staticmethod
    def fetch_last(logits: torch.Tensor) -> HostLogits:
        """Start moving the last position's logits to the host."""
        return HostLogits(logits)

    def generate(
        self,
        prompt: np.ndarray,
        n_tokens: int,
        extras: Optional[Dict] = None,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """Greedy (``temperature <= 0``) or sampled generation of
        ``n_tokens`` tokens per row after a prefill of ``prompt`` with
        ``extras`` (see ``prefill``); returns (B, n_tokens) int32. Sampling
        draws from a ``torch.Generator`` seeded with ``seed``: the same
        distribution as the reference's ``jax.random.categorical``, not the
        same numbers."""
        fits = (prompt.shape[0] == self.batch
                and prompt.shape[1] + self.prefix_tokens <= self.max_len)
        if self.graphs and not fits:
            raise ValueError(f"a prompt of shape {prompt.shape} does not fit a pool entry of "
                             f"({self.batch}, {self.max_len}), and graphs decode only those")
        k = self.acquire() if fits else None  # a pool entry: on the card, the graph
        try:
            cache, logits = self.prefill(prompt, extras, entry=k)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            out = []
            tok = self._sample(logits, temperature, gen)
            for _ in range(n_tokens):
                out.append(tok.cpu().numpy())
                cache, logits = self.decode(cache, tok)
                tok = self._sample(logits, temperature, gen)
        finally:
            if k is not None:
                self.release(k)
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
