"""Serving launcher: batched generation with the runtime's concurrency
knob (the counterpart of ``repro/launch/serve.py``).

Serves the full configuration on the card through the hand-written
kernels: prefill attention through the flash attention kernel for a dense
decoder (``qwen2.5-3b``), the SSD chunked scan through its kernel for
Mamba2 (``mamba2-2.7b``), both, side by side in every layer, for the
hybrid Hymba (``hymba-1.5b``), flash attention with a window and a sink
of 128 meta tokens beside the Mamba-1 selective scan for the published
Hymba-1.5B (``hymba-1.5b-base``: a pool entry's slots hold the meta
tokens too), flash attention beside the compute-all MoE
FFN for Moonlight-16B-A3B (``moonshot-v1-16b-a3b``: 28.4 B parameters,
56.8 GB in bf16, one card at full width and depth), and MLA's prefill
(D = 192, Dv = 128) for DeepSeek-V2 (``deepseek-v2-236b``), which at
235.7 B parameters fits no single card: serve it with its depth cut,
``--layers 2`` (the dense layer 0 and one MoE layer of 160 experts, 5.4 B
parameters). Qwen2-VL-72B (``qwen2-vl-72b``: M-RoPE, 64 query heads over
8 KV heads of 128) takes 145 GB in bf16: serve it with its depth cut,
``--layers 8`` (9.5 B parameters), text-only as the reference's runtime
serves it. Whisper-medium (``whisper-medium``) is an encoder-decoder
model, and the runtime takes no encoder features (nor does the
reference's): run it through ``ServingEngine.generate`` with
``extras=multimodal_extras(cfg, batch)``; ``serve`` refuses it.
``--reduced`` serves ``cfg.reduced()`` instead (the reference
hard-codes it, because it runs on a CPU); the CPU tests pass
``reduced=True, device="cpu"``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b-base \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 2 \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b --layers 8 \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.transformer import ApplyCtx, init_model_params, prefix_tokens
from repro_torch.serving import Request, ServingEngine, ServingRuntime
from repro_torch.serving.engine import capture_counts
from repro_torch.training.data import multimodal_extras  # noqa: F401  (importable from here too)


def build_engine(
    arch: str,
    batch: int,
    max_len: int,
    seed: int = 0,
    *,
    reduced: bool = False,
    layers: Optional[int] = None,
    device="cuda",
    graphs=None,
) -> ServingEngine:
    """A bf16 serving engine over random weights drawn in bf16 from a
    ``torch.Generator`` seeded with ``seed`` (the engine serves every
    weight in bf16 but those the reference reads in float32; drawn in
    float32, Moonlight-16B-A3B would take 113.6 GB), with the model's
    kernels on (``use_kernels``: flash attention and/or the SSD scan in
    prefill) and, on the card, its decode step replayed from CUDA graphs
    unless ``graphs=False``. ``layers`` cuts the depth to that many layers
    (the first MoE layer stays where it was). Its pool caches (and their
    graphs) are made as a runtime reserves them."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rcfg = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16", use_kernels=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_model_params(cfg, rcfg, gen, device)
    return ServingEngine(ApplyCtx(cfg, rcfg), params, batch, max_len, graphs=graphs)


def serve(
    arch: str,
    requests: int = 8,
    prompt_len: int = 32,
    new_tokens: int = 16,
    batch: int = 4,
    concurrency: int = 1,
    seed: int = 0,
    *,
    reduced: bool = False,
    layers: Optional[int] = None,
    device="cuda",
):
    """Serve ``requests`` random prompts through the runtime and return its
    drain metrics (throughput, p50/p99 latency, request count), with the
    engine's pool entries and graph captures (``pool_entries``,
    ``graph_captures``: one capture per entry on the card, none on the
    CPU). An encoder-decoder model raises a ``ValueError``: the runtime
    takes no encoder features (module note)."""
    if get_config(arch).is_encoder_decoder:
        raise ValueError(f"{arch} is an encoder-decoder model and the serving runtime takes no "
                         "encoder features: run it through ServingEngine.generate(prompt, n, "
                         "extras={'enc_feats': ...})")
    captures = sum(capture_counts().values())
    # a pool entry's slots hold the positions before every prompt (the
    # published Hymba's meta tokens), the prompt and the decoded tokens
    slots = prefix_tokens(get_config(arch)) + prompt_len + new_tokens + 1
    engine = build_engine(arch, batch, slots, seed, reduced=reduced, layers=layers, device=device)
    cfg = engine.ctx.cfg
    runtime = ServingRuntime(engine, batch_size=batch, concurrency=concurrency)
    rng = np.random.default_rng(seed)
    for rid in range(requests):
        runtime.submit(
            Request(rid, rng.integers(0, cfg.vocab, prompt_len, dtype=np.int32),
                    new_tokens)
        )
    metrics = runtime.drain()
    metrics.update(pool_entries=len(engine.pool),
                   graph_captures=sum(capture_counts().values()) - captures)
    print(
        f"{arch}: {metrics['requests']} requests, "
        f"{metrics['throughput_tok_s']:.1f} tok/s, "
        f"p50={metrics['p50_latency_s']*1e3:.0f}ms p99={metrics['p99_latency_s']*1e3:.0f}ms"
    )
    return metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a config of the registry: a dense decoder (e.g. qwen2.5-3b), "
                         "Mamba2 (mamba2-2.7b), the hybrid Hymba (hymba-1.5b; the "
                         "published one, hymba-1.5b-base), an MoE "
                         "model (moonshot-v1-16b-a3b, qwen3-moe-235b-a22b), MLA "
                         "(deepseek-v2-236b, with --layers) or M-RoPE (qwen2-vl-72b, "
                         "with --layers, text-only); whisper-medium, an encoder-decoder "
                         "model, is refused (the runtime takes no encoder features)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--concurrency", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="serve cfg.reduced() (the CPU smoke size)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a model too large for the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.arch, args.requests, args.prompt_len, args.new_tokens,
          args.batch, args.concurrency, reduced=args.reduced, layers=args.layers,
          device=args.device)


if __name__ == "__main__":
    main()
