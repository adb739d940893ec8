"""Serving launcher: batched generation with the runtime's concurrency
knob (the counterpart of ``repro/launch/serve.py``).

Serves the full configuration on the card, with prefill attention through
the hand-written flash attention kernel. ``--reduced`` serves
``cfg.reduced()`` instead (the reference hard-codes it, because it runs
on a CPU); the CPU tests pass ``reduced=True, device="cpu"``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --requests 16 --prompt-len 512 --new-tokens 32 --batch 4 --concurrency 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.transformer import ApplyCtx, init_model_params
from repro_torch.serving import Request, ServingEngine, ServingRuntime


def build_engine(
    arch: str,
    batch: int,
    max_len: int,
    seed: int = 0,
    *,
    reduced: bool = False,
    device="cuda",
) -> ServingEngine:
    """A bf16 serving engine over random weights drawn from a
    ``torch.Generator`` seeded with ``seed``, with prefill attention
    through the kernel."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    rcfg = RunConfig(compute_dtype="bfloat16", use_kernels=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_model_params(cfg, rcfg, gen, device)
    return ServingEngine(ApplyCtx(cfg, rcfg), params, batch, max_len)


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
    device="cuda",
):
    """Serve ``requests`` random prompts through the runtime and return its
    drain metrics (throughput, p50/p99 latency, request count)."""
    engine = build_engine(
        arch, batch, prompt_len + new_tokens + 1, seed, reduced=reduced, device=device
    )
    cfg = engine.ctx.cfg
    runtime = ServingRuntime(engine, batch_size=batch, concurrency=concurrency)
    rng = np.random.default_rng(seed)
    for rid in range(requests):
        runtime.submit(
            Request(rid, rng.integers(0, cfg.vocab, prompt_len, dtype=np.int32),
                    new_tokens)
        )
    metrics = runtime.drain()
    print(
        f"{arch}: {metrics['requests']} requests, "
        f"{metrics['throughput_tok_s']:.1f} tok/s, "
        f"p50={metrics['p50_latency_s']*1e3:.0f}ms p99={metrics['p99_latency_s']*1e3:.0f}ms"
    )
    return metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--concurrency", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="serve cfg.reduced() (the CPU smoke size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.arch, args.requests, args.prompt_len, args.new_tokens,
          args.batch, args.concurrency, reduced=args.reduced, device=args.device)


if __name__ == "__main__":
    main()
