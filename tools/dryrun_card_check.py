"""The dry run's counts against a real run, for one prefill on a 1×1 mesh.

``--mode dry`` counts the prefill step (``launch/dryrun.py``) on meta
tensors over a 1×1 ``fake`` mesh and prints its ``argument_bytes``,
matmul FLOPs and ``peak_bytes``. ``--mode real`` runs the same step on
the card (the plain path, float32 parameters drawn from a seeded
generator, bf16 compute) in this fresh process and prints the bytes of
its parameters and inputs, the matmul FLOPs that ``FlopCounterMode``
counts, and ``torch.cuda.max_memory_allocated()`` over the step (the
parameters and inputs included). Each mode runs in a process of its own.
Run from the repository root:

    python3 tools/dryrun_card_check.py --mode dry  [--arch qwen2.5-3b] [--batch 4] [--seq 512] [--reduced]
    python3 tools/dryrun_card_check.py --mode real [--arch qwen2.5-3b] [--batch 4] [--seq 512] [--reduced]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def dry(cfg, shape) -> dict:
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh

    rec = dryrun.run_on_mesh(cfg, shape, make_fake_mesh((1, 1)), RunConfig())
    return {"argument_bytes": rec["memory"]["argument_bytes"],
            "flops": rec["roofline"]["flops_per_chip"],
            "peak_bytes": rec["memory"]["peak_bytes"],
            "collective_bytes": sum(rec["roofline"]["collective_per_chip"].values()),
            "seconds": rec["compile_seconds"]}


def real(cfg, shape) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.serving.engine import make_prefill_step

    rcfg = RunConfig()
    params = init_model_params(cfg, rcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len), generator=gen,
                           device="cuda", dtype=torch.int32)
    leaves = [t for t in _leaves(params)] + [tokens]
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    step = make_prefill_step(ApplyCtx(cfg, rcfg))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        cache, logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(logits.float()).all())
    return {"argument_bytes": arg_bytes, "flops": float(fc.get_total_flops()),
            "peak_bytes": int(torch.cuda.max_memory_allocated()), "finite": ok}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("dry", "real"), required=True)
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import InputShape

    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    shape = InputShape("prefill", args.seq, args.batch, "prefill")
    out = dry(cfg, shape) if args.mode == "dry" else real(cfg, shape)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
