"""How far an MoE model's full-width bf16 prefill logits move through the
flash kernel, against how far a change of summation order alone moves
them, on the card.

For each weight seed, the model is drawn at full width in bf16 (one
parameter tree at a time) and, for each prompt seed, one 4 x 512 prefill
runs through the kernel, through its plain version and through the plain
route summed in 64- and 128-key tiles (``chip_smoke.bf16_logit_readings``;
every flash launch held to ``attention_ref`` on its own inputs). Prints one
JSON line per (weight seed, prompt seed): the kernel's and the controls'
max |logit gap| to the plain version, each relative to max|logit|, and
argmax agreement; then a summary line and the card's name and power
limit. Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/moe_logit_spread.py [--arch moonshot-v1-16b-a3b]
        [--weight-seeds 0 1 2] [--prompt-seeds 1 2 3 4] [--out FILE]

``chip_smoke.py`` holds Moonlight-16B-A3B's bf16 logits at the bound
``chip_smoke.LOGIT_REL_TOL`` that these readings set.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the model checks' helpers)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=chip_smoke.MOE_ARCH)
    ap.add_argument("--weight-seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--prompt-seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(chip_smoke.SRC))
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the flash kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.serving.engine import cast_for_compute

    cfg = chip_smoke.full_config(args.arch)
    ctx = ApplyCtx(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                                  use_kernels=True))
    runtime.build()
    lines, worst = [], []
    for w in args.weight_seeds:
        chip_smoke.free_card(torch, f"the {args.arch} weights of seed {w}")
        gen = torch.Generator(device="cuda").manual_seed(w)
        params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"), torch.bfloat16)
        reads, _ = chip_smoke.bf16_logit_readings(torch, ctx, params, args.prompt_seeds, worst)
        for r in reads:
            line = {"arch": args.arch, "weight_seed": w, "prompt_seed": r["seed"],
                    "max_abs_logit": r["scale"], "kernel_rel": r["kernel"] / r["scale"],
                    "kernel_argmax": r["agree"],
                    **{f"control{t}_rel": e / r["scale"] for t, (e, _) in r["controls"].items()},
                    **{f"control{t}_argmax": g for t, (_, g) in r["controls"].items()}}
            lines.append(line)
            print(json.dumps(line), flush=True)
        del params, reads
        torch.cuda.empty_cache()
    keys = ["kernel_rel"] + [f"control{t}_rel" for t in chip_smoke.CONTROL_TILES]
    summary = {k: {"min": min(x[k] for x in lines), "max": max(x[k] for x in lines),
                   "mean": sum(x[k] for x in lines) / len(lines)} for k in keys}
    summary["flash_launches_held"] = len(worst)
    summary["worst_launch_error_over_tol"] = max(worst)
    summary["card"] = chip_smoke.card_line()
    print(json.dumps({"summary": summary}))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines + [{"summary": summary}]))


if __name__ == "__main__":
    main()
