"""Where the flash kernel's wgmma body spends its time, on the card.

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``, each with one part of the key loop taken out, and
times each on the same inputs with ``chip_smoke.device_ms``. A variant
computes garbage; only its time is read. Run from the repository root on
a machine with an NVIDIA H100 (it builds with ``nvcc`` and fails without
a card):

    python3 tools/flash_ablation.py

With ``--trees DIR [DIR ...]`` it times instead the kernel as built in
each of the given checkouts (each in a process of its own, in the order
given, e.g. a parent, this tree, this tree, the parent) at every shape
below, naming the body each tree's ``body_for`` picks:

    python3 tools/flash_ablation.py --trees build/parent . . build/parent

Variants:

* ``as built``: the source as it is;
* ``no softmax``: no mask, no online softmax, no rescale of O (P is S);
* ``no products``: neither S = Q K^T nor O += P V is issued (S = 0);
* ``one stage fewer``: a K/V ring one stage shallower than the shared
  memory allows (two at D = 128, not three; one at DeepSeek-V2's D = 192,
  Dv = 128, not two: no load overlaps the products);
* ``grid order flipped``: heavy first over all heads at D = 192, Dv = 128
  (each head's K/V then read from device memory about as often as it has
  query tiles), and each head's query tiles side by side at D == Dv.

Shapes, bf16, causal: the Qwen2.5-3B serving shape (B=4, Hq=16, Hkv=2,
S=512, D=128), the same at B=1 (one wave of CTAs), S=4096 at B=1,
Hymba-1.5B's (B=4, Hq=25, Hkv=5, S=512, D=64) and DeepSeek-V2's MLA
prefill (B=4, H=128, S=512, D=192, Dv=128). Each
variant is timed in turns, ``ROUNDS`` times.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "ablation"
ROUNDS = 2
SHAPES = {  # (B, Hq, Hkv, S, D, Dv)
    "serving B=4": (4, 16, 2, 512, 128, 128),
    "serving B=1": (1, 16, 2, 512, 128, 128),
    "S=4096 B=1": (1, 16, 2, 4096, 128, 128),
    "Hymba B=4": (4, 25, 5, 512, 64, 64),
    "MLA B=4": (4, 128, 128, 512, 192, 128),
}


def _cut(src: str, start: str, end: str, insert: str = "") -> str:
    """``src`` with the text from ``start`` up to (not including) ``end``
    replaced by ``insert``; raises if either marker is missing."""
    a = src.index(start)
    b = src.index(end, a)
    return src[:a] + insert + src[b:]


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"marker not found in {SOURCE.name}: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    qk_loop = "#pragma unroll\n  for (int kk = 0; kk < D / 16; ++kk) {"
    pv_loop = "#pragma unroll\n  for (int kk = 0; kk < WS_BK / 16; ++kk)\n#pragma unroll\n    for (int cb"
    no_products = _cut(src, qk_loop, "  wgmma_commit();\n  wgmma_wait_all();\n  fence_regs(s);",
                       "  for (int i = 0; i < 64; ++i) s[i] = 0.f;\n")
    no_products = _cut(no_products, pv_loop, "  wgmma_commit();\n  wgmma_wait_all();\n#pragma unroll")
    return {
        "as built": src,
        "no softmax": _cut(src, "  // Element 4 nb + e is row row0", "  // O += P V: P (bf16"),
        "no products": no_products,
        "one stage fewer": _replace(src, "STAGES = FIT < 4 ? FIT : 4;",
                                    "STAGES = (FIT < 4 ? FIT : 4) - 1;"),
        "grid order flipped": _replace(src, "HEAD_MAJOR = D != DV;", "HEAD_MAJOR = D == DV;"),
    }


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def shape_inputs(torch, chip_smoke) -> dict:
    return {label: chip_smoke.attention_inputs(torch, torch.bfloat16, *shape, seed=0)
            for label, shape in SHAPES.items()}


def time_tree(tree: Path) -> None:
    """The kernel as built in ``tree``, at every shape (the timing helpers
    are this checkout's)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import body_for, flash_attention_bhsd

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the ablation times the kernel on the card")
    for label, (q, k, v) in shape_inputs(torch, chip_smoke).items():
        ms = chip_smoke.device_ms(lambda: flash_attention_bhsd(q, k, v, causal=True))
        chip_smoke.say(f"tree {tree}, {label} ({body_for(q, k, v)} body): {ms:.4f} ms")


def time_variants() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import flash_attention_bhsd

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the ablation times the kernel on the card")
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(variants(SOURCE.read_text()).items()):
        paths[name] = OUT / f"variant{i}.cu"
        paths[name].write_text(text)
    procs = []
    for name, path in paths.items():  # one nvcc per variant, all at once
        runtime.SOURCES["flash_attention"] = path
        lib = runtime.library_path("flash_attention")
        procs.append((name, lib, subprocess.Popen(
            runtime.nvcc_command("flash_attention", lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            chip_smoke.fail(f"variant {name!r} did not build:\n{log}")
    chip_smoke.say(smi())
    inputs = shape_inputs(torch, chip_smoke)
    for rnd in range(ROUNDS):
        for name, path in paths.items():
            runtime.SOURCES["flash_attention"] = path
            runtime._LIBS.pop("flash_attention", None)
            times = {label: chip_smoke.device_ms(
                lambda: flash_attention_bhsd(q, k, v, causal=True))
                for label, (q, k, v) in inputs.items()}
            chip_smoke.say(f"round {rnd} {name:>12}: " + ", ".join(
                f"{label} {t:.4f} ms" for label, t in times.items()))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", type=Path, help="checkouts to time in turns")
    parser.add_argument("--time-tree", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time_tree:
        time_tree(args.time_tree.resolve())
    elif args.trees:
        print(smi(), flush=True)
        for tree in args.trees:
            subprocess.run([sys.executable, __file__, "--time-tree", str(tree)], check=True)
    else:
        time_variants()


if __name__ == "__main__":
    main()
