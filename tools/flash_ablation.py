"""Where the flash kernel's wgmma body spends its time, on the card.

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``, each with one part of the key loop taken out, and
times each on the same inputs with ``chip_smoke.device_ms``. A variant
computes garbage; only its time is read. Run from the repository root on
a machine with an NVIDIA H100 (it builds with ``nvcc`` and fails without
a card):

    python3 tools/flash_ablation.py

Variants:

* ``as built``: the source as it is;
* ``no softmax``: no mask, no online softmax, no rescale of O (P is S);
* ``no products``: neither S = Q K^T nor O += P V is issued (S = 0);
* ``two stages``: a K/V ring of two stages at D = 128, not three.

Shapes, bf16, causal: the Qwen2.5-3B serving shape (B=4, Hq=16, Hkv=2,
S=512, D=128), the same at B=1 (one wave of CTAs), and S=4096 at B=1.
Each variant is timed in turns, ``ROUNDS`` times.
"""
from __future__ import annotations

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
        "two stages": _replace(src, "STAGES = D == 128 ? 3 : 4;", "STAGES = D == 128 ? 2 : 4;"),
    }


def main() -> None:
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    chip_smoke.say(smi.stdout.strip())
    inputs = {label: chip_smoke.attention_inputs(torch, torch.bfloat16, *shape, seed=0)
              for label, shape in SHAPES.items()}
    for rnd in range(ROUNDS):
        for name, path in paths.items():
            runtime.SOURCES["flash_attention"] = path
            runtime._LIBS.pop("flash_attention", None)
            times = {label: chip_smoke.device_ms(
                lambda: flash_attention_bhsd(q, k, v, causal=True))
                for label, (q, k, v) in inputs.items()}
            chip_smoke.say(f"round {rnd} {name:>12}: " + ", ".join(
                f"{label} {t:.4f} ms" for label, t in times.items()))


if __name__ == "__main__":
    main()
