"""Where the SSD scan's wgmma body spends its time, on the card.

Builds variants of ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``,
each with one choice changed or one part taken out, and times each on the
same inputs: the whole call with ``chip_smoke.device_ms``, and each of the
body's kernels with ``torch.profiler``. A variant that takes a part out
computes garbage; only its time is read. Run from the repository root on
a machine with an NVIDIA H100 (it builds with ``nvcc`` and fails without a
card):

    python3 tools/ssd_ablation.py

With ``--trees DIR [DIR ...]`` it times instead the scan as built in each
of the given checkouts (each in a process of its own, in the order given,
e.g. a parent, this tree, this tree, the parent) at every shape below,
naming the body each tree's ``body_for`` picks, with each kernel's time
from the profiler:

    python3 tools/ssd_ablation.py --trees build/parent . . build/parent

Variants:

* ``as built``: the source as it is (C·Bᵀ formed once per CTA for a group
  of ``SCAN_G = 4`` heads);
* ``G = 2``, ``G = 1``: groups of two or one heads (C·Bᵀ formed 2 or 4
  times as often). Five heads no longer build: their y tiles do not fit
  the idle rings of the N = 16 layout (and at N = 128 their accumulators
  spilled);
* ``states: no products``, ``states: no split``: the chunk states without
  their products, or without the low half of the weighted x;
  ``states: 4 stages``: a ring of four (B, x) stages in place of two
  (more loads in flight, fewer CTAs per SM);
* ``outputs: no decay``, ``no C.B^T``, ``no x products``, ``no inter``,
  ``no y store``: the outputs kernel without the decay, dt and mask
  between the products, without the C·Bᵀ products, without the products
  with x, without the entering state's term, without storing y;
* ``no dependent launch``: phases 2 and 3 launched plainly, each waiting
  for the kernel before it to finish before it is scheduled.

Shapes, bf16: the Mamba2-2.7B serving shape (B=4, S=512, NH=80, hd=64,
N=128, chunk 256), S=4096 at B=1, and the Hymba-1.5B serving shape (B=4,
S=512, NH=50, hd=64, N=16, chunk 256). Each variant is timed in turns,
``ROUNDS`` times.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
OUT = ROOT / "build" / "ssd_ablation"
ROUNDS = 2
SHAPES = {  # (B, S, NH, hd, N, chunk)
    "serving B=4": (4, 512, 80, 64, 128, 256),
    "S=4096 B=1": (1, 4096, 80, 64, 128, 256),
    "Hymba serving B=4": (4, 512, 50, 64, 16, 256),
}
PHASES = ("ssd_chunk_states", "ssd_state_passing", "ssd_chunk_outputs", "ssd_fwd_simt")


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"marker not found in {SOURCE.name}: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    group = "constexpr int SCAN_G = 4;"
    lo = "        wgmma_rs<L::BOX_COLS>(acc[cb], lo[ks], db);\n"
    hi = "        wgmma_rs<L::BOX_COLS>(acc[cb], hi[ks], db);\n"
    return {
        "as built": src,
        "G = 2": _replace(src, group, "constexpr int SCAN_G = 2;"),
        "G = 1": _replace(src, group, "constexpr int SCAN_G = 1;"),
        "states: no products": _replace(_replace(src, lo, ""), hi, ""),
        "states: no split": _replace(src, lo, ""),
        "outputs: no decay": _replace(
            src, "cb[4 * nb + e] * fast_exp2(ci[e / 2] - ck[kc]) * d[kc]", "cb[4 * nb + e]"),
        "no dependent launch": _replace(src, "constexpr int PDL = 1;", "constexpr int PDL = 0;"),
        "outputs: no C.B^T": _replace(
            src, "wgmma_n64_ss(cb, kmajor_desc<N>(base, kk), kmajor_desc<N>(wide(st), kk), kk > 0);",
            "cb[kk] = 0.f;"),
        "outputs: no x products": _replace(
            src, "wgmma_n64_rs(y[hh], pa[kk], mnmajor_desc(narrow(st), kk));", "fence_regs(pa[kk]);"),
        "outputs: no inter": _replace(
            src, "const bool carry = c > 0 || p.s0 != nullptr;", "const bool carry = false;"),
        "outputs: no y store": _replace(
            src, "tma_store4(ty, base + L::P3_WIDE_OFF + hh * BOX, 0, t0 + i0, h0 + hh, b);",
            ";"),
        "states: 4 stages": _replace(src, "constexpr int P1_STAGES = 2;", "constexpr int P1_STAGES = 4;"),
    }


def phase_times(torch, fn, reps=10):
    """Device ms per call of each of the body's kernels, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {name: sum(e.self_device_time_total for e in kern if name in e.key) / 1e3 / reps
            for name in PHASES}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_tree(tree: Path) -> None:
    """The scan as built in ``tree``, at every shape (the timing helpers
    are this checkout's)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ssd_scan import body_for

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the ablation times the kernel on the card")
    for label, (b, s, nh, hd, n, chunk) in SHAPES.items():
        args, _ = chip_smoke.ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, False, seed=0)
        body = body_for(args[0], args[3], args[4], chunk)
        ms = chip_smoke.device_ms(lambda: ssd_scan(*args, chunk=chunk))
        per = phase_times(torch, lambda: ssd_scan(*args, chunk=chunk))
        chip_smoke.say(f"tree {tree}, {label} ({body} body): {ms:.4f} ms; per kernel " + ", ".join(
            f"{k} {t:.4f}" for k, t in per.items() if t > 0))


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


def time_variants() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import runtime
    from repro_torch.kernels.ssd_scan import ssd_scan

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the ablation times the kernel on the card")
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(variants(SOURCE.read_text()).items()):
        paths[name] = OUT / f"variant{i}.cu"
        paths[name].write_text(text)
    procs = []
    for name, path in paths.items():  # one nvcc per variant, all at once
        runtime.SOURCES["ssd_scan"] = path
        lib = runtime.library_path("ssd_scan")
        procs.append((name, lib, subprocess.Popen(
            runtime.nvcc_command("ssd_scan", lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            chip_smoke.fail(f"variant {name!r} did not build:\n{log}")
    chip_smoke.say(smi())
    inputs = {}
    for label, (b, s, nh, hd, n, chunk) in SHAPES.items():
        args, _ = chip_smoke.ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, False, seed=0)
        inputs[label] = (args, chunk)
    for rnd in range(ROUNDS):
        for name, path in paths.items():
            runtime.SOURCES["ssd_scan"] = path
            runtime._LIBS.pop("ssd_scan", None)
            for label, (args, chunk) in inputs.items():
                ms = chip_smoke.device_ms(lambda: ssd_scan(*args, chunk=chunk))
                per = phase_times(torch, lambda: ssd_scan(*args, chunk=chunk))
                chip_smoke.say(f"round {rnd} {name:>22}, {label}: {ms:.4f} ms; per kernel " + ", ".join(
                    f"{k} {t:.4f}" for k, t in per.items() if t > 0))


if __name__ == "__main__":
    main()
