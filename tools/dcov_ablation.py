"""Where the dcov kernel's single-block form spends its time, on the card.

Builds variants of ``src/repro_torch/kernels/dcov/csrc/dcov.cu``, each with
one choice changed or one part taken out, and times each on the same
inputs: the whole call with ``chip_smoke.device_ms``, and each of the
form's two kernels with ``torch.profiler``. A variant that takes a part
out computes garbage; only its time is read. Run from the repository root
on a machine with an NVIDIA H100 (it builds with ``nvcc`` and fails
without a card):

    python3 tools/dcov_ablation.py

Variants:

* ``as built``: the source as it is;
* ``row sums alone``: the row-sum pass without the Gram pass after it;
* ``gram: no products``: the Gram pass with each pair's centred values
  summed in place of their C(C+1)/2 products;
* ``no final reduction``: the Gram pass without the last CTA's sum of the
  per-CTA partials (nor its ticket);
* ``final: ticket only``: every CTA takes its ticket, but the last one
  does not add the partials; ``final: float32 sums``: the last CTA's own
  sums and shuffles in float32;
* ``no dependent launch``: the Gram pass launched plainly, scheduled only
  once the row-sum pass has finished;
* ``f64 accumulators``: the Gram pass's accumulators and per-CTA partials
  in float64;
* ``2 CTAs per SM``: a persistent Gram grid of 2 x 132 CTAs, not 4 x 132;
* ``3 CTAs per SM, 168 registers``: a Gram grid of 3 x 132 CTAs whose
  threads may take 168 registers, not 128;
* ``row sums: 4 CTAs per SM``: row-sum tiles of fewer rows, so that the
  pass has at least 4 x 132 CTAs where it can, not 2 x 132.

Shapes, float32: n = 1600, C = 7 (a CORAL landscape) and n = 16384, C = 8.
Each variant is timed in turns, ``ROUNDS`` times.

With ``--trees DIR [DIR ...]`` it times instead the single-block form as
built in each of the given checkouts (each in a process of its own, in
the order given, e.g. a parent, this tree, this tree, the parent), with
every kernel of that tree's form listed by the profiler, and the SM
clock and power draw that ``nvidia-smi`` reads under load:

    python3 tools/dcov_ablation.py --trees build/parent . . build/parent
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the timing helpers)

SOURCE = ROOT / "src/repro_torch/kernels/dcov/csrc/dcov.cu"
OUT = ROOT / "build" / "dcov_ablation"
ROUNDS = 2
SHAPES = ((1600, 7), (16384, 8))  # (n, C)


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise ValueError(f"marker not found {count} time(s) in {SOURCE.name}: {old!r}")
    return src.replace(old, new)


def _apply(src: str, *edits) -> str:
    for edit in edits:
        src = _replace(src, *edit)
    return src


# the Gram pass's accumulators, partials and their slots in float64
F64_ACCUMULATORS = (
    ("float (&acc)[C * (C + 1) / 2]", "double (&acc)[C * (C + 1) / 2]", 2),
    ("acc[q] = fmaf(ac, a[d], acc[q]);",
     "acc[q] = fma(static_cast<double>(ac), static_cast<double>(a[d]), acc[q]);"),
    ("  float acc[NP];", "  double acc[NP];"),
    ("float* __restrict__ partial", "double* __restrict__ partial"),
    ("  float* partial = reinterpret_cast<float*>(scratch + p.partial_off);",
     "  double* partial = reinterpret_cast<double*>(scratch + p.partial_off);"),
    ("sizeof(float) * p.grid * NPAIR", "sizeof(double) * p.grid * NPAIR"),
    ("    float v = static_cast<float>(wred[0][tid]);\n"
     "    for (int w = 1; w < NW; ++w) v += static_cast<float>(wred[w][tid]);",
     "    double v = wred[0][tid];\n    for (int w = 1; w < NW; ++w) v += wred[w][tid];"),
)
TICKET = "  if (tid == 0) {  // the CTA's partial is visible before its ticket"


def variants(src: str) -> dict:
    return {
        "as built": src,
        "row sums alone": _replace(
            src, "  err = cudaGetLastError();\n  if (err != cudaSuccess) return err;\n",
            "  return cudaGetLastError();  // pass 2 not launched\n"),
        "gram: no products": _replace(
            src, "  accumulate<C>(a, half, acc);",
            "  for (int c = 0; c < C; ++c) acc[c] += a[c];"),
        "no final reduction": _replace(src, TICKET, "  return;\n" + TICKET),
        "final: ticket only": _replace(src, "  if (!last) return;", "  return;"),
        "final: float32 sums": _apply(
            src, ("  double s[NP];", "  float s[NP];"),
            ("static_cast<double>(__ldcg(partial", "(__ldcg(partial")),
        "no dependent launch": _replace(
            src, "programmaticStreamSerializationAllowed = 1;",
            "programmaticStreamSerializationAllowed = 0;"),
        "f64 accumulators": _apply(src, *F64_ACCUMULATORS),
        "2 CTAs per SM": _replace(
            src, "constexpr int GRID_CAP = 4 * 132;", "constexpr int GRID_CAP = 2 * 132;"),
        "3 CTAs per SM, 168 registers": _apply(
            src, ("constexpr int GRID_CAP = 4 * 132;", "constexpr int GRID_CAP = 3 * 132;"),
            ("__launch_bounds__(GT, 4)", "__launch_bounds__(GT, 3)")),
        "row sums: 4 CTAs per SM": _replace(
            src, "constexpr int RS_MIN_CTAS = 2 * 132;", "constexpr int RS_MIN_CTAS = 4 * 132;"),
    }


def per_kernel(torch, fn) -> str:
    """Each dcov kernel's device ms per call of ``fn``, from the profiler."""
    times = chip_smoke.kernel_times(torch, fn, ("dcov_",))
    if times is None:
        return "not measured (no profiled window recorded every launch)"
    return ", ".join(f"{k} {t:.4f}" for k, t in times.items())


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_tree(tree: Path) -> None:
    """The single-block form as built in ``tree``, at every shape (the
    timing helpers are this checkout's)."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels.dcov import dcov_gram

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the ablation times the kernel on the card")
    for n, c in SHAPES:
        x = chip_smoke.dcov_block_inputs(torch, n, c, seed=n + c)
        ms = chip_smoke.device_ms(lambda: dcov_gram(x))
        chip_smoke.say(f"tree {tree}, (n, C)=({n}, {c}): {ms:.4f} ms; per kernel "
                       f"{per_kernel(torch, lambda: dcov_gram(x))}; under load: "
                       f"{busy_clocks(torch, lambda: dcov_gram(x), ms)}")


def busy_clocks(torch, fn, ms, seconds=1.0):
    """The SM clock, its maximum and the power draw that ``nvidia-smi``
    reads while about ``seconds`` of back-to-back calls of ``fn`` run."""
    for _ in range(max(1, int(seconds * 1e3 / ms))):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return out.stdout.strip()


def time_variants() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import runtime
    from repro_torch.kernels.dcov import dcov_gram

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the ablation times the kernel on the card")
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(variants(SOURCE.read_text()).items()):
        paths[name] = OUT / f"variant{i}.cu"
        paths[name].write_text(text)
    procs = []
    for name, path in paths.items():  # one nvcc per variant, all at once
        runtime.SOURCES["dcov"] = path
        lib = runtime.library_path("dcov")
        procs.append((name, subprocess.Popen(
            runtime.nvcc_command("dcov", lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            chip_smoke.fail(f"variant {name!r} did not build:\n{log}")
        if name == "as built":
            for kernel in ("rowsum", "gram"):
                for c in (7, 8):
                    for line in chip_smoke.ptxas_report(log, f"dcov_{kernel}_kernelILi{c}E"):
                        chip_smoke.say(f"  {name}: {line}")
    chip_smoke.say(smi())
    xs = {(n, c): chip_smoke.dcov_block_inputs(torch, n, c, seed=n + c) for n, c in SHAPES}
    for rnd in range(ROUNDS):
        for name, path in paths.items():
            runtime.SOURCES["dcov"] = path
            runtime._LIBS.pop("dcov", None)
            for (n, c), x in xs.items():
                ms = chip_smoke.device_ms(lambda: dcov_gram(x))
                chip_smoke.say(f"round {rnd} {name:>28}, (n, C)=({n}, {c}): {ms:.4f} ms; per "
                               f"kernel {per_kernel(torch, lambda: dcov_gram(x))}")


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
