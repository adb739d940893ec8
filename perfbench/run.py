"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port), one run of
one cell:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. It
prints the card's name, power limit and SM clock on standard error,
serves the cell's traffic for ``--seconds`` (``harness.py``), checks what
was served against the plain reference, prints each number compared
beside its limit as the last lines of standard error, and prints one JSON
line as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. It exits non-zero, printing no
result, without a CUDA device, or where the program (``src/repro_torch``)
is missing, or when the process holds JAX or the JAX package once the
window has closed.

Every cache it or the program builds lies inside the checkout, at a
fixed path: the kernels' shared libraries under ``build/`` (the program's
own choice), PyTorch's extension and Triton caches and the CUDA JIT
cache under ``build/perfbench-cache/``.
"""
import time

STARTED = time.monotonic()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    cache = ROOT / "build" / "perfbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench import harness, manifest, power

    chips = next((w["chips"] for w in manifest.manifest(ROOT)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        harness.log(f"BENCHMARK.json has no workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"this process sees {torch.cuda.device_count()}")
        return 3
    card = power.card()
    harness.log(f"card: {card['name']}, power limit {card['power_limit_w']} W, "
                f"SM clock {card['sm_clock_mhz']} MHz (max {card['sm_clock_max_mhz']})")
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT,
                         started=STARTED)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"the process holds {loaded}: the benchmark runs without JAX")
        return 4
    result["device"].update(power_limit_w=card["power_limit_w"],
                            sm_clock_max_mhz=card["sm_clock_max_mhz"])
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
