#!/usr/bin/env python3
"""Time the batched CORAL engine's calls on the card, in one checkout or
in several in turns:

    python3 tools/coral_engine_times.py
    python3 tools/coral_engine_times.py --trees build/parent . . build/parent

Each tree runs in its own process with that tree's ``src`` first on the
path: the batched static call over the 54-cell grid x 3 seeds (162
episodes x 10 steps), and, where the tree has the drift and fault step
kinds, the batched drift call (the 6 drift cells x 3 seeds x {adaptive,
static}, 64 steps) and the batched fault call (the 6 fault cells x 3
seeds x {hardened, ablation}, 40 steps), and, where the tree has the
offload and cotenant cells, their batched calls (static episodes on the
joint grids: the 4 offload cells x 3 seeds, 24 steps; the 4 cotenant
cells x 3 seeds, 40 steps), and, where the tree has the fleet, its cold
call (the 1024 twins of ``BENCH_fleet.json``, 30 steps, window 12). A
call ends with the host
reading its results, so the host clock around it is its wall time. Each
call is warmed up once, then timed ``REPS`` times; the median and the
spread (min, max) are printed in ms, beside the card's name and power
limit. Compare trees only within one run.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 9
SEEDS = (0, 1, 2)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def timed(torch, fn) -> str:
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return f"median {statistics.median(ms):.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}, {REPS} calls)"


def time_tree(tree: Path) -> None:
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch

    from repro_torch.core import episode
    from repro_torch.experiments import matrix, scenarios

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the engine's times are the card's")
    grid = scenarios.enumerate_cells(workloads=scenarios.FULL_MATRIX_WORKLOADS)
    reqs = [r for c in grid for r in matrix._static_requests(matrix._prep_cell(c), SEEDS)]
    print(f"{tree}: static call, {len(reqs)} episodes x 10 steps: "
          + timed(torch, lambda: episode.run_static_requests(reqs, device="cuda")), flush=True)
    if not hasattr(episode, "run_drift_requests"):
        print(f"{tree}: no drift or fault step kinds", flush=True)
        return
    steps = scenarios.DRIFT_INTERVALS
    reqs = [r for c in scenarios.MATRIX_DRIFT_CELLS for a in (True, False)
            for r in matrix._drift_requests(matrix._prep_drift_cell(c, steps), SEEDS, a)]
    print(f"{tree}: drift call, {len(reqs)} episodes x {steps} steps: " + timed(
        torch, lambda: episode.run_drift_requests(reqs, intervals=steps, device="cuda")),
        flush=True)
    steps = scenarios.FAULT_INTERVALS
    reqs = [r for c in scenarios.MATRIX_FAULT_CELLS for h in (True, False)
            for r in matrix._fault_requests(matrix._prep_fault_cell(c, steps, SEEDS), SEEDS, h)]
    print(f"{tree}: fault call, {len(reqs)} episodes x {steps} steps: " + timed(
        torch, lambda: episode.run_fault_requests(reqs, iters=steps, device="cuda")), flush=True)
    if not hasattr(matrix, "run_offload_cell"):
        print(f"{tree}: no offload or cotenant cells", flush=True)
        return
    for family, cells, prep, steps in (
        ("offload", scenarios.MATRIX_OFFLOAD_CELLS, matrix._prep_offload_cell,
         matrix.OFFLOAD_ITERS),
        ("cotenant", scenarios.MATRIX_COTENANT_CELLS, matrix._prep_cotenant_cell,
         matrix.COTENANT_ITERS),
    ):
        reqs = [r for c in cells for r in matrix._static_requests(prep(c), SEEDS)]
        print(f"{tree}: {family} call, {len(reqs)} episodes x {steps} steps: " + timed(
            torch, lambda: episode.run_static_requests(reqs, iters=steps, device="cuda")),
            flush=True)
    if not hasattr(episode, "run_fleet_requests"):
        print(f"{tree}: no fleet", flush=True)
        return
    from repro_torch.experiments import fleet

    reqs = [fleet._request(t) for t in fleet.build_fleet(1024, seed=0)]
    print(f"{tree}: fleet cold call, {len(reqs)} twins x 30 steps: " + timed(
        torch, lambda: episode.run_fleet_requests(reqs, 30, 12, device="cuda")), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", type=Path, default=[Path(".")],
                        help="checkouts to time in turns (default: this one)")
    parser.add_argument("--time-tree", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time_tree:
        time_tree(args.time_tree)
        return
    print(smi(), flush=True)
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--time-tree", str(tree)], check=True)


if __name__ == "__main__":
    main()
