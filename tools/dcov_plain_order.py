"""The plain single-block dcov Gram (``kernels/dcov/ref.py::dcov_gram_ref``)
against its own float64 version, and its time, on noise-free CORAL
landscapes: cells 6 and 9's product sub-grids (216 rows, as
``tests/test_torch_dcov.py`` takes them) and their full grids (1440 rows),
then the worst over the full grids of all 54 static cells. For each it
prints the largest error of the normalised float32 Gram (dCor² before the
root) over every pair, the largest dCor error where the float64 dCor is at
least 1e-2, and the median time of one float32 call.

Run from the repository root, on the CPU (the default) or on the card:

    PYTHONPATH=src python3 tools/dcov_plain_order.py [--device cuda]

With ``--trees DIR [DIR ...]`` it runs instead in each of the given
checkouts, each in a process of its own and in the order given (e.g. a
parent unpacked under ``build/``, this tree, this tree, the parent):

    python3 tools/dcov_plain_order.py --trees build/parent . . build/parent
"""
from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time
from pathlib import Path

REPS = 5
DCOR_FLOOR = 1e-2


def cell_columns(cell_index, full):
    """(n, 7) float32 knobs, tau and p of one cell's noise-free landscape."""
    import numpy as np

    from repro_torch.experiments import scenarios

    cell = scenarios.enumerate_cells(workloads=scenarios.FULL_MATRIX_WORKLOADS)[cell_index]
    sim0 = scenarios.cell_simulator(cell, noise=0.0)
    if full:
        grid = sim0.space.grid().astype(np.float64)
    else:
        levels = [d.values[::2] if len(d.values) > 3 else d.values for d in sim0.space.dims]
        grid = np.asarray(list(itertools.product(*levels)), np.float64)
    land = np.stack(sim0.exact_all(grid), axis=1)
    return np.concatenate([grid, land], axis=1).astype(np.float32)


def errors(cols, device):
    """(normalised-Gram error, dCor error, median seconds of a float32 call)."""
    import torch

    from repro_torch.kernels.dcov.ref import dcor_from_sums, dcov_gram_ref

    x = torch.from_numpy(cols).to(device)

    def norm(g):
        g = g.double().cpu()
        d = torch.sqrt(torch.diagonal(g).clamp_min(0.0))
        return g / (d[:, None] * d[None, :])

    def dcor(g, k=5):
        g = g.double().cpu()
        diag = torch.diagonal(g)
        return dcor_from_sums(g[:k, k:], diag[:k, None], diag[None, k:])

    g64 = dcov_gram_ref(x, dtype=torch.float64)
    times = []
    for _ in range(REPS):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        g32 = dcov_gram_ref(x)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    want = dcor(g64)
    big = want >= DCOR_FLOOR
    return ((norm(g32) - norm(g64)).abs().max().item(),
            (dcor(g32) - want)[big].abs().max().item(), sorted(times)[REPS // 2])


def run(device):
    import torch

    threads = torch.get_num_threads() if device == "cpu" else None
    where = (torch.cuda.get_device_name(0) if device == "cuda"
             else f"CPU, {threads} torch threads")
    print(f"plain single-block Gram on {where}, torch {torch.__version__}")
    for cell in (6, 9):
        for full in (False, True):
            cols = cell_columns(cell, full)
            ne, de, sec = errors(cols, device)
            print(f"  cell {cell}, {'full grid' if full else 'sub-grid'} (n = {len(cols)}): "
                  f"normalised Gram {ne:.3g}, dCor {de:.3g} (float64 dCor >= {DCOR_FLOOR}), "
                  f"{sec:.4f} s a call")
    worst = [0.0, 0.0, 0.0]
    for cell in range(54):
        worst = [max(a, b) for a, b in zip(worst, errors(cell_columns(cell, True), device))]
    print(f"  worst over the 54 full grids: normalised Gram {worst[0]:.3g}, dCor "
          f"{worst[1]:.3g}, slowest median call {worst[2]:.4f} s")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    parser.add_argument("--trees", nargs="+", type=Path, help="checkouts to run in turns")
    args = parser.parse_args()
    if not args.trees:
        run(args.device)
        return
    for tree in args.trees:
        print(f"== {tree}", flush=True)
        env = dict(os.environ, PYTHONPATH=str(tree.resolve() / "src"))
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--device", args.device],
                       env=env, check=True)


if __name__ == "__main__":
    main()
