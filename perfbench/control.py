"""The readings a cell's correctness limit is set from, on the chip:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... [--seconds 12]

For each seed, in one process: a run of the cell as the benchmark makes
it (``harness.run``, its window ``--seconds`` long at the cell's own
load), then, over the same sampled requests, prompts and served tokens,
the control: the plain reference in fp8 (``reference/ops.py``) put in
the program's place, whose first token at each position is judged by the
float32 reference as the program's served token is. Prints one JSON line
per seed (the program's widest gap, the control's, their mean gaps and
shares of positions off the reference's best, and each request's widest)
and a last line with the lower reading of the widest gap (the largest
the program gives) and the upper one (the smallest the control gives). The benchmark's own
runs never run the control.
"""
import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _environment()
    import numpy as np

    from perfbench import check, harness

    program_max, control_min = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        res = harness.run(args.workload, seed, args.seconds, False, root=ROOT,
                          device=args.device, keep=True)
        kept = res.pop("_kept")
        ctrl = [check.gaps(kept["ref"].logits, kept["conf"], kept["params"], r, args.device,
                           precision="fp8") for r in kept["picked"]]
        prog = kept["gaps"]
        del kept
        p_all, c_all = np.concatenate(prog), np.concatenate(ctrl)
        program_max.append(float(p_all.max()))
        control_min.append(float(c_all.max()))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {"mean": float(p_all.mean()), "max": float(p_all.max()),
                                      "off": float((p_all > 0).mean())},
                          "control": {"mean": float(c_all.mean()), "max": float(c_all.max()),
                                      "off": float((c_all > 0).mean())},
                          "program_max_by_request": [float(g.max()) for g in prog],
                          "control_max_by_request": [float(g.max()) for g in ctrl],
                          "tokens": int(p_all.size),
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "seconds": time.monotonic() - t}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": max(program_max),
                      "upper": min(control_min),
                      "ratio": min(control_min) / max(max(program_max), 1e-12)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
