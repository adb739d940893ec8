"""CORAL as a deployment tool (the counterpart of
``repro/launch/tune.py``): given an (arch × input shape × mesh) whose
roofline terms come from the dry run's artifact, find the pod
configuration (clock levels, host cores, concurrency) that meets a
throughput target within a power budget, on the TPU pod twin that
``core.space.tpu_pod_space`` and ``device.DeviceSimulator`` model. CORAL's
windowed dCor runs through the port's dcov kernel on the card
(``device="cuda"``, the default) or its plain version (``device="cpu"``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen2.5-3b \\
      --shape decode_32k --tau-frac 0.6 --power-frac 0.8
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.core import run_coral, tpu_pod_space
from repro_torch.core.baselines import alert, alert_online, oracle, preset
from repro_torch.device import DeviceSimulator, RooflineTerms


def terms_from_artifact(
    arch: str, shape: str, mesh: str = "16x16",
    dryrun_dir: str = "experiments/dryrun",
) -> Optional[RooflineTerms]:
    fn = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(fn):
        return None
    with open(fn) as f:
        rec = json.load(f)
    r = rec["roofline"]
    return RooflineTerms(
        t_compute=r["t_compute"],
        t_memory=r["t_memory"],
        t_collective=r["t_collective"],
        t_host=2.0e-3,
        items_per_step=float(rec.get("global_batch", 1) or 1),
        n_chips=r["n_chips"],
    )


def tune(
    arch: str,
    shape: str,
    tau_frac: float = 0.6,
    power_frac: float = 0.8,
    iters: int = 10,
    seed: int = 0,
    dryrun_dir: str = "experiments/dryrun",
    verbose: bool = True,
    device="cuda",
):
    space = tpu_pod_space()
    terms = terms_from_artifact(arch, shape, dryrun_dir=dryrun_dir)
    if terms is None:
        raise FileNotFoundError(
            f"no dry-run artifact for {arch}×{shape}; run repro_torch.launch.dryrun first"
        )
    dev_exact = DeviceSimulator(space, terms, noise=0.0)
    orc_max = oracle(space, dev_exact, tau_target=0.0)
    tau_target = orc_max.tau * tau_frac
    # budget relative to the max-power preset (τ-max configs can tie at low
    # power on collective-bound workloads, which would make 0.8× infeasible)
    p_budget = dev_exact.exact(space.preset("max_power"))[1] * power_frac
    orc = oracle(space, dev_exact, tau_target, p_budget)

    out, trace = run_coral(
        space, DeviceSimulator(space, terms, seed=seed), tau_target, p_budget,
        iters=iters, seed=seed, device=device,
    )
    result = {
        "arch": arch,
        "shape": shape,
        "tau_target": tau_target,
        "p_budget_kw": p_budget / 1e3,
        "coral": {
            "config": out.config,
            "tau": out.tau,
            "power_kw": out.power / 1e3,
            "feasible": out.feasible(tau_target, p_budget),
            "measurements": iters,
        },
        "oracle": {
            "config": orc.config,
            "tau": orc.tau,
            "power_kw": orc.power / 1e3,
            "measurements": orc.measurements,
        },
    }
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--tau-frac", type=float, default=0.6)
    ap.add_argument("--power-frac", type=float, default=0.8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baselines", action="store_true")
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = tune(args.arch, args.shape, args.tau_frac, args.power_frac,
               args.iters, args.seed, dryrun_dir=args.dir, device=args.device)
    if args.baselines:
        space = tpu_pod_space()
        terms = terms_from_artifact(args.arch, args.shape, dryrun_dir=args.dir)
        tau_t, p_b = res["tau_target"], res["p_budget_kw"] * 1e3
        for name, fn in (
            ("ALERT", lambda d: alert(space, d, tau_t, p_b)),
            ("ALERT-Online", lambda d: alert_online(space, d, tau_t, p_b)),
            ("max-power", lambda d: preset(space, d, "max_power")),
            ("default", lambda d: preset(space, d, "default")),
        ):
            o = fn(DeviceSimulator(space, terms, seed=args.seed + 1))
            print(
                f"{name:14s} tau={o.tau:10.1f} p={o.power/1e3:7.2f}kW "
                f"feasible={o.feasible(tau_t, p_b)} measurements={o.measurements}"
            )


if __name__ == "__main__":
    main()
