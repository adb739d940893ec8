"""Render the dry-run and roofline markdown tables from the artifacts in
``experiments/dryrun/`` (the counterpart of ``repro/launch/report.py``;
either package's artifacts render the same).

  PYTHONPATH=src python -m repro_torch.launch.report [--mesh 16x16] [--table dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dryrun_dir: str, mesh: str):
    recs = []
    for fn in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b: float) -> str:
    return f"{b/2**30:.2f}"


def model_flops_ratio(r: dict) -> float:
    """MODEL_FLOPS (6·N_active·D train / 2·N_active·D fwd) over counted FLOPs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES

    cfg = get_config(r["arch"])
    shp = SHAPES[r["shape"]]
    n = cfg.n_active_params()
    if shp.kind == "train":
        mf = 6.0 * n * shp.global_batch * shp.seq_len
    elif shp.kind == "prefill":
        mf = 2.0 * n * shp.global_batch * shp.seq_len
    else:
        mf = 2.0 * n * shp.global_batch
    hlo = r["roofline"]["flops_per_chip"] * r["n_chips"]
    return mf / hlo if hlo else 0.0


SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant | "
        "MODEL_FLOPS/HLO | peak GiB/dev |",
        "|------|-------|-----------:|----------:|-----------:|----------|"
        "----------------:|-------------:|",
    ]
    recs = sorted(recs, key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    for r in recs:
        rf = r["roofline"]
        ratio = r.get("model_flops_ratio") or model_flops_ratio(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute']:.4f} | "
            f"{rf['t_memory']:.3f} | {rf['t_collective']:.3f} | "
            f"{rf['dominant']} | {ratio:.2f} | "
            f"{fmt_bytes(r['memory']['peak_bytes'])} |"
        )
    return "\n".join(lines)


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | compile s | FLOPs/chip | bytes/chip | "
        "AG | AR | RS | A2A | CP |",
        "|------|-------|------|----------:|-----------:|-----------:|"
        "---:|---:|---:|----:|---:|",
    ]
    recs = sorted(recs, key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    for r in recs:
        rf = r["roofline"]
        c = rf["collective_per_chip"]

        def gb(x):
            return f"{x/2**30:.2f}"

        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_seconds']} | {rf['flops_per_chip']:.2e} | "
            f"{rf['bytes_per_chip']:.2e} | {gb(c['all-gather'])} | "
            f"{gb(c['all-reduce'])} | {gb(c['reduce-scatter'])} | "
            f"{gb(c['all-to-all'])} | {gb(c['collective-permute'])} |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--table", default="roofline", choices=("roofline", "dryrun"))
    args = ap.parse_args(argv)
    recs = load(args.dir, args.mesh)
    print(f"{len(recs)} artifacts for mesh {args.mesh}\n")
    if args.table == "roofline":
        print(roofline_table(recs))
    else:
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
