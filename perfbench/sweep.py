"""The knee of an open-loop cell, found once on the chip when the cell is
defined:

    python3 perfbench/sweep.py --workload <cell> --rates 1,2,3,4 [--runs 2] [--seconds 45] [--seed 7]

Sets the cell up once (weights, engine, captures, warm groups), then for
each rate serves the cell's traffic at that rate for ``--seconds``
through a fresh runtime, ``--runs`` times (the token ids drawn from
``--seed``, ``--seed`` + 1, ...; the arrival trace is the mix's own), and
reads the backlog at the window's midpoint and at its end, and the
tokens per second. The backlog is the queue: requests due and not yet
started. (Requests in service are not counted: at these rates they are
many, and they swing with the lengths drawn.) A rate is sustained where
every run's backlog at the end is no larger than at the midpoint; the
knee is the highest rate of the sweep below the first rate that is not.
One JSON line per run, then one with the knee; the cell's file takes
0.8 x knee as its rate.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated req/s, ascending")
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    _environment()
    import numpy as np
    import torch

    from perfbench import harness, instrument, manifest, program, weights

    cell = manifest.cell(args.workload, ROOT)
    spec, conf, mix = cell["spec"], cell["conf"], cell["mix"]
    params = weights.draw(conf, program.param_shapes(program.model_config(conf)), args.seed, "cuda")
    engine = program.build_engine(conf, params, spec["batch"], spec["max_len"], "cuda")
    harness._warm(engine, spec, mix, conf["vocab_size"])
    gen = manifest.generator(mix["generator"], ROOT)
    knee, failed = None, False
    for rate, run in ((float(r), k) for r in args.rates.split(",") for k in range(args.runs)):
        items = gen.generate({**mix, **spec.get("traffic", {}), "rate": rate}, args.seconds,
                             conf["vocab_size"], np.random.default_rng(args.seed + run))
        reqs = [program.request(i, it.prompt, it.max_new_tokens, it.arrival_s,
                                instrument.TimedTokens()) for i, it in enumerate(items)]
        rt = program.runtime(engine, spec["batch"], spec["concurrency"])
        for r in reqs:
            rt.submit(r)

        def backlog(at):
            return sum(r.arrival_s <= at and r.started == 0 for r in reqs)

        def in_service(at):
            return sum(r.arrival_s <= at and r.started > 0 and len(r.tokens) < r.max_new_tokens
                       for r in reqs)

        rt.start_clock()
        t0 = rt._t0
        rt.run_for(args.seconds / 2, idle_wait=True)
        mid, mid_s = backlog(args.seconds / 2), in_service(args.seconds / 2)
        rt.run_for(args.seconds / 2, idle_wait=True)
        end, end_s = backlog(args.seconds), in_service(args.seconds)
        toks = sum(sum(1 for t in r.tokens.times if t <= t0 + args.seconds) for r in reqs)
        ttft = sorted(r.tokens.times[0] - t0 - r.arrival_s for r in reqs if r.tokens.times)
        for s in rt.slots:  # abandon what is still in flight
            if s.group is not None:
                engine.release(s.entry)
        torch.cuda.synchronize()
        sustained = end <= mid
        failed = failed or not sustained
        if not failed and run == args.runs - 1:
            knee = rate
        print(json.dumps({"rate": rate, "run": run, "requests": len(reqs), "backlog_mid": mid,
                          "backlog_end": end, "in_service_mid": mid_s, "in_service_end": end_s,
                          "sustained": sustained,
                          "output_tok_s": toks / args.seconds,
                          "ttft_median_s": ttft[len(ttft) // 2] if ttft else None,
                          "ttft_p95_s": ttft[int(0.95 * (len(ttft) - 1))] if ttft else None,
                          "served": len(ttft)}), flush=True)
    print(json.dumps({"workload": args.workload, "knee": knee,
                      "rate_at_0.8": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
