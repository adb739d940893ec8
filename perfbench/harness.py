"""One run of one cell: make the inputs from the seed, set up, warm, serve
the window, serve on for the grace period, read the metrics, check what
was served, and return the result line.

The timed path is ``ServingRuntime.run_for(seconds, idle_wait=True)`` of
a runtime built fresh over the warmed ``ServingEngine``, so that the
runtime's clock starts with the window. Every request carries its due
time (``arrival_s``) and a :class:`instrument.TimedTokens` list. The
window ends at ``seconds``: throughput counts the tokens stamped inside
it. An open-loop cell then serves on until every request due inside the
window has finished or the cell's ``grace_s`` has passed; its latencies
are taken over all of those requests, an unfinished one as +inf.

Set-up (``setup_s``) runs from the process's start to the window's:
imports, the kernels' build or load, the weights drawn on the device,
the engine, its ``concurrency`` pool entries and their graph captures,
and one warm group per prompt length of the cell at the full batch,
served through a runtime of its own.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from perfbench import check, instrument, manifest, program, stats, weights
from perfbench.power import PowerSampler
from perfbench.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 4
INF_REPORTED = 1e9  # a tail that lands on an unfinished request


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (the process's loaded modules by
    default) that the benchmark's process must not hold, compared whole
    (``repro_torch`` is not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Obs:
    """What a per-layer metric's reader may read of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def in_window(self, recs):
        return [r for r in recs if self.t0 <= r["t"] <= self.t_end]


def _warm(engine, spec: dict, mix: dict, vocab: int) -> None:
    """One group of ``batch`` requests per prompt length of the cell, two
    tokens each, through a runtime of its own: every prefill shape the
    window uses, the decode replays, the host's retire."""
    rt = program.runtime(engine, spec["batch"], spec["concurrency"])
    rng = np.random.default_rng(0)
    rid = -1
    for s in mix["prompt_lens"]:
        for _ in range(spec["batch"]):
            rt.submit(program.request(rid, rng.integers(0, vocab, int(s), dtype=np.int32), 2,
                                      None, instrument.TimedTokens()))
            rid -= 1
    rt.drain()


def _latencies(obs: Obs, over: str):
    """(TTFT s, TPOT s) samples over the cell's requests: for ``due``, every
    request due in the window (unfinished: inf); for ``window``, every
    request that served two tokens or more inside the window, over those."""
    ttft, tpot = [], []
    for r in obs.requests:
        times = r.tokens.times
        if over == "due":
            if r.arrival_s >= obs.seconds:
                continue
            due = obs.t0 + r.arrival_s
            ttft.append(times[0] - due if times else math.inf)
            if r.max_new_tokens >= 2:
                done = len(times) == r.max_new_tokens
                tpot.append((times[-1] - times[0]) / (len(times) - 1) if done else math.inf)
        else:
            inside = [t for t in times if obs.t0 <= t <= obs.t_end]
            if len(inside) >= 2:
                tpot.append((inside[-1] - inside[0]) / (len(inside) - 1))
    return ttft, tpot


def end_to_end(obs: Obs, names: List[str], strict: bool = True) -> dict:
    """The cell's end-to-end metrics by name (the part of a name before its
    first dot says what is measured; ``output_tok_s.open_loop`` is
    ``output_tok_s`` in the open-loop cells, with a bound of its own).
    With ``strict`` (on the card) a metric not measured raises, else (the
    CPU tests, which have no power reading) it is left out."""
    tokens = sum(sum(1 for t in r.tokens.times if obs.t0 <= t <= obs.t_end)
                 for r in obs.requests)
    ttft, tpot = _latencies(obs, obs.spec["latency_over"])
    values = {"setup_s": (obs.setup_s, "s"), "output_tok_s": (tokens / obs.seconds, "tokens/s")}
    for q in (50, 90, 95, 99):
        if ttft:
            values[f"ttft_p{q}_s"] = (stats.percentile(ttft, q), "s")
        if tpot:
            values[f"tpot_p{q}_ms"] = (stats.percentile(tpot, q) * 1e3, "ms")
    log("latency over " + obs.spec["latency_over"] + f" requests ({len(ttft)} TTFT, {len(tpot)} "
        "TPOT samples): " + ", ".join(f"{k} {v[0]:.6g}" for k, v in values.items()
                                      if k.startswith(("ttft", "tpot"))))
    if obs.power is not None and tokens:
        e = obs.power.energy_j(obs.t0, obs.t_end)
        if e is not None:
            values["j_per_token"] = (e / tokens, "J/token")
            log(f"card power over the window: {e / obs.seconds:.6g} W mean")
    out = {}
    for n in names:
        base = n.split(".")[0]
        if base not in values:
            if not strict:
                continue
            raise RuntimeError(f"end-to-end metric {n} was not measured in this run")
        v, unit = values[base]
        out[n] = {"value": INF_REPORTED if math.isinf(v) else v, "unit": unit}
    return out


def run(name: str, seed: int, seconds: float, trace: bool, *, root: Path = manifest.ROOT,
        device: str = "cuda", started: Optional[float] = None,
        fault: Optional[Callable] = None, keep: bool = False) -> dict:
    """The result line of one run of cell ``name`` (module note). ``fault``
    (tests only) is called with the engine and the window's runtime before
    the window opens, to break the timed path underneath."""
    started = time.monotonic() if started is None else started
    cell = manifest.cell(name, root)
    spec, conf, mix = cell["spec"], cell["conf"], cell["mix"]
    on_card = torch.device(device).type == "cuda"
    if on_card:  # one process with few host threads beside the card
        torch.set_num_threads(HOST_THREADS)
    cfg = program.model_config(conf)
    params = weights.draw(conf, program.param_shapes(cfg), seed, device)
    engine = program.build_engine(conf, params, spec["batch"], spec["max_len"], device)
    vocab = conf["vocab_size"]
    gen = manifest.generator(mix["generator"], root)
    items = gen.generate({**mix, **spec.get("traffic", {})}, seconds, vocab,
                         np.random.default_rng(int(seed)))
    _warm(engine, spec, mix, vocab)
    power = tracer = None
    if on_card:
        torch.cuda.synchronize()
        if trace:
            Trace.warm(torch)
            tracer = Trace(torch)
        power = PowerSampler()
        power.start()
    requests = []
    for i, it in enumerate(items):
        r = program.request(i, it.prompt, it.max_new_tokens, it.arrival_s,
                            instrument.TimedTokens())
        requests.append(r)
    rt = program.runtime(engine, spec["batch"], spec["concurrency"])
    for r in requests:
        rt.submit(r)
    inst = None
    if trace:
        inst = instrument.Instrument(torch, engine, rt.ring(), tracer, spec.get("trace_after_s", 0.0),
                                     spec.get("trace_s", 0.0), spec.get("trace_on_prefill", False))
    if fault is not None:
        fault(engine, rt)
    if power is not None:  # the sampler reads before the window opens
        power.wait_past(time.monotonic())
    setup_s = time.monotonic() - started
    rt.start_clock()
    t0 = rt._t0
    if inst is not None:
        inst.t0 = t0
    rt.run_for(seconds, idle_wait=True)
    t_end = t0 + seconds
    if power is not None:  # and after it closes
        power.wait_past(t_end)
    if tracer is not None and tracer.running:
        tracer.stop()
    due = [r for r in requests if r.arrival_s < seconds] if spec["latency_over"] == "due" else []
    grace_end = time.monotonic() + spec.get("grace_s", 0.0)
    while due and any(len(r.tokens) < r.max_new_tokens for r in due) and time.monotonic() < grace_end:
        rt.run_for(0.1, idle_wait=True)
    if on_card:
        torch.cuda.synchronize()
        power.stop()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    if inst is not None:
        inst.device_seconds()
        inst.remove()
    summary = tracer.summary() if tracer is not None else None
    if summary is not None:
        pre = [sp for sp in summary["spans"] if sp["name"] == "perfbench.prefill"]
        log(f"trace: {summary['window_s']:.6g} s on the device's clock "
            f"({summary['host_window_s']:.6g} s on the host's), busy {summary['busy_s']:.6g} s, "
            f"{sum(k['count'] for k in summary['kernels'].values())} device records, "
            f"{len(pre)} prefill spans holding "
            f"{[sum(k[0] for k in sp['kernels'].values()) for sp in pre]} records; "
            f"{summary['spans_lost']} earlier spans lost records and were dropped")
    obs = Obs(spec=spec, conf=conf, seconds=seconds, t0=t0, t_end=t_end, setup_s=setup_s,
              requests=requests, power=power, batch=spec["batch"],
              prefills=inst.prefills if inst else [], decodes=inst.decodes if inst else [],
              retires=inst.retires if inst else [],
              trace=summary)
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = manifest.reader(m["name"], root).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end(obs, [m["name"] for m in cell["end_to_end"]], strict=on_card)
    # free the program's state before the reference runs: its caches,
    # graphs and pool; the weights stay, they are the reference's too
    unfinished = sum(len(r.tokens) < r.max_new_tokens for r in due)
    started_reqs = sum(r.started > 0 for r in requests)
    done = [r for r in requests if len(r.tokens) == r.max_new_tokens]
    del rt, engine, inst
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = manifest.reference(conf["family"], root)
    picked = check.sample(done, seed, spec["sample_tokens"], spec["sample_requests"])
    per_req = [check.gaps(ref.logits, conf, params, r, device) for r in picked]
    gaps = np.concatenate(per_req) if per_req else np.full(1, math.inf)
    limit = spec["limits"]["widest_logit_gap"]
    widest = float(gaps.max())
    log(f"served tokens compared: {gaps.size}; mean gap {float(gaps.mean())}, "
        f"share of positions off the reference's best {float((gaps > 0).mean())}")
    checks = {"widest_logit_gap": {"value": widest, "limit": limit}}
    if spec["latency_over"] == "due":
        checks["unfinished"] = {"value": unfinished, "limit": 0}
    correct = bool(per_req) and widest <= limit and unfinished == 0
    result = {
        "correct": correct,
        "attempted": len(due) if spec["latency_over"] == "due" else started_reqs,
        # the requests that never finished, and the compared ones with a
        # served token further below the reference's best than the limit
        "failed": unfinished + sum(float(g.max()) > limit for g in per_req),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if obs.trace is not None:
        result["device"]["busy_s"] = obs.trace["busy_s"]
        result["device"]["window_s"] = obs.trace["window_s"]
        result["breakdown"] = {"device_ops": obs.trace["device_ops"],
                               "idle_gaps": obs.trace["idle_gaps"]}
    if keep:
        result["_kept"] = {"picked": picked, "params": params, "conf": conf, "ref": ref,
                           "gaps": per_req}
    result["checks"] = checks
    return result
