"""Model-step layer: model FLOPs of the prefills the trace held, counting
the rows that carry a request and the positions put before each prompt
(``counts/model.py``; the published Hymba's meta tokens, whose count the
program records in each group's ``GroupTrace.prefix_tokens``), over their
device time (CUDA events), as a percentage of the card's bf16 peak
(``counts/peaks.py``). None without a trace, or where the program's
record of the prefixed positions disagrees with the configuration's (the
count would then be of another model)."""
from perfbench.counts import model, peaks


def read(obs):
    if obs.trace is None:
        return None
    calls = [p for p in obs.prefills if p["traced"] == obs.trace["spans_lost"]]
    if not calls or any(p["device_s"] is None for p in calls):
        return None
    prefix = {getattr(r.group, "prefix_tokens", None) for r in obs.requests
              if getattr(r, "group", None) is not None}
    if prefix != {obs.conf.get("num_memory_tokens", 0)}:
        return None
    flops = sum(model.prefill_flops(obs.conf, p["rows"], p["s"]) for p in calls)
    return 100.0 * flops / sum(p["device_s"] for p in calls) / peaks.BF16_FLOPS
