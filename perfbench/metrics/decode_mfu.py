"""Model-step layer: model FLOPs of the window's decode steps, counting the
rows that still served a request (``counts/model.py``), over their
device time (CUDA events), as a percentage of the card's bf16 peak
(``counts/peaks.py``)."""
from perfbench.counts import model, peaks


def read(obs):
    rec = obs.in_window(obs.decodes)
    if not rec or any(r["device_s"] is None for r in rec):
        return None
    flops = sum(model.decode_flops(obs.conf, r["rows"], r["pos"]) for r in rec)
    return 100.0 * flops / sum(r["device_s"] for r in rec) / peaks.BF16_FLOPS
