"""Model-step layer: the least HBM bytes of the window's decode steps
(every weight once, the live rows' cache read and written;
``counts/model.py``), over their device time (CUDA events), as a
percentage of the card's HBM bandwidth (``counts/peaks.py``). Decode is
bound by bytes, so this is the share of the step's own roofline that
``decode_mfu`` cannot show."""
from perfbench.counts import model, peaks


def read(obs):
    rec = obs.in_window(obs.decodes)
    if not rec or any(r["device_s"] is None for r in rec):
        return None
    nbytes = sum(model.decode_bytes(obs.conf, r["rows"], r["pos"]) for r in rec)
    return 100.0 * nbytes / sum(r["device_s"] for r in rec) / peaks.HBM_BYTES
