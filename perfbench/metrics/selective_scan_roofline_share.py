"""Kernel layer: the Mamba-1 selective scan's share of its roofline over
the prefills the trace held (``trace.roofline_share``: one launch a layer
in each prefill's span), each launch bound by its bytes
(``counts/selective_scan.py``) over all the rows it scans, padding
included, and the meta tokens. None for a model without Mamba-1 heads."""
import re

from perfbench import trace
from perfbench.counts import selective_scan

PATTERN = re.compile(r"selective_scan")


def read(obs):
    c = obs.conf
    if "mamba_d_state" not in c:
        return None
    di, n = c["mamba_expand"] * c["hidden_size"], c["mamba_d_state"]
    m = c.get("num_memory_tokens", 0)
    return trace.roofline_share(
        obs, PATTERN, lambda p: (selective_scan.flops(p["batch"], p["s"] + m, di, n),
                                 selective_scan.nbytes(p["batch"], p["s"] + m, di, n)))
