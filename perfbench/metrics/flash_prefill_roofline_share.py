"""Kernel layer: the flash attention kernel's share of its roofline over
the prefills the trace held (``trace.roofline_share``: one launch a layer
in each prefill's span), each layer's launch counted with its own mask
(``counts/flash_window.py``: the window and its sink of meta tokens, or
full causal attention in the global layers) over all the rows it
attends, padding included. ``roofline_share`` bounds a prefill's
launches by one launch's (FLOPs, bytes) times the layers, so this gives
it the layers' means: every launch of the cell is bound by operations
(counts/flash_window.py), so the bound of the mean is the mean of the
bounds. None for a model without windowed layers and meta tokens."""
import re

from perfbench import trace
from perfbench.counts import flash_window

PATTERN = re.compile(r"flash_fwd")


def read(obs):
    c = obs.conf
    if "global_attn_idx" not in c or "num_memory_tokens" not in c:
        return None
    hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd, dv, layers = c["hidden_size"] // hq, c["v_head_dim"], c["num_hidden_layers"]

    def bound_of(p):
        b, s = p["batch"], p["s"] + c["num_memory_tokens"]
        flops = sum(flash_window.flops(b, hq, s, hd, dv, *(
            (None, 0) if i in c["global_attn_idx"] else (c["sliding_window"],
                                                         c["num_memory_tokens"])))
            for i in range(layers))
        return flops / layers, flash_window.nbytes(b, hq, hkv, s, hd, dv)

    return trace.roofline_share(obs, PATTERN, bound_of)
