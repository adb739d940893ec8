"""Model FLOPs and HBM bytes of one prefill and one decode step, from the
configuration file's published keys. The formulas of each model family
live in its file, ``perfbench/families/<family>.py`` (found by name, as
references are); this module hands each count to the configuration's
family and holds the pieces families share.

FLOPs: 2 FLOP per multiply-add of every matmul, plus attention's scores
and weighted sums over the positions each token sees, or the SSD scan's.
The LM head runs on the last position of a prefill and on every decode
row, as the program's ``unembed`` does. Embedding lookups, norms and
elementwise work are not counted.

Bytes (``decode_bytes``): the least HBM traffic of one decode step. Every
weight the step reads once, the tied head included; for each live row,
the cache it reads and the cache it writes (K/V, or the recurrent and
conv state); every tensor in the dtype it is served in. Activations
between kernels, the step's tokens and its logits are not counted.

Only rows that carry a request are counted: a prefill group padded to
the batch, or a decode row whose request has finished, is work the card
does and no user asked for, so it lowers the share of the peak.
"""
from __future__ import annotations

from perfbench import manifest

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def prefill_flops(c: dict, rows: int, s: int) -> float:
    """FLOPs of a prefill of ``rows`` prompts of ``s`` tokens."""
    return manifest.family_of(c).prefill_flops(c, rows, s)


def decode_flops(c: dict, rows: int, t: int) -> float:
    """FLOPs of one decode step of ``rows`` rows at cache position ``t``
    (the step's token attends to t + 1 positions)."""
    return manifest.family_of(c).decode_flops(c, rows, t)


def decode_bytes(c: dict, rows: int, t: int) -> float:
    """Least HBM bytes of one decode step of ``rows`` rows at cache
    position ``t``."""
    return manifest.family_of(c).decode_bytes(c, rows, t)


# ------------------------------------------------- pieces families share
def head_flops(c: dict) -> float:
    """FLOPs of the LM head on one row."""
    return 2.0 * c["hidden_size"] * c["vocab_size"]


def itemsize(c: dict, leaf: str = "") -> int:
    """Bytes per element of weight ``leaf`` as served (float32 for the
    configuration's ``float32_leaves``), or of the cache (no leaf)."""
    return 4 if leaf in c.get("float32_leaves", ()) else ITEMSIZE[c["dtype"]]


def leaf_bytes(c: dict, elements: dict) -> float:
    """Bytes of the weights ``{leaf: elements}`` as served."""
    return float(sum(n * itemsize(c, leaf) for leaf, n in elements.items()))


def embed_bytes(c: dict, rows: int) -> float:
    """Bytes a decode step reads of the embedding and the LM head: the
    whole table once where the head is tied to it, else the whole head
    and one embedding row per row."""
    d, v = c["hidden_size"], c["vocab_size"]
    if c["tie_word_embeddings"]:
        return float(v * d * itemsize(c, "embed"))
    return float(v * d * itemsize(c, "head") + rows * d * itemsize(c, "embed"))
