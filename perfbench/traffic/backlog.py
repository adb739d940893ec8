"""A backlog queued at the window's start: every request is due at t = 0.

Parameters (the mix file and the cell): ``requests``, the backlog's size,
which the cell sets to at least twice what its window completes;
``group``, the cell's batch; ``prompt_lens``, the set the prompts are
drawn from; ``new_tokens``, the [lo, hi] range of the output lengths.

Every seed gets the same work in every group: the backlog is cut into
blocks of ``group`` requests of one prompt length (the set's lengths in
equal shares of the blocks), each block's output lengths the midpoints
of ``group`` equal steps over [lo, hi]. The seed draws the order of the
blocks, the order of the outputs inside each block, and the prompts'
token ids. The runtime groups equal prompt lengths in queue order, so
each group it forms is one block, and the seed changes which row gets
which length, not how long a group lasts. (With one order over the whole
backlog the seed moved the cell's tokens per second by 3 % from run to
run, against 0.5 % between two runs of one seed: PERF.md.)
"""
from __future__ import annotations

from typing import List

import numpy as np

from perfbench.traffic import Item, stratified_outputs


def generate(params: dict, seconds: float, vocab: int, rng: np.random.Generator) -> List[Item]:
    group = int(params["group"])
    blocks = int(params["requests"]) // group
    lens = rng.permutation(np.resize(np.asarray(params["prompt_lens"], dtype=np.int64), blocks))
    out: List[Item] = []
    for s in lens:
        for o in stratified_outputs(params["new_tokens"], group, rng):
            out.append(Item(0.0, rng.integers(0, vocab, int(s), dtype=np.int32), int(o)))
    return out
