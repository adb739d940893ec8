"""Whether what the timed path served is correct.

Once the window (and its grace period) has closed, the peak memory has
been read and the program's caches are freed, a sample of the finished
requests, drawn from the seed, goes through the plain reference of the
configuration's family (``reference/<family>.py``): the longest request
first, then others in the seed's order until ``sample_tokens`` served
tokens are covered (or ``sample_requests`` requests). For each request
the reference runs once over its prompt followed by its served tokens,
in float32 with TF32 off, on the same weights; at each served position
the gap is the reference's best logit less the reference's logit of the
token the program served there. The number compared is the widest gap
over every served token of the sample (``widest_logit_gap``), against
the cell's limit; the mean gap is printed beside it.

That holds the whole timed path to the reference: the prefill through
its kernel (flash attention or the SSD scan) gives the first token, the
cache it hands on and the graphed decode steps give the rest, and the
host's greedy argmax picks each one. Greedy traffic only: every request
is decoded greedily.

The control (``control.py``) reads the same gap for the token that the
reference computed in fp8 puts first at each position.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import numpy as np
import torch


def sample(done: List, seed: int, sample_tokens: int, sample_requests: int) -> List:
    """The requests to compare: the longest (prompt and served tokens),
    then the rest in an order drawn from the seed."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (done[i].prompt.size + len(done[i].tokens), -i))
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    order = [longest] + [i for i in rng.permutation(len(done)) if i != longest]
    out, served = [], 0
    for i in order:
        if served >= sample_tokens or len(out) >= sample_requests:
            break
        out.append(done[i])
        served += len(done[i].tokens)
    return out


@contextlib.contextmanager
def _no_tf32():
    """Float32 matmuls and convolutions in full float32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec = saved
        torch.set_float32_matmul_precision(prec)


@torch.inference_mode()
def gaps(ref_logits: Callable, conf: dict, params: dict, req, device,
         precision: Optional[str] = None) -> np.ndarray:
    """Per served position of ``req``: the float32 reference's best logit
    less its logit of the token judged there, which is the served token,
    or, with ``precision`` (the control), the token that the reference at
    that precision puts first."""
    toks = np.concatenate([req.prompt, np.asarray(list(req.tokens), np.int32)])
    # position p's logits predict token p + 1: the served tokens are
    # predicted from the prompt's last position on
    first = req.prompt.size - 1
    seq = torch.as_tensor(toks[:-1], device=device)
    served = torch.as_tensor(toks[req.prompt.size:], device=device).long()
    with _no_tf32():
        ref = ref_logits(conf, params, seq, first)
        if precision is None:
            judged = served
        else:
            judged = ref_logits(conf, params, seq, first, precision=precision).argmax(-1)
    best = ref.max(dim=-1).values
    got = ref.gather(1, judged[:, None])[:, 0]
    return (best - got).cpu().numpy()
