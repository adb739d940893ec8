"""Weights drawn from the run's seed, on the device, in the program's
parameter layout.

One ``torch.Generator`` on the device, seeded with ``--seed``, draws every
leaf in a fixed order (the tree's keys sorted), one call per stacked leaf,
straight in the dtype the leaf is served in (the configuration's dtype,
or float32 for the leaves listed under ``float32_leaves``), then scales
it in place. The configuration file's ``init`` says how each leaf is
drawn:

- ``normal``: N(0, std²);
- ``fan_in``: N(0, 1/fan_in), fan_in the size of axis ``fan_in_axis``
  (default -2, the contracted axis of ``x @ w``);
- ``fan_in_depth``: ``fan_in`` divided further by sqrt(2 · layers), the
  residual branch's output projections, so that the residual stream grows
  as in a trained model rather than with depth;
- ``ones_noise``: 1 + N(0, std²) (norm weights, Mamba2's D);
- ``dt_bias``: the inverse softplus of a dt drawn log-uniformly in
  ``range`` (Mamba2's initialisation);
- ``log_uniform``: log of a draw uniform in ``range`` (Mamba2's A_log).

The same tensors go to the program's engine and to the plain reference,
which reads them in float32.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def draw(conf: dict, shapes: dict, seed: int, device) -> dict:
    """The parameter tree for ``shapes`` (nested dicts of shapes), drawn
    from ``seed`` on ``device`` as ``conf["init"]`` says."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    served = DTYPES[conf["dtype"]]
    f32 = set(conf.get("float32_leaves", ()))
    depth = math.sqrt(2.0 * conf["num_hidden_layers"])
    out: dict = {}
    for path, shape in _leaves(shapes):
        name = path[-1]
        rule = conf["init"].get(name)
        if rule is None:
            raise KeyError(f"configuration {conf['name']} has no init rule for leaf {name!r}")
        dtype = torch.float32 if name in f32 else served
        kind = rule["kind"]
        if kind in ("dt_bias", "log_uniform"):
            lo, hi = rule["range"]
            u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            if kind == "dt_bias":
                dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
                t = dt + torch.log(-torch.expm1(-dt))  # softplus⁻¹(dt)
            else:
                t = torch.log(u * (hi - lo) + lo)
            t = t.to(dtype)
        else:
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            if kind == "normal":
                t.mul_(rule["std"])
            elif kind in ("fan_in", "fan_in_depth"):
                std = 1.0 / math.sqrt(shape[rule.get("fan_in_axis", -2)])
                t.mul_(std / depth if kind == "fan_in_depth" else std)
            elif kind == "ones_noise":
                t.mul_(rule["std"]).add_(1.0)
            else:
                raise ValueError(f"unknown init kind {kind!r} for leaf {name!r}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = t
    return out
