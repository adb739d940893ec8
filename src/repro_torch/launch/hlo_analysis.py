"""Roofline terms of one dry-run step (the counterpart of
``repro/launch/hlo_analysis.py``).

  compute term    = FLOPs / (chips × peak_FLOP/s)
  memory term     = bytes / (chips × HBM_bw)
  collective term = collective_bytes / (chips × link_bw)

The reference parses XLA's compiled per-device HLO. Eager torch has no
such program, so ``CostModel`` stands in for it: a ``TorchDispatchMode``
that watches one step run on meta-device DTensors over the (fake) mesh
and counts the per-rank program, the local ops that DTensor issues on
each rank's shard:

  * an op on DTensors is passed on (``NotImplemented``), so DTensor runs
    it and the mode sees the local ops and collectives it issues; the
    global-shape ops DTensor runs on fake tensors to infer shapes are not
    counted;
  * matmul FLOPs = 2 · |result| · Π(contracting dims), from the local
    shapes of ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``;
  * op bytes = |result| + Σ|operands| per aten op; a view moves nothing,
    an in-place op counts its operands only. Eager torch does not fuse,
    so this counts every elementwise intermediate that XLA's fused
    kernels keep on chip: it is larger than the reference's count;
  * collective operand bytes are tallied per kind from the functional
    collectives (``all_gather_into_tensor``, ``all_reduce``,
    ``reduce_scatter_tensor``, ``all_to_all_single``) and c10d's
    in-place ones (``_allgather_base_``, ``allreduce_``, ...), under the
    reference's names;
  * peak memory is the most local bytes alive at once across the step:
    the arguments, and every storage an op makes, from its op until it
    is freed.

The port runs a model's layers in a Python loop, so every layer's ops are
seen and no ``while`` trip count multiplies anything. One repetition is
folded instead: ``memoized`` runs a function of meta tensors (no grad)
once per signature under the model and replays its counted costs, its
peak and its outputs' shapes for each later call with the same
signature, as the reference's trip count replays a loop body. The plain
attention of a long prefill is such a call: every layer's tiles are the
same shapes, and Qwen2.5-3B's prefill_32k runs 36 × 1024 tile pairs.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.sharding.specs import is_dtensor

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# functional collective op name -> the reference's kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# the c10d in-place collectives the port issues (``sharding.specs.all_gather``)
# -> (the reference's kind, the operand's argument index)
_C10D_OPS = {
    "_allgather_base_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
}

_MATMULS = ("mm", "bmm", "addmm", "baddbmm")
_FREE = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "wait_tensor", "_to_copy_meta", "lift_fresh")


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES}
    )

    def __iadd__(self, o: "Costs"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k in self.collectives:
            self.collectives[k] += o.collectives[k]
        return self


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> float:
    """2 · |result| · k of a (batched) product, from the operands' shapes."""
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("mm", "addmm"):
        return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]


_ACTIVE: list = []  # the CostModel that is counting, innermost last


class CostModel(TorchDispatchMode):
    """Counts the per-rank FLOPs, bytes, collective bytes and live memory
    of what runs under it (module note). ``track(tree)`` registers
    tensors that exist before the step (its arguments) as live."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()
        self.memo: dict = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ memory
    def _hold(self, t: torch.Tensor) -> None:
        local = t._local_tensor if is_dtensor(t) else t
        st = local.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, tree) -> int:
        """Count ``tree``'s tensors as live; returns their local bytes."""
        before = self.live
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return self.live - before

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in tensors + outs):
            return out  # DTensor's shape inference on global shapes
        name = func.overloadpacket.__name__
        ns = func.namespace
        c = self.costs
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                operand = float(sum(_nbytes(t) for t in tensors))
                c.collectives[kind] += operand
                c.bytes += operand
        elif ns == "c10d":
            if name in _C10D_OPS:
                kind, i = _C10D_OPS[name]
                operand = float(sum(_nbytes(t) for t in tree_flatten(args[i])[0]
                                    if isinstance(t, torch.Tensor)))
                c.collectives[kind] += operand
                c.bytes += operand
        elif func.is_view or name in _FREE:
            pass
        else:
            if name in _MATMULS:
                c.flops += _matmul_flops(name, args)
            mutated = func._schema.is_mutable
            c.bytes += float(sum(_nbytes(t) for t in tensors))
            if not mutated:
                c.bytes += float(sum(_nbytes(o) for o in outs))
        if not func.is_view:
            for o in outs:
                self._hold(o)
        return out


def memoized(key, fn, *args):
    """``fn(*args)``, whose tensor arguments and output are meta tensors
    with no grad: under a counting ``CostModel`` the first call with
    ``key`` (which must name every shape, dtype and option ``fn`` depends
    on) runs and is recorded; later calls add its costs, raise the peak by
    its own peak over what was live, and return new meta tensors of its
    output's shape (module note). Runs ``fn`` as it is otherwise."""
    cm = _ACTIVE[-1] if _ACTIVE else None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if cm is None or any(t.device.type != "meta" or t.requires_grad for t in tensors):
        return fn(*args)
    rec = cm.memo.get(key)
    if rec is None:
        before = Costs(cm.costs.flops, cm.costs.bytes, dict(cm.costs.collectives))
        live0, peak0 = cm.live, cm.peak
        cm.peak = cm.live
        out = fn(*args)
        delta = Costs(cm.costs.flops - before.flops, cm.costs.bytes - before.bytes,
                      {k: cm.costs.collectives[k] - before.collectives[k] for k in before.collectives})
        cm.memo[key] = (delta, cm.peak - live0, tuple(out.shape), out.dtype)
        cm.peak = max(peak0, cm.peak)
        return out
    delta, own_peak, shape, dtype = rec
    cm.costs += delta
    cm.peak = max(cm.peak, cm.live + own_peak)
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_per_chip: Dict[str, float]
    n_chips: int
    # The rates of the TPU pod that ``core.space.tpu_pod_space`` and
    # ``launch/tune.py`` model (the reference's constants), not a
    # measurement of any device.
    peak_flops: float = 197e12
    hbm_bw: float = 819e9
    link_bw: float = 50e9
    xla_flops_per_chip: float = 0.0  # the reference's raw XLA count; no counterpart here
    xla_bytes_per_chip: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return sum(self.collective_per_chip.values()) / self.link_bw

    @property
    def dominant(self) -> str:
        t = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(t, key=t.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_per_chip": dict(self.collective_per_chip),
            "n_chips": self.n_chips,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "xla_flops_per_chip": self.xla_flops_per_chip,
            "xla_bytes_per_chip": self.xla_bytes_per_chip,
        }


def roofline_from_costs(costs: Costs, n_chips: int) -> Roofline:
    return Roofline(
        flops_per_chip=costs.flops,
        bytes_per_chip=costs.bytes,
        collective_per_chip=dict(costs.collectives),
        n_chips=n_chips,
    )


def collective_bytes(fn, *args, **kwargs) -> Dict[str, float]:
    """Per-rank collective operand bytes of ``fn(*args, **kwargs)``."""
    with CostModel() as cm:
        fn(*args, **kwargs)
    return dict(cm.costs.collectives)
