"""Logical-axis → mesh-axis sharding rules (the counterpart of
``repro/sharding/specs.py``) over a torch ``DeviceMesh``.

Every parameter carries logical axis names (``models.layers.ParamSpec``).
A *rule set* maps logical names to mesh axes; unmapped axes are
replicated. A mapping is dropped (the dimension replicated) when the
dimension's size does not divide by the mesh axis's size (2 KV heads on a
16-way model axis), and a mesh axis is used at most once per tensor.

``Spec`` stands in for JAX's ``PartitionSpec``: one entry per tensor
dimension, each None, a mesh-axis name, or a tuple of names (the
dimension sharded over their product, major first). ``placements`` turns
it into DTensor placements, one per mesh dimension (``Shard(d)`` where the
spec puts that mesh axis on dimension ``d``, else ``Replicate()``);
``distribute`` applies it to a real tensor (``distribute_tensor``) or to a
meta one (``DTensor.from_local`` of a meta local shard, no check). A mesh
here is anything with ``mesh_dim_names`` and a ``shape`` tuple (a
``DeviceMesh``), or with ``axis_names`` and a ``shape`` dict (a duck mesh,
as the reference's tests use).

Rule sets are a tuning knob (``RunConfig.sharding_rules``).

Under a mesh the models run on DTensors, and DTensor propagates each op's
sharding. Where its own strategy would replicate a sharded tensor, or
does not hold, the model redistributes explicitly or runs on the local
shards (``to_local`` / ``from_local``). The points:

  * ``transformer.gather_weights``: a layer's weights (and the LM head)
    gathered over the data axes at use (fsdp), one layer at a time, so
    the batch stays split (DTensor would split the contraction instead
    and replicate the batch);
  * ``transformer._lookup``: the vocab-split embedding, vocab-parallel;
  * ``transformer._store_sharded``: the cache writes of a prefill and of
    a decode step (the decode cache split over its slots: the ring slot
    lands on the shard that holds it);
  * ``transformer._heads`` (``fit_dim``): a head split that does not
    divide the heads, replicated before the reshape;
  * ``attention._sharded``: attention on the shards (batch over data,
    heads over ``"model"``; a slot-split cache by the flash-decode split),
    and ``mla._latent_sharded``, MLA's absorbed decode the same way;
  * ``select_layer`` / ``unbind_layers``: a layer of a stack from the
    local shard (DTensor's ``select`` backward materialises the stack;
    fsdp over the layer axis takes the layer from its owner);
  * ``layers.rms_norm`` / ``layer_norm`` (``settle``): a pending partial
    sum reduced before the norm (DTensor keeps x·x of a partial sum
    partial);
  * ``training.train_step``: the vocab-parallel cross-entropy, and each
    gradient reduced to its parameter's placements;
  * ``models.moe``: the expert-parallel paths, and the dense path under a
    mesh, on the shards.

M-RoPE's gathers and the MLA and Mamba2 projections run on DTensor's own
strategies.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

# logical axis -> mesh axis (or tuple of mesh axes)
RULE_SETS: Dict[str, Dict[str, object]] = {
    # Megatron-style tensor parallelism + fsdp-style weight sharding over
    # the data axis on the embed dimension (needed to fit 236B params).
    "megatron_fsdp": {
        "vocab": "model",
        "heads_flat": "model",
        "kv_heads_flat": "model",
        "ff": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "embed": "data",  # fsdp: gather on use
        "layers": None,
    },
    # pure tensor parallelism (params replicated over data)
    "megatron": {
        "vocab": "model",
        "heads_flat": "model",
        "kv_heads_flat": "model",
        "ff": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "embed": None,
        "layers": None,
    },
    # serving: 2D expert sharding (experts→model, ff→data): weights stay
    # fully sharded but are never gathered; MoE down-projections reduce
    # with a small activation psum over data.
    "serving_2d": {
        "vocab": "model",
        "heads_flat": "model",
        "kv_heads_flat": "model",
        "ff": "data",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "embed": None,
        "layers": None,
    },
    # fsdp over the layer stack axis instead of the embed axis
    "fsdp_layers": {
        "vocab": "model",
        "heads_flat": "model",
        "kv_heads_flat": "model",
        "ff": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "embed": None,
        "layers": "data",
    },
}


class Spec(tuple):
    """Per-dimension mesh axes of one tensor (JAX's ``PartitionSpec``; as
    there, a one-axis tuple entry is that axis's name)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def spec_for_axes(
    mesh, axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
    rules: Dict[str, object],
) -> Spec:
    parts = []
    used = set()
    for dim, name in zip(shape, axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None or mesh_axis in used:
            parts.append(None)
            continue
        if dim % _axis_size(mesh, mesh_axis) != 0:
            parts.append(None)  # indivisible: replicate
            continue
        parts.append(mesh_axis)
        used.add(mesh_axis)
    return Spec(*parts)


def data_axes(mesh) -> tuple:
    """All mesh axes used for batch/data parallelism ((pod, data) if present)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def batch_split(mesh, global_batch: int):
    """The data axes a batch of ``global_batch`` rows splits over (all of
    them, where they divide it), or None."""
    da = data_axes(mesh)
    if da and global_batch % math.prod(mesh_shape(mesh)[a] for a in da) == 0:
        return da
    return None


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def param_shardings(mesh, specs_tree, rules_name: str):
    """``ParamSpec`` tree -> ``Spec`` tree. On a pod mesh a rule's
    ``"data"`` is ``("pod", "data")`` (fsdp over both jointly)."""
    from repro_torch.models.layers import tree_map_specs

    rules = dict(RULE_SETS[rules_name])
    if "pod" in axis_names(mesh):
        for k, v in list(rules.items()):
            if v == "data":
                rules[k] = ("pod", "data")
    return tree_map_specs(lambda s: spec_for_axes(mesh, s.axes, s.shape, rules), specs_tree)


def batch_spec(mesh, global_batch: int) -> Spec:
    """Sharding of the leading batch dimension of activations and inputs."""
    da = data_axes(mesh)
    shape = mesh_shape(mesh)
    size = math.prod(shape[a] for a in da)
    if da and global_batch % size == 0:
        return Spec(da)
    # try pod-only / data-only before giving up
    for sub in (("data",), ("pod",)):
        if all(a in shape for a in sub):
            if global_batch % math.prod(shape[a] for a in sub) == 0:
                return Spec(sub)
    return Spec(None)


def activation_sharding(mesh, global_batch: int, extra_dims: int) -> Spec:
    """(B, ..., d) activations: batch over data axes, trailing dims replicated."""
    return Spec(*batch_spec(mesh, global_batch), *([None] * extra_dims))


def cache_shardings(mesh, cfg, cache_tree, global_batch: int):
    """KV-cache sharding: the batch dimension over the data axes; the
    cache's slot dimension over ``"model"`` where it divides (flash-decode
    style: each model shard owns a slice of the context)."""
    shape = mesh_shape(mesh)
    bspec = batch_split(mesh, global_batch)

    def one(leaf):
        if isinstance(leaf, dict):
            return {k: one(leaf[k]) for k in sorted(leaf)}
        nd = len(leaf.shape)
        if nd == 0:  # the length scalar
            return Spec()
        # layout (L, B, W, ...) for kv/latent; (L, B, ...) for ssm state
        parts = [None] * nd
        if nd >= 2:
            parts[1] = bspec
        if nd >= 3 and leaf.shape[2] % shape["model"] == 0:
            parts[2] = "model"
        return Spec(*parts)

    return one(cache_tree)


def prefill_cache_spec(mesh, name: str, shape, global_batch: int) -> Spec:
    """The spec of cache tensor ``name`` (of the stacked (L, B, ...)
    cache) that a prefill fills under a mesh: the batch over the data
    axes, and the heads over ``"model"`` where they divide (K/V and
    cross-attention K/V (L, B, W, H, D), the SSM state (L, B, nh, hd, N));
    the slot axis whole, so that each layer's K/V are copied in without
    communication where their heads are split the same way."""
    if len(shape) == 0:
        return Spec()
    parts = [None] * len(shape)
    parts[1] = batch_split(mesh, global_batch)
    h = {"k": 3, "v": 3, "cross_k": 3, "cross_v": 3, "ssm": 2}.get(name)
    if h is not None and shape[h] % mesh_shape(mesh)["model"] == 0:
        parts[h] = "model"
    return Spec(*parts)


def sharded_new(mesh, shape, dtype, spec, device, zero: bool = True):
    """A DTensor of ``shape`` sharded by ``spec``, zero-filled (or left
    uninitialised), made as each rank's local shard: no global tensor."""
    from torch.distributed.tensor import DTensor

    local = (torch.zeros if zero else torch.empty)(local_shape(mesh, spec, shape), dtype=dtype,
                                                   device=device)
    return DTensor.from_local(local, mesh, placements(mesh, spec), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dimension) of ``spec``. A split
    over a mesh axis of one device is no split: it is ``Replicate()``, so
    that nothing is gathered over it."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    out = []
    for name in axis_names(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if dim is None or sizes[name] == 1 else Shard(dim))
    return tuple(out)


def local_shape(mesh, spec, shape) -> Tuple[int, ...]:
    """The shard shape on one device (every sharded dimension divides)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axis_size(mesh, e) for n, e in zip(shape, spec))


def distribute(mesh, t: torch.Tensor, spec):
    """``t`` as a DTensor sharded by ``spec``: a real tensor is scattered
    with ``distribute_tensor``; a meta tensor becomes the meta local shard
    of its rank (``from_local``, no check: nothing is communicated)."""
    from torch.distributed.tensor import distribute_tensor

    if t.device.type == "meta":
        return sharded_new(mesh, t.shape, t.dtype, spec, "meta", zero=False)
    return distribute_tensor(t, mesh, placements(mesh, spec))


def distribute_tree(mesh, tree, spec_tree):
    """``distribute`` over matching dict trees of tensors and ``Spec``s."""
    if isinstance(tree, dict):
        return {k: distribute_tree(mesh, tree[k], spec_tree[k]) for k in tree}
    return distribute(mesh, tree, spec_tree)


def fit_dim(x, dim: int, n: int):
    """``x`` with dimension ``dim`` sharded only where the split keeps ``n``
    whole (for a reshape of that dimension into (n, ...)): a DTensor whose
    ``dim`` is sharded over mesh axes of a product that does not divide
    ``n`` is redistributed with that dimension replicated. Anything else is
    returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    mesh = x.device_mesh
    sizes = [mesh.size(i) for i, p in enumerate(x.placements) if p == Shard(dim)]
    if n % math.prod(sizes) == 0:
        return x
    pl = [Replicate() if p == Shard(dim) else p for p in x.placements]
    return x.redistribute(mesh, pl)


def to_local(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """The local shard of ``t`` under ``spec``: a DTensor is redistributed
    (communicating as its placements require); a plain tensor, the same
    global value on every rank, is sliced without communication."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return _ContiguousGrad.apply(t.redistribute(mesh, placements(mesh, spec)).to_local())


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: the
    gradient of a local shard becomes a DTensor with the forward's
    (contiguous) strides, and a local computation may leave it permuted."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def from_local(mesh, local: torch.Tensor, spec, like: torch.Tensor, partial=()):
    """``local`` as the DTensor of ``spec`` (a partial sum over the mesh
    axes ``partial``); or, where the input ``like`` was a plain tensor, its
    global value, summed over ``partial`` and gathered over the split
    axes (minor axis first) with ``all_gather``."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(like, DTensor):
        out = local
        for name in partial:
            out = psum(mesh, out, name)
        for d, e in enumerate(spec):
            for name in reversed(e if isinstance(e, tuple) else (e,) if e else ()):
                out = all_gather(mesh, out, name, d)
        return out
    pl = [Partial() if name in partial else p
          for name, p in zip(axis_names(mesh), placements(mesh, spec))]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


def is_sharded_on(x, dim: int, axis: str) -> bool:
    """Whether DTensor ``x`` has dimension ``dim`` sharded over mesh axis ``axis``."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    return axis in names and x.placements[names.index(axis)] == Shard(dim % x.ndim)


class _AllReduceSum(torch.autograd.Function):
    """A sum over one process group; its transpose is a sum of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as fc

        ctx.group = group
        return fc.wait_tensor(fc.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as fc

        return fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum", ctx.group)), None


def psum(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of the local ``x`` over mesh axis ``axis`` (differentiable;
    nothing is communicated over an axis of one device)."""
    if mesh.size(axis_names(mesh).index(axis)) == 1:
        return x
    return _AllReduceSum.apply(x, mesh.get_group(axis))


def all_gather(mesh, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` along mesh axis ``axis``, concatenated along
    ``dim`` in rank order (differentiable; nothing is communicated over an
    axis of one device)."""
    if mesh.size(axis_names(mesh).index(axis)) == 1:
        return x
    out = _AllGather.apply(x.movedim(dim, 0).contiguous(), mesh.get_group(axis))
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """An all-gather along the leading axis through c10d's
    ``all_gather_into_tensor`` (torch 2.11's gloo crashes in the functional
    all-gather of CUDA tensors, and runs this one); its transpose sums the
    cotangent over the group and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        n = dist.get_world_size(group)
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rows = g.shape[0] // dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return g[rank * rows:(rank + 1) * rows], None


def select_layer(v, i: int):
    """``v[i]``. A DTensor stack whose layer axis is sharded (``"layers"``
    over ``"data"``, fsdp over the stack) gives layer ``i`` from its owner,
    as a sum over the sharding axes of the owner's slice and the others'
    zeros, in place of a gather of the whole stack."""
    if not is_dtensor(v):
        return v[i]
    from torch.distributed.tensor import Shard

    split = [d for d, p in enumerate(v.placements) if p == Shard(0)]
    if not split:
        return _from_layer(v, v.to_local()[i])
    mesh = v.device_mesh
    vl = v.to_local()
    n_loc = vl.shape[0]
    mine = 0
    for d in split:
        mine = mine * mesh.size(d) + mesh.get_local_rank(d)
    piece = vl[i % n_loc] if mine == i // n_loc else torch.zeros_like(vl[0])
    for d in split:
        piece = psum(mesh, piece, mesh.mesh_dim_names[d])
    return _from_layer(v, piece)


def unbind_layers(v) -> list:
    """``v.unbind(0)``; a DTensor stack whose layer axis is whole is
    unbound on each rank's shard (DTensor's own ``select`` backward
    materialises the whole stack per layer)."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(v):
        return list(v.unbind(0))
    if any(p == Shard(0) for p in v.placements):
        return [select_layer(v, i) for i in range(v.shape[0])]
    return [_from_layer(v, piece) for piece in v.to_local().unbind(0)]


def _from_layer(v, piece):
    """One layer's local slice of stack ``v`` as a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Replicate() if p == Shard(0) else Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in v.placements]
    return DTensor.from_local(piece, v.device_mesh, pl, run_check=False, shape=v.shape[1:],
                              stride=_contiguous_stride(v.shape[1:]))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def settle(x):
    """``x`` with any pending partial sum reduced (a DTensor's ``Partial``
    placements made ``Replicate``), before a nonlinear use: DTensor keeps
    a product of two partial sums partial, which is not the product of
    the sums. Anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in x.placements])


def gather_data(x):
    """DTensor ``x`` with its shards over the data axes (``"pod"``,
    ``"data"``) gathered; anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    names = x.device_mesh.mesh_dim_names
    pl = [Replicate() if isinstance(p, Shard) and n in ("pod", "data") else p
          for n, p in zip(names, x.placements)]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)
