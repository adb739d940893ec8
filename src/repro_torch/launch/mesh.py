"""Production and host meshes (the counterpart of
``repro/launch/mesh.py``).

The reference forces 512 host devices and lets GSPMD partition the
program. Here a mesh is a torch ``DeviceMesh``: the production mesh sits
on a ``fake`` process group of 256 or 512 ranks in the caller's process
(this process is rank 0; collectives return without communicating, which
the dry run's meta tensors need), whose device type is ``meta``. The
default process group is global to a process, so a dry run on one mesh
size runs in a process of its own (the CLI's, or a subprocess). Functions,
not module constants: importing this module creates no group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

PRODUCTION_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, made if none exists."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; a mesh of "
                f"{world} needs a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod (fake ranks)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = POD_AXES if multi_pod else PRODUCTION_AXES
    n = math.prod(shape)
    _fake_group(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_fake_mesh(shape, axes=PRODUCTION_AXES):
    """A mesh of any shape on a fake group of its size (tests, small dry runs)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    _fake_group(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def make_host_mesh(model_parallel: int = 1, device=None):
    """A (data, model) mesh over the ranks of the process group that
    exists, or, with none, a 1×1 mesh on ``device`` (the card's when there
    is one) over a group of this process alone."""
    from torch.distributed.device_mesh import DeviceMesh

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev_type = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    return DeviceMesh(dev_type, torch.arange(n).reshape(n // model_parallel, model_parallel),
                      mesh_dim_names=PRODUCTION_AXES)
