"""Device meshes over ``torch.distributed`` ranks, and placing a tree of
tensors on one by its sharding specs.

Production: (data=16, model=16), 256 ranks; multi-pod (pod=2, data=16,
model=16), 512 ranks, the 'pod' axis pure data parallelism.  The host
mesh is the smoke-test mesh over whatever ranks exist: on one card (or
one CPU process) a (1, 1) mesh, whatever ``model_shards`` asks for, as the
JAX package's is on one device.

:func:`place` puts a tree of tensors on a mesh by its specs: plain tensors
on the mesh's device where every axis has size 1, else a DTensor for every
leaf (see the DTensor seams of :mod:`repro_torch.models.common`);
:func:`full_tree` gathers them back whole.  The ssm, hybrid and audio families shard the SSM inner
width, which waits for its own slice (:data:`SSM_MODEL_AXIS_ITEM`):
:func:`check_family` raises for them on a mesh axis above 1.

Functions, so importing this module starts no process group.  Where none
exists, :func:`make_host_mesh` starts a group of one rank (NCCL on a CUDA
device, gloo on the CPU) over a ``FileStore``, never a fixed TCP port.
"""

from __future__ import annotations

import gc
import math
import os
import socket
import tempfile
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.core.replicate import plan_cluster
from repro_torch.device import DeviceLike, target_device
from repro_torch.models.common import full

# NVIDIA H100 SXM5 80 GB data sheet, per card: dense bfloat16 on the
# tensor cores (1,979 TFLOP/s is the sparse figure), HBM3, and NVLink 4
# (900 GB/s in all, 450 GB/s each direction)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # B/s
ICI_BW = 450e9                  # B/s per direction of the card's NVLink

# the families whose specs shard the SSM inner width (mamba_specs), and
# the ROADMAP.md item their model axis waits for
DEFERRED_FAMILIES = ("ssm", "hybrid", "audio")
SSM_MODEL_AXIS_ITEM = ("a mesh axis above 1 for the ssm, hybrid and audio "
                       "families waits for 'the model axis of the ssm, "
                       "hybrid and audio families' in ROADMAP.md section 1")


def _start_one_rank(device: torch.device) -> None:
    """The default process group as one rank: NCCL on a CUDA device, gloo
    on the CPU, its store a file in the temporary directory."""
    fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
    os.close(fd)
    store = dist.FileStore(path, 1)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=device)
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The production mesh over the world's ranks; raises unless the
    world holds exactly its 256 (or 512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = target_device([], device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {math.prod(shape)} ranks; the world holds "
                         f"{n}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model_shards: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """A ("data", "model") mesh over the world's ranks, shaped by
    ``plan_cluster(world_size, model_shards)``; starts a one-rank process
    group on ``device`` (default: the CUDA card) where none exists."""
    dev = target_device([], device)
    if not dist.is_initialized():
        _start_one_rank(dev)
    plan = plan_cluster(dist.get_world_size(), model_shards)
    ranks = torch.arange(plan.dp_replicas * plan.model_shards)
    return DeviceMesh(dev.type, ranks.reshape(plan.mesh_shape),
                      mesh_dim_names=("data", "model"))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axis {name!r} not in {mesh.mesh_dim_names}")
    return mesh.size(mesh.mesh_dim_names.index(name))


def _spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_sharded(mesh: DeviceMesh) -> bool:
    """Whether ``mesh`` has an axis above 1 (its trees are DTensors)."""
    return mesh.size() > 1


def check_family(family: str, mesh: DeviceMesh) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for a family
    whose model axis is not ported yet on a mesh with an axis above 1."""
    if family in DEFERRED_FAMILIES and is_sharded(mesh):
        raise NotImplementedError(
            f"family {family!r} on mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
            f"{SSM_MODEL_AXIS_ITEM}")


def placements(spec, mesh: DeviceMesh, path: str = "") -> tuple:
    """The DTensor placements of a spec on ``mesh``: ``Shard(i)`` on each
    mesh axis above 1 that entry i names, ``Replicate()`` on the rest.  A
    tensor split over an axis of 1 is whole, and DTensor refuses views
    that drop a dimension sharded there (a batch of 1 on a 'data' axis of
    1 through ``x @ w``)."""
    out, named = [Replicate()] * mesh.ndim, set()
    for i, entry in enumerate(spec):
        for name in _spec_axes(entry):
            size = axis_size(mesh, name)        # raises for an unknown axis
            if name in named:
                raise ValueError(f"{path}: spec {spec} names mesh axis "
                                 f"{name!r} twice")
            named.add(name)
            if size > 1:
                out[mesh.mesh_dim_names.index(name)] = Shard(i)
    return tuple(out)


def place(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """``tree``'s tensors placed on ``mesh`` by ``specs`` (a tree of
    :class:`~repro_torch.models.common.P` of the same structure).

    Where every axis of the mesh has size 1, each tensor goes whole to the
    mesh's one device.  Otherwise each becomes a DTensor, the replicated
    ones too, sharded along dimension i over the axes above 1 that entry
    i of its spec names (:func:`placements`).  Every rank is taken to hold the same full tensor (a seeded
    draw, a checkpoint): each keeps its own shard, and nothing moves
    between ranks.  A DTensor leaf is redistributed to its spec.  A
    dimension its axes do not divide raises ValueError naming the leaf."""
    return _place(tree, specs, mesh, mesh_device(mesh), "")


def _place(t, spec, mesh: DeviceMesh, dev: torch.device, path: str):
    if isinstance(t, dict):
        if not isinstance(spec, dict) or sorted(spec) != sorted(t):
            raise ValueError(f"{path}: specs of another structure")
        return {k: _place(t[k], spec[k], mesh, dev, f"{path}/{k}")
                for k in sorted(t)}
    if len(spec) > t.dim():
        raise ValueError(f"{path}: spec {spec} for a tensor of shape "
                         f"{tuple(t.shape)}")
    pl = placements(spec, mesh, path)
    if not is_sharded(mesh):
        return t.to(dev)
    for i, entry in enumerate(spec):
        n = math.prod(axis_size(mesh, a) for a in _spec_axes(entry))
        if t.shape[i] % n:
            raise ValueError(
                f"{path}: dimension {i} of shape {tuple(t.shape)} does not "
                f"divide over mesh axes {entry!r} of {n}")
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute_tensor(t.to(dev), mesh, pl, src_data_rank=None)


def device_key(mesh: DeviceMesh) -> str:
    """What names the memory this rank draws into: its host and card (the
    card's UUID), or its host for the CPU."""
    host = socket.gethostname()
    if mesh.device_type == "cuda":
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return f"{host}/cuda/{props.uuid}"
    return f"{host}/{mesh.device_type}"


def draw_turns(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's turn, the number of turns): the ranks whose
    :func:`device_key` is the same take turns, one after another in rank
    order; a rank alone on its device takes turn 0 of 1 (a collective:
    every rank calls it)."""
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, device_key(mesh))
    mine = keys[dist.get_rank()]
    return keys[:dist.get_rank()].count(mine), max(map(keys.count, keys))


def place_in_turns(make: Callable[[], Any], specs: Any,
                   mesh: DeviceMesh) -> Any:
    """``place(make(), specs, mesh)``, where ranks share a device with
    their draws one after another (:func:`draw_turns`): each full tree
    then exists only during its rank's turn (four qwen3-14b draws at once
    would not fit one card).  Ranks alone on their devices draw at once.
    Every rank's ``make`` must give the same tree."""
    if not is_sharded(mesh):
        return place(make(), specs, mesh)
    turn, turns = draw_turns(mesh)
    if turns == 1:
        return place(make(), specs, mesh)
    out = None
    for t in range(turns):
        if t == turn:
            out = place(make(), specs, mesh)
            gc.collect()
            if mesh.device_type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def full_tree(tree: Any) -> Any:
    """``tree`` with every DTensor gathered whole (a collective: every rank
    calls it), for checkpoints and tests; plain tensors as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(tree[k]) for k in sorted(tree)}
    return full(tree)
