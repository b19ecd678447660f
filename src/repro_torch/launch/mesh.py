"""Device meshes over ``torch.distributed`` ranks, and placing a tree of
tensors on one by its sharding specs.

Production: (data=16, model=16), 256 ranks; multi-pod (pod=2, data=16,
model=16), 512 ranks, the 'pod' axis pure data parallelism.  The host
mesh is the smoke-test mesh over whatever ranks exist: on one card (or
one CPU process) a (1, 1) mesh, whatever ``model_shards`` asks for, as the
JAX package's is on one device.

Functions, so importing this module starts no process group.  Where none
exists, :func:`make_host_mesh` starts a group of one rank (NCCL on a CUDA
device, gloo on the CPU) over a ``FileStore``, never a fixed TCP port.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Any, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.replicate import plan_cluster
from repro_torch.device import DeviceLike, target_device

# NVIDIA H100 SXM5 80 GB data sheet, per card: dense bfloat16 on the
# tensor cores (1,979 TFLOP/s is the sparse figure), HBM3, and NVLink 4
# (900 GB/s in all, 450 GB/s each direction)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # B/s
ICI_BW = 450e9                  # B/s per direction of the card's NVLink

# the next slice (ROADMAP.md section 1), named where a mesh axis above 1
# would have to shard a tensor
MODEL_AXIS_SLICE = ("sharding a tensor along a mesh axis above 1 waits for "
                    "model-axis execution through DTensor, the next slice "
                    "of ROADMAP.md section 1")


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


def place(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """``tree``'s tensors placed on ``mesh`` by ``specs`` (a tree of
    :class:`~repro_torch.models.common.P` of the same structure).  Where
    every axis a spec names has size 1 the tensor goes, whole, to the
    mesh's one device; an axis above 1 raises NotImplementedError."""
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
    for entry in spec:
        for name in _spec_axes(entry):
            if axis_size(mesh, name) > 1:
                raise NotImplementedError(
                    f"{path}: spec {spec} on mesh {mesh.mesh_dim_names} "
                    f"{tuple(mesh.shape)}: {MODEL_AXIS_SLICE}")
    return t.to(dev)
