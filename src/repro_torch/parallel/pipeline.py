"""Pipeline parallelism: the GPipe microbatch schedule as pure functions,
and the pipelined forward over ``torch.distributed`` ranks.

The model's layer stack is split into ``n_stages`` contiguous groups, one
a rank of the stage axis; activations flow stage to stage around a ring
of point-to-point sends; microbatches keep every stage busy (bubble
fraction (S-1)/(M+S-1)).  :func:`pipeline_schedule` and
:func:`bubble_fraction` are the schedule as data, which the overlay
serving path (:mod:`repro_torch.serve.stagepar`) issues its launches by.

:func:`make_pipeline_train_step` is the forward only (the inference and
evaluation case), as the reference's is whatever its name says.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import leaves, tree_map


def pipeline_schedule(n_micro: int,
                      n_stages: int) -> List[Tuple[int, int, int]]:
    """The GPipe forward schedule as data: ``(step, stage, microbatch)``
    triples in execution order — microbatch m occupies stage s at step
    ``m + s``, for ``n_micro + n_stages - 1`` steps total.  Exposed as a
    pure function so the overlay serving path
    (:mod:`repro_torch.serve.stagepar`) can issue its per-partition
    launches in wavefront order on the modelled timeline, and so tests can
    assert the shape of the schedule without a mesh."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError(f"n_micro and n_stages must be >= 1, got "
                         f"{n_micro!r}, {n_stages!r}")
    sched = []
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                sched.append((t, s, m))
    return sched


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe wavefront: (S-1)/(M+S-1)."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError(f"n_micro and n_stages must be >= 1, got "
                         f"{n_micro!r}, {n_stages!r}")
    return (n_stages - 1) / (n_micro + n_stages - 1)


def make_pipeline_train_step(layer_fn: Callable, n_stages: int,
                             n_micro: int, mesh: DeviceMesh,
                             stage_axis: str = "data") -> Callable:
    """A pipelined forward over the ranks of ``mesh``'s ``stage_axis``
    (``n_stages`` of them), the reference's GPipe wavefront.

    layer_fn(carry, layer_params) -> carry: one layer applied to a
    microbatch's activations of shape (mb, ...).

    The returned fn takes, on each rank:
      stage_params: the rank's block of the stage-stacked layer
                    parameters, a tree of leading dims (1,
                    layers_per_stage, ...) (the reference's
                    ``P(stage_axis)`` shard, as ``shard_map`` hands it)
      x:            (n_micro, mb, ...) microbatched activations, the same
                    on every rank
    and returns the (n_micro, mb, ...) output on every rank.

    At step t stage 0 feeds microbatch t (t < n_micro); every other stage
    feeds what arrived from its predecessor; each stage's output goes to
    the next stage around the ring ``i → (i+1) % n`` by
    ``batch_isend_irecv`` (with one stage, the identity: no send); the
    last stage records microbatch t - (n_stages - 1), and an all-reduce
    of the outputs times a mask hands them to every rank."""
    group = mesh[stage_axis].get_group()
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages on a {stage_axis!r} axis of "
                         f"{dist.get_world_size(group)} ranks")
    sid = mesh.get_local_rank(stage_axis)
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)

    def apply_stage(act, layers):
        for i in range(leaves(layers)[0].shape[0]):
            act = layer_fn(act, tree_map(lambda a: a[i], layers))
        return act

    def run(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        layers = tree_map(lambda a: a[0], stage_params)
        outputs = torch.zeros_like(x)
        inflight = torch.zeros_like(x[0])
        for t in range(n_micro + n_stages - 1):
            feed = x[t] if sid == 0 and t < n_micro else inflight
            out = apply_stage(feed, layers)
            if n_stages == 1:
                inflight = out
            else:
                inflight = torch.empty_like(out)
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, out, nxt, group),
                        dist.P2POp(dist.irecv, inflight, prv, group)]):
                    req.wait()
            done = t - (n_stages - 1)
            if sid == n_stages - 1 and 0 <= done < n_micro:
                outputs[done] = out
        mask = torch.full((), float(sid == n_stages - 1), dtype=x.dtype,
                          device=x.device)
        outputs.mul_(mask)
        dist.all_reduce(outputs, group=group)
        return outputs

    return run

