"""Data-parallel training with int8 error-feedback gradient compression:
``repro/train/dp_compressed.py`` on ``torch.distributed``.

Pure data parallelism: every rank of the mesh's "data" axis holds the
whole state, takes its contiguous block of the global batch (the
reference's ``P("data", None)``), computes its loss and gradients with
:func:`repro_torch.train.step.value_and_grad`, averages the loss over the
axis's group, reduces the gradients with
:func:`repro_torch.optim.compression.error_feedback_allreduce` and applies
the in-place AdamW update.

Each rank's error feedback is its own: it quantises its own block's
gradients, so the ``ef`` states differ between ranks.  (The reference's
docstring calls them identical; its ``shard_map`` keeps one per device
all the same, ``PERF.md`` section 7.)
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import error_feedback_allreduce
from repro_torch.train.step import _batch_on, value_and_grad

# the record_function range around the compressed reduction, which a
# profiled step's trace reads the compression's device time by
COMPRESSION_RANGE = "error_feedback_allreduce"


def init_compressed_state(model, gen: torch.Generator) -> Dict[str, Any]:
    """Parameters drawn from ``gen``, AdamW's state, and the error
    feedback as float32 zeros shaped like the parameters."""
    params = model.init(gen)
    return {"params": params, "opt": adamw_init(params),
            "ef": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)}


def local_rows(batch: Dict[str, Any], rank: int, n: int) -> Dict[str, Any]:
    """Rank ``rank``'s block of each batch array: rows [r·B/n, (r+1)·B/n)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % n:
            raise ValueError(f"batch {k!r} of {b} rows does not split over "
                             f"{n} ranks")
        out[k] = v[rank * b // n:(rank + 1) * b // n]
    return out


def make_compressed_dp_train_step(model, opt_cfg: AdamWConfig,
                                  mesh: DeviceMesh) -> Callable:
    """(state, global batch) → (state, metrics) over ``mesh``'s "data"
    axis; state = {params, opt, ef}, updated in place.  Metrics are those
    of ``make_train_step`` (``loss`` averaged over the axis), tensors on
    the parameters' device."""
    group = mesh["data"].get_group()
    rank = mesh.get_local_rank("data")
    n = dist.get_world_size(group)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        dev = leaves(params)[0].device
        loss, grads = value_and_grad(
            model, params, _batch_on(local_rows(batch, rank, n), dev))
        dist.all_reduce(loss, group=group)
        loss = loss / torch.full((), float(n), device=dev)
        with torch.profiler.record_function(COMPRESSION_RANGE):
            grads, ef = error_feedback_allreduce(grads, state["ef"], group)
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"])
        return ({"params": params, "opt": opt, "ef": ef},
                {**metrics, "loss": loss})

    return train_step
