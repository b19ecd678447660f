"""Multi-device stage parallelism for graph replay (GPipe wavefront).

A partitioned :class:`GraphExec` is already a *stage pipeline*: each
partition is one fused configuration, placed on its own device by the
makespan scheduler, with event edges between them.  A single launch
walks a request's data through the stages one after another — devices
holding later stages idle while earlier ones work.  ``launch_staged``
recovers the classic pipeline-parallel win on the modelled timeline by
splitting the input into microbatches and issuing one replay per
microbatch in the GPipe wavefront order
(:func:`repro_torch.parallel.pipeline.pipeline_schedule` — the same
schedule the JAX package's shard_map trainer executes with
collective_permute): microbatch m occupies stage s while m+1 occupies
s-1, and the per-device command queues model the overlap.  Idle fraction
follows :func:`~repro_torch.parallel.pipeline.bubble_fraction` =
(S-1)/(M+S-1).

Bit-identity: the serve pipelines are elementwise, so
``concat(stage(mb) for mb in split(x)) == stage(x)`` bit for bit —
microbatching never changes a request's numerics (asserted in
``tests/test_torch_serving.py``).

The microbatches are ``torch.tensor_split`` views of the input on its
device (a numpy input is copied to the Session's device once), and the
aggregate output is one ``torch.cat`` there; only the returned array is
read to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.queue import Event
from repro_torch.core.runtime import Buffer
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_schedule

__all__ = ["launch_staged", "pipeline_schedule", "bubble_fraction"]


def launch_staged(session, gexec, x, n_micro: int,
                  wait_for: Sequence[Event] = (),
                  tenant: Optional[str] = None
                  ) -> Tuple[Event, np.ndarray]:
    """Replay ``gexec`` over ``x`` as ``n_micro`` microbatches issued in
    GPipe wavefront order.  Returns ``(aggregate event, output array)``;
    the event's single output buffer holds the concatenated result,
    bit-identical to ``session.launch(gexec, x)``.

    ``n_micro`` is clamped to the number of elements; a single-output
    graph is required (the serve pipelines all are)."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro!r}")
    if len(gexec.graph.outputs) != 1:
        raise ValueError(f"launch_staged needs a single-output graph, "
                         f"{gexec.graph.name} has "
                         f"{len(gexec.graph.outputs)}")
    arr = Buffer(x, device=session.device).data
    n_micro = min(n_micro, max(1, arr.numel()))
    splits = torch.tensor_split(arr, n_micro)
    # stage-0 entry order of the wavefront == microbatch index order; the
    # schedule also fixes the step count the timeline should exhibit
    order = [m for (_t, s, m)
             in pipeline_schedule(n_micro, gexec.n_partitions) if s == 0]
    extern = tuple(wait_for)
    events = [None] * n_micro
    for m in order:
        events[m] = session.launch(gexec, splits[m], wait_for=extern,
                                   tenant=tenant)
    out = torch.cat([ev.outputs[0].data for ev in events]) \
        if n_micro > 1 else events[0].outputs[0].data
    t_end = max(ev.t_end_us for ev in events)
    agg = Event(kernel_name=f"graph:{gexec.graph.name}:staged",
                t_queued_us=0.0, t_submit_us=t_end, t_start_us=t_end,
                t_end_us=t_end, status="complete",
                outputs=(Buffer(out),), deps=tuple(events))
    return agg, agg.outputs[0].read()
