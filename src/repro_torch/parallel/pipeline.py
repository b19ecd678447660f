"""The GPipe microbatch schedule as pure functions.

The JAX package's module of the same name also holds
``make_pipeline_train_step`` (shard_map + collective_permute over the
'pod' axis).  The port keeps only the schedule and the bubble fraction,
which the overlay serving path (:mod:`repro_torch.serve.stagepar`) issues
its launches by; the pipelined trainer arrives with the parallelism item
of ROADMAP.md §1.
"""

from __future__ import annotations

from typing import List, Tuple


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
