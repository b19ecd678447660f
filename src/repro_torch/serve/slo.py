"""Tenant SLO classes for the continuous-batching inference server.

Every served model is a *tenant* of the Session, and every tenant belongs
to one service class.  The class is the single place where a tenant's
treatment is decided:

  * ``priority`` feeds straight into :meth:`Session.set_priority` — it is
    what the Scheduler's replica shedding consults when the fabric is full
    (lowest priority sheds first), so a ``realtime`` model keeps its
    replicas while a ``batch`` model donates fabric under pressure;
  * ``max_queue`` caps ADMISSION: requests beyond the class's waiting-queue
    depth are rejected at submit time instead of silently growing an
    unbounded backlog (the modelled-latency percentile for the class would
    otherwise be meaningless);
  * ``target_p99_us`` is the class's modelled-latency objective.  The
    server does not *enforce* it (no request is killed for missing it),
    but it is *measured*: every completion whose end-to-end latency
    exceeds the target counts as an SLO violation — per class in
    ``Session.stats()["serving"]["slo_violations"]`` and, when a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` is attached to the
    Session, in the ``serving.slo_violations.<class>`` counters.  It
    also drives the replica autoscaling hints (a class running hot asks
    for more replicas before it misses).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: scheduling priority + admission + latency target."""
    name: str
    priority: int             # Session.set_priority / shed ordering
    target_p99_us: float      # modelled end-to-end latency objective
    max_queue: int            # admission cap on waiting requests per model

    def __post_init__(self) -> None:
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0, got {self.priority!r}")
        if self.target_p99_us <= 0:
            raise ValueError(f"target_p99_us must be > 0, "
                             f"got {self.target_p99_us!r}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, "
                             f"got {self.max_queue!r}")


# The default ladder.  Priorities are spaced so operators can slot custom
# classes between the rungs without renumbering.
REALTIME = SLOClass("realtime", priority=30, target_p99_us=250_000.0,
                    max_queue=16)
STANDARD = SLOClass("standard", priority=20, target_p99_us=1_000_000.0,
                    max_queue=64)
BATCH = SLOClass("batch", priority=10, target_p99_us=10_000_000.0,
                 max_queue=256)

SLO_CLASSES: Dict[str, SLOClass] = {c.name: c
                                    for c in (REALTIME, STANDARD, BATCH)}


def get_slo(name_or_class) -> SLOClass:
    """Resolve a class name (or pass an SLOClass through)."""
    if isinstance(name_or_class, SLOClass):
        return name_or_class
    try:
        return SLO_CLASSES[name_or_class]
    except KeyError:
        raise KeyError(f"unknown SLO class {name_or_class!r}; "
                       f"known: {sorted(SLO_CLASSES)}") from None
