"""Continuous batch assembly (ORCA-style iteration-level scheduling).

One :class:`ModelBatch` per served model holds the model's *running
batch*: the requests currently decoding together, their per-request
state vectors, and the Event of the last batched iteration on the
modelled-µs timeline.  Requests join and leave ONLY at decode-step
boundaries — a joiner enters at the first boundary after its arrival
time, a finished request leaves at the boundary where its final step
retires — so the batch's composition is constant within an iteration
and every member advances exactly one decode step per iteration.

Concurrency contract: a ModelBatch is owned by its
:class:`~repro_torch.serve.server.InferenceServer` and every field is guarded
by the *server's* ``_lock`` (declared ``any(_lock)`` because the batch
is reached both through the server's step loop and through the stats
provider it registers on the Session).  Methods below are annotated
``held(_lock)`` accordingly: callers hold the server lock.

States stay on the Session's device: ``states`` holds tensors (views of
the last batched launch's output), and a request's state is read to the
host once, when it retires, into ``Request.output``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.queue import Event
from repro_torch.serve.models import ServedModel
from repro_torch.serve.request import DECODING, Request


def host_copy(state: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of a state tensor (a device-to-host read)."""
    return state.detach().cpu().numpy().copy()


class ModelBatch:
    """The running batch of one served model (see module docstring)."""

    def __init__(self, model: ServedModel, max_batch: int,
                 ewma_alpha: float = 0.3):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch!r}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {ewma_alpha!r}")
        self.model = model
        self.max_batch = max_batch
        self.ewma_alpha = ewma_alpha
        # admitted but not yet joined, kept in arrival order
        self.waiting: List[Request] = []  # lock: any(_lock)
        # decoding this iteration; states[i] is members[i]'s current vector
        self.members: List[Request] = []  # lock: any(_lock)
        self.states: List[torch.Tensor] = []  # lock: any(_lock)
        # modelled time of the last completed iteration boundary, and the
        # Event that defined it (next iteration chains on it)
        self.t_us = 0.0  # lock: any(_lock)
        self.last_event: Optional[Event] = None  # lock: any(_lock)
        self.iterations = 0  # lock: any(_lock)
        self.occupancy_ewma = 0.0  # lock: any(_lock)

    # --------------------------------------------------------------- intake
    def admit(self, req: Request) -> None:  # lock: held(_lock)
        """Accept an admitted request into the waiting queue (arrival
        order; admission policy — SLO caps — is the server's job)."""
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.t_arrival_us, r.rid))

    def take_joiners(self, now_us: float) -> List[Request]:  # lock: held(_lock)
        """Pop the requests that join at THIS boundary: arrived by
        ``now_us``, oldest first, up to the batch-size room left."""
        room = self.max_batch - len(self.members)
        join: List[Request] = []
        while self.waiting and len(join) < room \
                and self.waiting[0].t_arrival_us <= now_us:
            join.append(self.waiting.pop(0))
        return join

    def join(self, req: Request,
             state: torch.Tensor) -> None:  # lock: held(_lock)
        """Seat a prefilled request in the running batch; ``state`` stays
        where it lies (a float32 tensor on the Session's device)."""
        req.state = DECODING
        self.members.append(req)
        self.states.append(state)

    # ------------------------------------------------------------ iteration
    def note_iteration(self, ev: Event) -> None:  # lock: held(_lock)
        """Advance the boundary clock past a completed iteration and fold
        the batch occupancy into the EWMA the autoscaler watches."""
        self.t_us = max(self.t_us, ev.t_end_us)
        self.last_event = ev
        self.iterations += 1
        occ = len(self.members) / self.max_batch
        a = self.ewma_alpha
        self.occupancy_ewma = occ if self.iterations == 1 \
            else (1.0 - a) * self.occupancy_ewma + a * occ

    def retire_finished(self) -> List[Request]:  # lock: held(_lock)
        """Remove members whose final decode step just retired (leave at
        the boundary); their latest state vector becomes their output —
        a host copy, the request's only read from the device."""
        done: List[Request] = []
        keep_m: List[Request] = []
        keep_s: List[torch.Tensor] = []
        for req, state in zip(self.members, self.states):
            if req.steps_done >= req.decode_steps:
                req.output = host_copy(state)
                done.append(req)
            else:
                keep_m.append(req)
                keep_s.append(state)
        self.members = keep_m
        self.states = keep_s
        return done

    # ------------------------------------------------------------- modelling
    @property
    def active(self) -> bool:
        """Anything left to drive: members mid-decode or arrivals queued."""
        return bool(self.members or self.waiting)

    def next_arrival_us(self) -> Optional[float]:
        return self.waiting[0].t_arrival_us if self.waiting else None

    def scale_hint(self) -> int:
        """Replica autoscaling hint from the occupancy EWMA: +1 when the
        batch runs hot with a backlog (more replicas would raise the
        decode rate), -1 when it runs cold above one replica (donate
        fabric), else 0.  Advisory — the server's ``apply_autoscale``
        or an operator turns hints into :meth:`ServedModel.resize`."""
        if self.occupancy_ewma > 0.75 and self.waiting:
            return 1
        if self.occupancy_ewma < 0.25 and self.iterations > 0 \
                and self.model.max_replicas > 1:
            return -1
        return 0

    def __repr__(self) -> str:
        return (f"ModelBatch({self.model.name}: {len(self.members)}/"
                f"{self.max_batch} decoding, {len(self.waiting)} waiting, "
                f"it={self.iterations}, occ={self.occupancy_ewma:.2f})")
