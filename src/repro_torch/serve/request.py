"""Inference requests and their modelled lifecycle.

A :class:`Request` is the unit the continuous-batching server admits,
batches and retires.  Its payload is deliberately the overlay's native
currency — a float32 *state vector* (the "embedded prompt") rather than
token ids — because the model-zoo pipelines the server drives are the
overlay-expressible pointwise datapaths of each family
(:mod:`repro_torch.serve.models`), and the bit-identity contract is stated on
those vectors: the final state of a request served in a continuous batch
must equal, bit for bit, the state of the same request served alone.

Timestamps live on the Session's modelled µs clock (the same clock the
command queues book engine time on), so request latency composes queue
wait + configuration charges + execution exactly like every other
modelled quantity in the stack.

Lifecycle::

    queued ──admit──▶ prefilling ──join──▶ decoding ──last step──▶ done
       │
       └─────── admission cap hit ──────────────────────────────▶ rejected

Join/leave happens only at decode-step boundaries (iteration-level,
ORCA-style): a request enters the running batch at the first boundary
after its prefill completes and leaves at the boundary where its final
decode step retires.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

# request states, in lifecycle order
QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
DONE = "done"
REJECTED = "rejected"

_rid_counter = itertools.count()


@dataclasses.dataclass(eq=False)       # identity semantics: a request is
class Request:                         # a ticket, not a value
    """One inference request against a served model.

    ``prompt`` is the request's input state vector; its length must match
    the served model's ``state_dim``.  ``decode_steps`` is how many decode
    iterations the request needs (its "generation length").
    """
    model: str
    prompt: np.ndarray
    decode_steps: int
    # SLO class name; None inherits the model tenant's class
    slo: Optional[str] = None
    t_arrival_us: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    # ----- runtime fields, owned by the server loop -----
    state: str = QUEUED
    t_admit_us: Optional[float] = None        # entered prefill
    t_first_step_us: Optional[float] = None   # first decode step retired
    t_done_us: Optional[float] = None         # final decode step retired
    steps_done: int = 0
    output: Optional[np.ndarray] = None       # final state vector

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.float32)
        if self.prompt.ndim != 1:
            raise ValueError(f"request {self.rid}: prompt must be a 1-D "
                             f"state vector, got shape {self.prompt.shape}")
        if self.decode_steps < 1:
            raise ValueError(f"request {self.rid}: decode_steps must be "
                             f">= 1, got {self.decode_steps!r}")
        if self.t_arrival_us < 0:
            raise ValueError(f"request {self.rid}: t_arrival_us must be "
                             f">= 0, got {self.t_arrival_us!r}")

    # ------------------------------------------------------------- modelling
    @property
    def finished(self) -> bool:
        return self.state in (DONE, REJECTED)

    @property
    def latency_us(self) -> Optional[float]:
        """Modelled end-to-end latency (arrival → final step), once done."""
        if self.t_done_us is None:
            return None
        return self.t_done_us - self.t_arrival_us

    @property
    def first_step_latency_us(self) -> Optional[float]:
        """Modelled arrival → first decode step (the TTFT analogue)."""
        if self.t_first_step_us is None:
            return None
        return self.t_first_step_us - self.t_arrival_us

    def __repr__(self) -> str:
        return (f"Request(#{self.rid} {self.model}/{self.slo or 'tenant'} "
                f"steps={self.steps_done}/{self.decode_steps} {self.state})")
