"""The continuous-batching inference server over the Session API.

:class:`InferenceServer` serves the model zoo (:mod:`repro_torch.serve.models`)
with ORCA-style iteration-level scheduling on the modelled-µs timeline:

* **Admission** — ``submit()`` accepts a request if its SLO class's
  waiting-queue cap has room, else rejects it on the spot (a bounded
  queue is what makes the class's latency percentile meaningful).
* **Continuous batching** — per model, requests join the running batch
  at the first decode-step boundary after their arrival and leave at the
  boundary where their last step retires.  Joiners prefill together (one
  batched prefill launch gated on their arrival events), then every
  iteration is ONE batched decode launch over the concatenation of the
  members' state vectors.  Because every pipeline stage is elementwise,
  the batched launch is **bit-identical** to serving each request alone
  — asserted in ``tests/test_serve.py`` and gated in
  ``benchmarks/serving_perf.py``.
* **SLO classes** — each served model is a Session tenant in one
  :class:`~repro_torch.serve.slo.SLOClass`; the class's priority feeds
  :meth:`Session.set_priority` (replica shedding order) and decides the
  order models step each round, so a ``realtime`` tenant's iteration
  books engine time before a ``batch`` tenant's.
* **Autoscaling hints** — batch-occupancy EWMAs drive per-model replica
  hints; ``apply_autoscale()`` turns them into
  :meth:`ServedModel.resize` calls (template-stamp cheap).
* **Fault transparency** — launches ride the Session's healing ladder
  (retry → breaker → migrate → nodewise replay).  If a *batched* launch
  still fails, the server degrades that one iteration to per-request
  solo launches — same kernels, same states, bit-identical outputs —
  and counts it in ``degraded_steps`` (the request-level rung of
  ``docs/failure_model.md``).  Requests never observe the fault.

``serve_sequential`` is the request-at-a-time reference the benchmark
compares against: same graphs, same Session machinery, no batching.

States stay on the Session's device.  Joiners' prompts (numpy, as a
request carries them) are concatenated on the host and copied to the
device once per prefill launch; decode states are concatenated there with
``torch.cat``, each launch's output ``Buffer.data`` comes back as a
tensor, and ``torch.split`` views hand each member its slice.  A
request's state is read to the host once, when it retires.
"""

from __future__ import annotations

import threading
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core.queue import Event, user_event
from repro_torch.core.session import Session
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.batcher import ModelBatch, host_copy
from repro_torch.serve.models import ServedModel, build_zoo
from repro_torch.serve.request import (DONE, PREFILLING, QUEUED, REJECTED,
                                 Request)
from repro_torch.serve.slo import SLOClass, get_slo


# a launch's input: numpy prompts (host) or decode states (device tensors)
StateLike = Union[np.ndarray, torch.Tensor]


def _percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation drift)."""
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q / 100.0
                                                 * (len(ordered) - 1)))))
    return float(ordered[idx])


class InferenceServer:
    """Continuous-batching server for a set of served models (tenants).

    ``models`` maps model family -> SLO class name (or is an iterable of
    family names, all ``standard``).  One :class:`ModelBatch` per family
    runs the iteration loop; ``run()`` drives every admitted request to
    completion on the modelled timeline and returns the fleet makespan.
    """

    def __init__(self, session: Session, models, *,
                 max_batch: int = 8, max_replicas: int = 2,
                 max_partition_fus: Optional[int] = None,
                 ewma_alpha: float = 0.3, iter_quantum: int = 4):
        if not isinstance(models, Mapping):
            models = {name: "standard" for name in models}
        if iter_quantum < 1:
            raise ValueError(f"iter_quantum must be >= 1, "
                             f"got {iter_quantum!r}")
        self.session = session
        self.max_batch = max_batch
        # consecutive boundaries one tenant runs before the scheduler moves
        # on: tenants sharing a device thrash its configuration when they
        # strictly alternate, so chunking iterations amortizes the
        # reconfiguration charge (joins still happen at EVERY boundary —
        # the quantum changes device-timeline interleaving, not admission)
        self.iter_quantum = iter_quantum
        self._lock = threading.RLock()
        self.zoo: Dict[str, ServedModel] = build_zoo(
            session, list(models), max_replicas=max_replicas,
            max_partition_fus=max_partition_fus)
        self._model_slo: Dict[str, SLOClass] = {
            name: get_slo(cls) for name, cls in models.items()}
        self._batches: Dict[str, ModelBatch] = {
            name: ModelBatch(m, max_batch, ewma_alpha)
            for name, m in self.zoo.items()}
        # step order: SLO priority descending, name as the tie-break —
        # the realtime tenant's iteration books engine time first
        self._order: List[str] = sorted(
            self.zoo, key=lambda n: (-self._model_slo[n].priority, n))
        for name, cls in self._model_slo.items():
            session.set_priority(name, cls.priority)
        # dashboard counters (stats()["serving"])
        self._requests: List[Request] = []  # lock: _lock
        self._admitted = 0  # lock: _lock
        self._completed = 0  # lock: _lock
        self._rejected = 0  # lock: _lock
        self._degraded_steps = 0  # lock: _lock
        self._latencies: Dict[str, List[float]] = {}  # lock: _lock
        # completions whose end-to-end latency exceeded their class's
        # target_p99_us, keyed by class name (stats()["serving"] + obs)
        self._slo_violations: Dict[str, int] = {}  # lock: _lock
        session.register_stats_section("serving", self._stats_section)

    # -------------------------------------------------------------- intake
    def slo_of(self, req: Request) -> SLOClass:
        """The class a request is served under: its own, else its model
        tenant's."""
        return get_slo(req.slo) if req.slo else self._model_slo[req.model]

    def submit(self, req: Request) -> bool:
        """Admit or reject a request (True = admitted).  Rejection is the
        SLO class's waiting-queue cap — a full class sheds load at the
        door instead of growing an unbounded backlog."""
        with self._lock:
            return self._submit_locked(req)

    def _submit_locked(self, req: Request) -> bool:  # lock: held(_lock)
        if req.model not in self._batches:
            raise KeyError(f"unknown served model {req.model!r}; "
                           f"serving: {sorted(self._batches)}")
        batch = self._batches[req.model]
        if req.prompt.size != batch.model.state_dim:
            raise ValueError(
                f"request {req.rid}: prompt dim {req.prompt.size} != "
                f"{req.model} state_dim {batch.model.state_dim}")
        cls = self.slo_of(req)
        if len(batch.waiting) >= cls.max_queue:
            req.state = REJECTED
            self._rejected += 1
            self._requests.append(req)
            return False
        req.state = QUEUED
        batch.admit(req)
        self._admitted += 1
        self._requests.append(req)
        return True

    def batch(self, model: str) -> ModelBatch:
        """The model's running batch (inspection / tests)."""
        return self._batches[model]

    # ----------------------------------------------------------- iteration
    def step(self) -> bool:
        """One boundary iteration across every active model, in SLO
        priority order.  Returns False when nothing was left to do."""
        with self._lock:
            progressed = False
            for name in self._order:
                b = self._batches[name]
                for _ in range(self.iter_quantum):
                    if not b.active:
                        break
                    progressed = self._step_model(b) or progressed
            return progressed

    def run(self) -> float:
        """Drive every admitted request to completion; returns the
        modelled makespan (µs): the latest request completion."""
        while self.step():
            pass
        with self._lock:
            return max((r.t_done_us for r in self._requests
                        if r.t_done_us is not None), default=0.0)

    def _step_model(self, batch: ModelBatch) -> bool:  # lock: held(_lock)
        # the serving loop is the outermost boundary: activate the
        # session's tracer here so launches (and their compile/cache/queue
        # probes) nest under the serving iteration
        with obs_trace.activate(self.session.tracer), \
                obs_trace.span(f"serve:step:{batch.model.name}",
                               "serving") as _sp:
            progressed = self._step_model_traced(batch, _sp)
            _sp["progressed"] = progressed
            return progressed

    def _step_model_traced(self, batch: ModelBatch,
                           _sp) -> bool:  # lock: held(_lock)
        model = batch.model
        now = batch.t_us
        if not batch.members:
            # idle tenant: the next boundary is the next arrival
            nxt = batch.next_arrival_us()
            if nxt is not None and nxt > now:
                now = nxt
                batch.t_us = now
        joiners = batch.take_joiners(now)
        _sp["joined"] = len(joiners)
        deps: List[Event] = []
        if batch.last_event is not None:
            deps.append(batch.last_event)
        if joiners:
            # one batched prefill for everyone joining at this boundary,
            # gated on their modelled arrival instants
            arrivals = tuple(user_event(r.t_arrival_us,
                                        name=f"arrive:#{r.rid}")
                             for r in joiners)
            for r in joiners:
                r.state = PREFILLING
                r.t_admit_us = now
            ev, out = self._launch_batched(
                model.prefill_exec, [r.prompt for r in joiners], arrivals)
            for r, state in zip(joiners,
                                _split(out, [r.prompt.size
                                             for r in joiners])):
                batch.join(r, state)
            deps.append(ev)
        if not batch.members:
            return False
        sizes = [s.numel() for s in batch.states]
        ev, out = self._launch_batched(model.decode_exec, batch.states,
                                       tuple(deps))
        batch.states = _split(out, sizes)
        for r in batch.members:
            r.steps_done += 1
            if r.steps_done == 1:
                r.t_first_step_us = ev.t_end_us
        batch.note_iteration(ev)
        for r in batch.retire_finished():
            r.state = DONE
            r.t_done_us = ev.t_end_us
            self._completed += 1
            cls = self.slo_of(r)
            self._latencies.setdefault(cls.name, []).append(r.latency_us)
            if cls.target_p99_us > 0 and r.latency_us > cls.target_p99_us:
                self._slo_violations[cls.name] = \
                    self._slo_violations.get(cls.name, 0) + 1
                metrics = self.session.metrics
                if metrics is not None:
                    metrics.counter(
                        f"serving.slo_violations.{cls.name}").inc()
        return True

    def _launch_batched(self, gexec, states: Sequence[StateLike],
                        deps: Tuple[Event, ...]
                        ) -> Tuple[Event, torch.Tensor]:  # lock: held(_lock)
        """One batched launch over the concatenated states; on a launch
        the Session's own healing ladder could not save, degrade THIS
        iteration to per-request solo launches (bit-identical — the
        stages are elementwise) and count the degradation.  ``states``
        are the joiners' numpy prompts (one host-to-device copy of their
        concatenation) or decode states on the device; the output is a
        tensor on the device."""
        sess = self.session
        tenant = gexec.tenant
        try:
            ev = sess.launch(gexec, _concat(states), wait_for=deps,
                             tenant=tenant)
            return ev, ev.outputs[0].data
        except Exception:
            self._degraded_steps += 1
        outs: List[torch.Tensor] = []
        t_end = max((d.t_end_us for d in deps), default=0.0)
        for s in states:
            ev = sess.launch(gexec, s, wait_for=deps, tenant=tenant)
            outs.append(ev.outputs[0].data)
            t_end = max(t_end, ev.t_end_us)
        agg = user_event(t_end, name=f"graph:{gexec.graph.name}:degraded")
        return agg, _concat(outs)

    # ---------------------------------------------------------- autoscaling
    def autoscale_hints(self) -> Dict[str, int]:
        """Per-model replica hints from the occupancy EWMAs (+1 scale up,
        -1 scale down, 0 hold)."""
        with self._lock:
            return {name: b.scale_hint()
                    for name, b in self._batches.items()}

    def apply_autoscale(self, step: int = 2,
                        ceiling: int = 8) -> Dict[str, int]:
        """Actuate the hints: resize each hinted model's replica cap by
        ``step`` within [1, ceiling].  Returns the new caps.  Resizing
        re-instantiates through the template cache (a stamp, not a
        re-anneal), so it is safe between iterations."""
        with self._lock:
            caps = {}
            for name, b in self._batches.items():
                hint = b.scale_hint()
                cap = b.model.max_replicas
                if hint > 0:
                    cap = min(ceiling, cap + step)
                elif hint < 0:
                    cap = max(1, cap - step)
                if cap != b.model.max_replicas:
                    b.model.resize(cap)
                caps[name] = cap
            return caps

    # ------------------------------------------------------------ dashboard
    def _stats_section(self) -> dict:
        """The ``stats()["serving"]`` blob (registered on the Session)."""
        with self._lock:
            latencies = {cls: list(v) for cls, v in self._latencies.items()}
            models = {}
            for name, b in self._batches.items():
                models[name] = dict(
                    slo=self._model_slo[name].name,
                    priority=self._model_slo[name].priority,
                    iterations=b.iterations,
                    occupancy_ewma=b.occupancy_ewma,
                    waiting=len(b.waiting),
                    decoding=len(b.members),
                    max_replicas=b.model.max_replicas,
                    scale_hint=b.scale_hint(),
                )
            out = dict(admitted=self._admitted,
                       completed=self._completed,
                       rejected=self._rejected,
                       degraded_steps=self._degraded_steps,
                       slo_violations=dict(
                           sorted(self._slo_violations.items())),
                       models=models)
        out["latency_us"] = {
            cls: dict(n=len(v), p50=_percentile(v, 50.0),
                      p99=_percentile(v, 99.0))
            for cls, v in latencies.items() if v}
        return out

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Release every served model's fabric (idempotent)."""
        for m in self.zoo.values():
            m.release()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"InferenceServer({', '.join(self._order)}; "
                f"max_batch={self.max_batch})")


def _concat(states: Sequence[StateLike]) -> StateLike:
    """One launch's input: numpy prompts concatenated on the host, device
    states with ``torch.cat`` where they lie."""
    if len(states) == 1:
        return states[0]
    if isinstance(states[0], np.ndarray):
        return np.concatenate(states)
    return torch.cat(list(states))


def _split(arr: torch.Tensor, sizes: List[int]) -> List[torch.Tensor]:
    """Split a concatenated batch back into per-request state vectors:
    views of ``arr``, no copy."""
    if len(sizes) == 1:
        return [arr]
    return list(torch.split(arr, sizes))


def serve_sequential(session: Session, zoo: Mapping[str, ServedModel],
                     requests: Iterable[Request]
                     ) -> Tuple[Dict[int, np.ndarray], float]:
    """The request-at-a-time reference: requests served strictly one after
    another in arrival order — each prefill gated on the request's arrival
    AND the previous request's completion, then its decode steps chained
    solo.  Same graphs, same Session machinery, no batching.  Returns
    (per-rid final states, modelled makespan µs).  This is both the
    bit-identity oracle for the tests and the throughput baseline the
    serving benchmark gates against.  Each request's state stays on the
    Session's device between steps and is read to the host once, after
    its last step."""
    outputs: Dict[int, np.ndarray] = {}
    prev: Optional[Event] = None
    makespan = 0.0
    for req in sorted(requests, key=lambda r: (r.t_arrival_us, r.rid)):
        model = zoo[req.model]
        deps: Tuple[Event, ...] = (
            user_event(req.t_arrival_us, name=f"arrive:#{req.rid}"),)
        if prev is not None:
            deps = deps + (prev,)
        ev = session.launch(model.prefill_exec, req.prompt, wait_for=deps,
                            tenant=model.name)
        state = ev.outputs[0].data
        for _ in range(req.decode_steps):
            ev = session.launch(model.decode_exec, state, wait_for=(ev,),
                                tenant=model.name)
            state = ev.outputs[0].data
        outputs[req.rid] = host_copy(state)
        makespan = max(makespan, ev.t_end_us)
        prev = ev
    return outputs, makespan
