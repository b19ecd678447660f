"""One scenario, two packages: helpers for the port's runtime tests.

Each runtime test runs the same scenario through the JAX package ``repro``
and through ``repro_torch`` on the same numpy inputs, and compares what both
return.  :class:`Pkg` gives a scenario the modules of one package under
common names; on the port, arrays become Buffers on the CPU, so its
executor runs the plain PyTorch version.  ``repro``'s queues run
``run_reference`` in numpy (its default), the port's run the executor (its
default): outputs must agree bit for bit.
"""

from __future__ import annotations

import contextlib
import importlib
import threading

import numpy as np
import torch

_MODULES = ("analysis", "analysis.cli", "analysis.locklint",
            "configs.paper_suite", "core.cache", "core.dfg", "core.faults",
            "core.fuse", "core.graph", "core.jit", "core.options",
            "core.overlay", "core.queue", "core.recovery", "core.remote",
            "core.runtime", "core.session", "obs.export", "obs.metrics",
            "obs.profile", "obs.recut", "obs.trace", "parallel.pipeline",
            "serve", "serve.stagepar")


class Pkg:
    """The runtime modules of ``repro`` or ``repro_torch``."""

    def __init__(self, root: str):
        self.root = root
        self.is_port = root == "repro_torch"
        for name in _MODULES:
            setattr(self, name.split(".")[-1],
                    importlib.import_module(f"{root}.{name}"))
        self.BENCHMARKS = self.paper_suite.BENCHMARKS
        self.CompileOptions = self.options.CompileOptions
        self.OverlaySpec = self.overlay.OverlaySpec
        self.Device = self.runtime.Device
        self.Context = self.runtime.Context
        self.Scheduler = self.runtime.Scheduler
        self.JITCache = self.cache.JITCache

    def __repr__(self) -> str:
        return self.root

    def spec(self, width=8, height=8, dsp_per_fu=2):
        return self.OverlaySpec(width=width, height=height,
                                dsp_per_fu=dsp_per_fu)

    def buf(self, x):
        """A Buffer of ``x``: on the CPU in the port."""
        if self.is_port:
            return self.runtime.Buffer(x, device="cpu")
        return self.runtime.Buffer(x)

    def new_session(self, devices, **kw):
        """A Session whose arrays become CPU Buffers in the port."""
        if self.is_port:
            kw.setdefault("device", "cpu")
        return self.session.Session(devices, **kw)


@contextlib.contextmanager
def ordered_builds(sess):
    """Hold a one-worker Session's build pool until the block has submitted
    every build, release it, and wait until every build has landed.  Each
    build is then placed after every booking is made, in submission order,
    so placement is the same in every run and in both packages (the
    Scheduler ranks devices by the compile time booked toward them, and a
    build that starts while later ones are still being submitted sees a
    partial booking).  Waiting for the last build keeps a launch from
    racing a build that sheds a program the launch is about to enqueue."""
    gate = threading.Event()
    held = sess._pool.submit(gate.wait, 60)
    try:
        yield
    finally:
        gate.set()
        held.result(timeout=60)
        sess._pool.submit(lambda: None).result(timeout=600)


def freeze_clock(sess) -> None:
    """Pin a Session's host clock at 0 µs.  Compile events are stamped with
    the host clock, and a launch chains on its compile event, so with the
    host clock running the modelled timeline holds the wall time of each
    build.  Frozen, every event time is the queues' model alone, and the
    two packages must agree on it exactly."""
    sess.now_us = lambda: 0.0


@contextlib.contextmanager
def modelled_session(pkg, devices, device="cpu", **kw):
    """A one-worker Session with its host clock frozen (the port's on
    ``device``): with :func:`ordered_builds` around what it builds, its
    modelled timeline is the same in every run and in both packages."""
    if pkg.is_port:
        kw["device"] = device
    with pkg.session.Session(devices, max_workers=1, **kw) as sess:
        freeze_clock(sess)
        yield sess


R = Pkg("repro")
T = Pkg("repro_torch")


def both(scenario, *args, **kw):
    """``scenario(pkg, ...)`` for ``repro`` and then for the port."""
    return scenario(R, *args, **kw), scenario(T, *args, **kw)


def host(buffer) -> np.ndarray:
    """A Buffer's words as a numpy float32 array."""
    return np.asarray(buffer.read(), np.float32)


def assert_same_bits(got, want) -> None:
    """Bit-exact float32 equality; NaNs must sit at the same positions."""
    got = np.asarray(torch.as_tensor(np.asarray(got)), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got.view(np.int32)[~nan_g],
                                  want.view(np.int32)[~nan_w])


def event_times(ev) -> tuple:
    """Everything modelled about an Event: name, status and timestamps."""
    return (ev.kernel_name, ev.status, ev.t_queued_us, ev.t_submit_us,
            ev.config_us, ev.t_start_us, ev.t_end_us)


def event_record(ev) -> tuple:
    """:func:`event_times` plus the output words as int32 bits."""
    outs = tuple(host(b).view(np.int32).tobytes()
                 for b in (ev.outputs or ()))
    return event_times(ev) + (outs,)


class Near:
    """A float equal to another ``Near`` within ``tol`` (absolute), so
    records holding it still compare with ``==``."""

    __hash__ = None

    def __init__(self, value: float, tol: float = 1e-6):
        self.value, self.tol = float(value), tol

    def __eq__(self, other) -> bool:
        return isinstance(other, Near) and \
            abs(self.value - other.value) <= max(self.tol, other.tol)

    def __repr__(self) -> str:
        return f"Near({self.value!r})"


def session_event(ev) -> tuple:
    """What a Session event shares with ``repro``'s: the name, exec_us,
    config_us and the output bits.  Absolute times follow the host's wall
    clock through the compile events, so they are not compared; exec_us and
    config_us are differences of those times, so they are compared within
    1e-6 µs (the rounding of the absolute times, about 1e-11 µs, differs
    between two runs)."""
    outs = tuple(host(b).view(np.int32).tobytes()
                 for b in (ev.outputs or ()))
    return (ev.kernel_name, Near(ev.exec_us), Near(ev.config_us), outs)
