"""A replica shed racing a build on the same device (fault F2).

``Scheduler._resize`` releases its victim, rebuilds it at fewer replicas
and then swaps the new artifact in, or, when the rebuild fails, restores
the victim and re-debits its fabric.  ``Context.build_program`` on another
thread takes only the device's ledger lock, so when the resize let go of
that lock between the release and the swap or restore, the other build
could plan against, and debit, the victim's freed fabric: the restore's
re-debit then raised ``RuntimeError_`` and the ledger no longer matched
the resident programs.  The port holds the ledger lock from the release to
the swap or restore; the JAX package keeps the fault.

The tests are deterministic, with no timing stress.  The ``jit_compile``
that the runtime calls is patched so that the victim's rebuild blocks on a
``threading.Event``; the second build starts while it is blocked; the
device's ledger lock is replaced by :class:`HandoffLock`, which hands the
lock to the waiting build at the first moment the resizing thread lets go
of it, so any window in which the resize does is taken.  Every wait and
join has a timeout: a deadlock fails, it does not hang.
"""

import importlib
import threading

import pytest

from torch_runtime_pair import Pkg

T, R = Pkg("repro_torch"), Pkg("repro")
TIMEOUT = 30.0


class HandoffLock:
    """A reentrant lock that, when its holder lets go of it while the
    ``watched`` thread waits for it, waits (up to TIMEOUT) until that
    thread has it.  ``waiting`` is set when the watched thread asks for
    the lock while another thread holds it."""

    def __init__(self):
        self._lock = threading.RLock()
        self._owner = None
        self._depth = 0
        self.watched = None
        self.waiting = threading.Event()
        self.got = threading.Event()

    def acquire(self):
        me = threading.current_thread()
        if me is self.watched and self._owner not in (None, me):
            self.waiting.set()
        assert self._lock.acquire(timeout=TIMEOUT), "ledger lock deadlock"
        self._owner = me
        self._depth += 1
        if me is self.watched:
            self.got.set()

    def release(self):
        self._depth -= 1
        last = self._depth == 0
        if last:
            self._owner = None
        self._lock.release()
        if last and self.waiting.is_set() and \
                threading.current_thread() is not self.watched:
            assert self.got.wait(TIMEOUT), "the waiting build never ran"

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def _race(pkg, monkeypatch, rebuild_fails: bool):
    """sgfilter at 4 of its replicas on one 8x8 device; a thread sheds it
    to 2 (its rebuild blocked, then failing or not) while another builds
    chebyshev at as many replicas as fit → what each thread saw."""
    sched = pkg.Scheduler([pkg.Device("d", pkg.spec())])
    ctx = sched.contexts["d"]
    opts = pkg.CompileOptions
    victim = sched.build_opts(pkg.BENCHMARKS["sgfilter"][0],
                              opts(max_replicas=4))
    assert victim.compiled.plan.replicas == 4
    lock = ctx.lock = HandoffLock()
    started, go = threading.Event(), threading.Event()
    seen = {}
    real = pkg.runtime.jit_compile
    place_error = importlib.import_module(
        f"{pkg.root}.core.place").PlacementError

    def jit_compile(source, spec, **kw):
        me = threading.current_thread()
        if me is resize_thread:
            started.set()
            assert go.wait(TIMEOUT), "the test never released the rebuild"
            if rebuild_fails:
                raise place_error("planted: the shed's rebuild fails")
        elif me is build_thread:
            # where the victim stands when the second build plans
            seen["victim_resident"] = (not victim.released
                                       and victim in ctx.programs)
            seen["fu_used_when_planned"] = ctx.device.fu_used
        return real(source, spec, **kw)

    monkeypatch.setattr(pkg.runtime, "jit_compile", jit_compile)

    def shed():
        try:
            seen["resized"] = sched._resize(victim, ctx, 2,
                                            require_growth=False)
        except Exception as e:  # noqa: BLE001 - the fault under test
            seen["resize_error"] = e

    def build():
        try:
            seen["second"] = ctx.build_program(
                pkg.BENCHMARKS["chebyshev"][0], opts=opts())
        except Exception as e:  # noqa: BLE001
            seen["build_error"] = e

    resize_thread = threading.Thread(target=shed, name="resize")
    build_thread = threading.Thread(target=build, name="build")
    lock.watched = build_thread
    resize_thread.start()
    assert started.wait(TIMEOUT), "the shed never reached its rebuild"
    build_thread.start()
    assert lock.waiting.wait(TIMEOUT), "the build never waited on the ledger"
    go.set()
    for t in (resize_thread, build_thread):
        t.join(TIMEOUT)
        assert not t.is_alive(), f"{t.name} deadlocked"
    seen["ledger"] = (ctx.device.fu_used, ctx.device.io_used)
    seen["resident_sum"] = (
        sum(p.compiled.plan.fus_used for p in ctx.programs),
        sum(p.compiled.plan.io_used for p in ctx.programs))
    seen["victim_replicas"] = victim.compiled.plan.replicas
    seen["victim_released"] = victim.released
    return seen


@pytest.mark.parametrize("rebuild_fails", [True, False],
                         ids=["rebuild fails: restore", "rebuild: swap"])
def test_a_build_racing_a_shed_waits_for_it(monkeypatch, rebuild_fails):
    """The second build plans only once the victim is resident again
    (restored at 4 replicas or swapped in at 2), nothing raises, and the
    ledger equals the sum over the resident programs."""
    seen = _race(T, monkeypatch, rebuild_fails)
    assert "resize_error" not in seen and "build_error" not in seen, seen
    assert seen["resized"] is not rebuild_fails
    assert seen["victim_resident"], "the build landed inside the resize"
    assert seen["victim_replicas"] == (4 if rebuild_fails else 2)
    assert seen["fu_used_when_planned"] == 7 * seen["victim_replicas"]
    assert seen["ledger"] == seen["resident_sum"]
    assert not seen["victim_released"]
    assert seen["second"].compiled.plan.replicas >= 1


def test_the_reference_keeps_the_fault(monkeypatch):
    """The same schedule through the JAX package: the second build takes
    the freed fabric while the failed rebuild's restore waits, the
    restore's re-debit raises, and the tenant's program is left released
    (the reference is not edited)."""
    seen = _race(R, monkeypatch, rebuild_fails=True)
    assert isinstance(seen.get("resize_error"), R.runtime.RuntimeError_)
    assert "exceeds free" in str(seen["resize_error"])
    assert not seen["victim_resident"] and seen["victim_released"]
