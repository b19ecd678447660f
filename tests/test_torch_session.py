"""The port's Session against the JAX package's.

Each scenario runs through ``repro.core.session.Session`` and through
``repro_torch``'s on the same numpy inputs.  Compile events carry the
host's wall clock, so absolute event times differ between two runs; what
must be equal is each event's modelled ``exec_us`` and ``config_us``, the
configuration charges, the ledgers, the partitions, the cache and recovery
counters, and every output bit (tolerance 0).  The port's Session makes
arrays into Buffers on its ``device`` (here the CPU) and runs the overlay
executor; ``repro``'s runs ``run_reference`` in numpy.

The cases are those of ``tests/test_session.py``, the Session cases of
``tests/test_faults.py`` (device loss, healing, requeue, hedged builds)
and the threaded ledger cases of ``tests/test_threaded_ledger.py``.
"""

import copy
import random
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.runtime import Buffer
from repro_torch.kernels.overlay_exec import ops
from torch_runtime_pair import (T, assert_same_bits, both, host,
                                session_event)

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

X = np.linspace(-2, 2, 512).astype(np.float32)
POLY1_REF = ((3 * X + 5) * X - 7) * X + 9


def _fast(pkg):
    """Retry fast in tests: microsecond backoff, short breaker cooldown."""
    return pkg.recovery.RetryPolicy(backoff_us=50.0, max_backoff_us=500.0,
                                    breaker_cooldown_s=0.02)


def _devices(pkg, *names, spec=None):
    return [pkg.Device(n, spec or pkg.spec()) for n in names]


def _src(pkg, name):
    return pkg.BENCHMARKS[name][0]


def _roundtrip(pkg, sess, opts=None, tenant=None):
    fut = sess.compile(_src(pkg, "poly1"),
                       opts or pkg.CompileOptions(max_replicas=4),
                       tenant=tenant)
    ev = sess.enqueue(fut, X)
    np.testing.assert_allclose(host(ev.wait()[0]), POLY1_REF,
                               rtol=1e-4, atol=1e-4)
    return fut, ev


def _summary(sess) -> dict:
    """What a Session run shares with ``repro``'s."""
    st = sess.stats()
    out = dict(cache=st["cache"], config=st["config"],
               recovery=st["recovery"], ledger=sess.ledger(),
               consistent=sess.ledger_consistent())
    for key in ("disk", "faults"):
        if key in st:
            out[key] = st[key]
    return out


# ------------------------------------------------------------- Session API

def _single_flight(pkg):
    with pkg.new_session(_devices(pkg, "a"), max_workers=1) as sess:
        gate = threading.Event()
        sess._pool.submit(gate.wait, 30)        # occupy the only worker
        opts = pkg.CompileOptions(max_replicas=2)
        f1 = sess.compile(_src(pkg, "poly1"), opts, tenant="t1")
        f2 = sess.compile(_src(pkg, "poly1"), opts, tenant="t2")
        assert not f1.done() and not f2.done()
        assert sess.cache.stats.misses == 0
        gate.set()
        assert f1.result(60) is f2.result(60)
        g1 = sess.compile(_src(pkg, "poly1"), pkg.CompileOptions(
            max_replicas=1)).result(60)
        assert g1 is not f1.result()
        return _summary(sess), g1.compiled.plan.replicas


def _build_error(pkg):
    with pkg.new_session(_devices(pkg, "t", spec=pkg.spec(2, 2)),
                         retry=_fast(pkg)) as sess:
        fut = sess.compile(_src(pkg, "mibench"),
                           pkg.CompileOptions(retry_budget=5))
        assert isinstance(fut, pkg.session.KernelFuture)
        with pytest.raises(pkg.runtime.SchedulerError):
            fut.result(60)
        return _summary(sess)


def _chained_enqueue(pkg):
    with pkg.new_session(_devices(pkg, "a")) as sess:
        fut = sess.compile(_src(pkg, "poly1"),
                           pkg.CompileOptions(max_replicas=4))
        ev = sess.enqueue(fut, X)
        ce = fut.compile_event()
        assert ce.t_end_us > 0.0 and fut.compile_us > 0.0
        assert ev.t_submit_us >= ce.t_end_us and ce in ev.deps
        return session_event(ev), _summary(sess)


def _warm_compile(pkg):
    cache = pkg.JITCache()
    with pkg.new_session(_devices(pkg, "a"), cache=cache) as sess:
        opts = pkg.CompileOptions(max_replicas=4)
        cold = sess.compile(_src(pkg, "chebyshev"), opts)
        cold.result(60).release()
        warm = sess.compile(_src(pkg, "chebyshev"), opts)
        assert warm.result(60).compiled is cold.result().compiled
        return _summary(sess)


def _tenant_queues(pkg):
    with pkg.new_session(_devices(pkg, "a")) as sess:
        prog = sess.build(_src(pkg, "poly1"),
                          pkg.CompileOptions(max_replicas=4))
        ea = sess.enqueue(prog, X, tenant="ta")
        eb = sess.enqueue(prog, X, tenant="tb")
        qa, qb = sess.queue_for("ta", "a"), sess.queue_for("tb", "a")
        assert qa is not qb and qa.tenant == "ta"
        spans = sorted((e.t_submit_us, e.t_end_us) for e in (ea, eb))
        assert spans[1][0] >= spans[0][1] - 1e-9
        assert sess.finish() >= max(ea.t_end_us, eb.t_end_us)
        with pytest.raises(pkg.session.SessionError):
            sess.queue_for("ta", "a", in_order=True)
        return [session_event(e) for e in (ea, eb)], _summary(sess)


def _placement(pkg, policy):
    with pkg.new_session(_devices(pkg, "a", "b"), policy=policy) as sess:
        sess.contexts["b"].reserve(fus=8)
        pa = sess.build(_src(pkg, "poly1"),
                        pkg.CompileOptions(max_replicas=2), tenant="t1")
        evs = [sess.enqueue(pa, X, tenant="t1") for _ in range(20)]
        pb = sess.build(_src(pkg, "chebyshev"),
                        pkg.CompileOptions(max_replicas=2), tenant="t2")
        return (pa.ctx.device.name, pb.ctx.device.name,
                [session_event(e) for e in evs], _summary(sess))


def _makespan_policy(pkg):
    return _placement(pkg, "makespan")


def _free_fabric_policy(pkg):
    return _placement(pkg, "free_fabric")


def _estimates(pkg):
    sched = pkg.Scheduler(_devices(pkg, "a", "b"))
    first = sched._ranked()[0]
    token = sched.book_inflight("some-kernel")
    assert token[0] is first and token[1] > 0.0
    assert sched._ranked()[0] is not first
    assert sched._ranked(exclude=token)[0] is first
    sched.release_inflight(token)
    fp = pkg.cache.kernel_fingerprint(_src(pkg, "poly1"))
    default = sched.estimate_build_us(fp)
    prog = sched.build_opts(_src(pkg, "poly1"),
                            pkg.CompileOptions(max_replicas=2))
    assert sched.estimate_build_us(fp) == pytest.approx(prog.build_ms * 1e3)
    with pkg.new_session(_devices(pkg, "c"), cache=sched.cache) as sess:
        sess.compile(_src(pkg, "poly1"),
                     pkg.CompileOptions(max_replicas=2)).result(60)
        assert sess.scheduler.estimate_build_us(fp) != default
    return default, first.device.name, first.pending_compile_us


def _legacy_shims(pkg):
    sched = pkg.Scheduler(_devices(pkg, "a", "b"))
    with pytest.warns(DeprecationWarning):
        p0 = sched.build(_src(pkg, "poly1"), max_replicas=4)
    p1 = sched.build_opts(_src(pkg, "poly1"),
                          pkg.CompileOptions(max_replicas=4))
    assert p1.compiled is p0.compiled
    assert p0.opts == pkg.CompileOptions(max_replicas=4)
    ctx = pkg.Context(pkg.Device("c", pkg.spec()), cache=sched.cache)
    with pytest.warns(DeprecationWarning, match="Session.build"):
        p_old = ctx.build_program(_src(pkg, "poly1"), max_replicas=4)
    return sched.ledger(), sched.cache.stats.as_dict(), \
        p_old.compiled is p0.compiled


SESSION_CASES = [_single_flight, _build_error, _chained_enqueue,
                 _warm_compile, _tenant_queues, _makespan_policy,
                 _free_fabric_policy, _estimates, _legacy_shims]


@pytest.mark.parametrize("case", SESSION_CASES,
                         ids=[c.__name__[1:] for c in SESSION_CASES])
def test_session_follows_the_reference(case):
    r, t = both(case)
    assert t == r


# ------------------------------------------------------------ fault plane

SWEEP = ["frontend", "place", "route", "stamp", "queue_submit",
         "device_exec"]


def _one_fault(pkg, stage):
    plan = pkg.faults.FaultPlan(seed=1).add(stage, rate=1.0, times=1)
    mode = "template" if stage == "stamp" else "auto"
    with pkg.new_session(_devices(pkg, "a"), faults=plan,
                         retry=_fast(pkg)) as sess:
        _, ev = _roundtrip(pkg, sess, pkg.CompileOptions(max_replicas=4,
                                                         pr_mode=mode))
        assert plan.total_injected() == 1
        return session_event(ev), _summary(sess)


@pytest.mark.parametrize("stage", SWEEP)
def test_one_injected_fault_is_absorbed_as_in_the_reference(stage):
    r, t = both(_one_fault, stage)
    assert t == r
    rec = t[1]["recovery"]
    assert (rec["retries"] + rec["enqueue_retries"] + rec["fallback_joint"]
            + rec["fallback_nodewise"]) >= 1


def _retry_budgets(pkg):
    out = []
    fm, opts = pkg.faults, pkg.CompileOptions
    plan = fm.FaultPlan(0).add("frontend", times=1)
    with pkg.new_session(_devices(pkg, "a"), faults=plan,
                         retry=_fast(pkg)) as sess:
        fut = sess.compile(_src(pkg, "poly1"),
                           opts(max_replicas=4, retry_budget=0))
        with pytest.raises(fm.InjectedFault):
            fut.result(60)
        _roundtrip(pkg, sess, opts(max_replicas=4, retry_budget=0))
        out.append(_summary(sess))
    plan = fm.FaultPlan(0).add("frontend")
    with pkg.new_session(_devices(pkg, "a"), faults=plan,
                         retry=_fast(pkg)) as sess:
        fut = sess.compile(_src(pkg, "poly1"),
                           opts(max_replicas=4, retry_budget=2))
        with pytest.raises(fm.InjectedFault):
            fut.result(60)
        out.append((fut._record["attempts"], _summary(sess)))
    with pkg.new_session(_devices(pkg, "a")) as sess:
        fut, _ = _roundtrip(pkg, sess)
        assert sess.recovery.all_zero() and "faults" not in sess.stats()
        out.append((fut._record["attempts"], _summary(sess)))
    return out


def _failed_single_flight(pkg):
    fm = pkg.faults
    opts = pkg.CompileOptions(max_replicas=4, retry_budget=0)
    plan = fm.FaultPlan(0).add("frontend", times=1)
    with pkg.new_session(_devices(pkg, "a"), faults=plan, retry=_fast(pkg),
                         max_workers=1) as sess:
        gate = threading.Event()
        sess._pool.submit(gate.wait, 30)
        f1 = sess.compile(_src(pkg, "poly1"), opts, tenant="t1")
        f2 = sess.compile(_src(pkg, "poly1"), opts, tenant="t2")
        assert f2.key == f1.key
        gate.set()
        e1, e2 = f1.exception(60), f2.exception(60)
        assert isinstance(e1, fm.InjectedFault) and e2 is e1
        f3 = sess.compile(_src(pkg, "poly1"), opts)
        assert f3._fut is not f1._fut and f3.result(60) is not None
        with sess._lock:                       # the callback race
            sess._inflight[f1.key] = (f1._fut, f1._record)
        sess._forget(f1.key, f1._fut)
        return _summary(sess)


def _exec_faults_migrate(pkg):
    plan = pkg.faults.FaultPlan(0).add("device_exec", rate=1.0, times=3)
    retry = pkg.recovery.RetryPolicy(backoff_us=50.0, breaker_threshold=3,
                                     enqueue_retries=10,
                                     breaker_cooldown_s=30.0)
    with pkg.new_session(_devices(pkg, "a", "b"), faults=plan,
                         retry=retry) as sess:
        fut = sess.compile(_src(pkg, "poly1"),
                           pkg.CompileOptions(max_replicas=4))
        home = fut.result(60).ctx.device.name
        ev = sess.enqueue(fut, X)
        assert fut.result().ctx.device.name != home
        p2 = sess.compile(_src(pkg, "chebyshev"),
                          pkg.CompileOptions(max_replicas=4)).result(60)
        assert p2.ctx.device.name != home
        return home, session_event(ev), _summary(sess)


def _device_loss(pkg):
    with pkg.new_session(_devices(pkg, "a", "b"), retry=_fast(pkg)) as sess:
        fut, ev = _roundtrip(pkg, sess, tenant="t1")
        home = fut.result().ctx.device.name
        before = host(ev.outputs[0]).copy()
        sess.fail_device(home, at_us=0.0)
        prog = fut.result()
        assert not prog.released and prog.ctx.device.name != home
        assert np.array_equal(host(ev.outputs[0]), before)
        with pytest.raises(pkg.faults.DeviceLostError):
            sess.scheduler.contexts[home].build_program(
                _src(pkg, "poly1"), opts=pkg.CompileOptions(max_replicas=2))
        ev2 = sess.enqueue(fut, X)
        with pytest.raises(Exception):
            sess.fail_device("nope")
        return home, session_event(ev), session_event(ev2), _summary(sess)


def _recovered_device(pkg):
    fast = _fast(pkg)
    with pkg.new_session(_devices(pkg, "a", "b"), retry=fast) as sess:
        fut, _ = _roundtrip(pkg, sess)
        home = fut.result().ctx.device.name
        sess.fail_device(home)
        states = [sess.stats()["recovery"]["breakers"][home]["state"]]
        sess.recover_device(home)
        time.sleep(fast.breaker_cooldown_s * 2)
        ctx = sess.scheduler.contexts[home]
        assert any(c is ctx for c in sess.scheduler._ranked())
        sess.scheduler.breakers[home].record_success()
        states.append(sess.stats()["recovery"]["breakers"][home]["state"])
    with pkg.new_session(_devices(pkg, "a"), retry=fast) as sess:
        fut, _ = _roundtrip(pkg, sess)
        with pytest.raises(Exception):
            sess.fail_device("a")
            sess.enqueue(fut, X)
    return states


def _hedges(pkg):
    fm, opts = pkg.faults, pkg.CompileOptions
    out = []
    plan = fm.FaultPlan(0).add("place", kind="slow", slow_us=600_000,
                               times=1)
    with pkg.new_session(_devices(pkg, "a"), faults=plan,
                         retry=_fast(pkg)) as sess:
        _roundtrip(pkg, sess, opts(max_replicas=4, deadline_ms=100.0))
        rec = sess.stats()["recovery"]
        assert rec["hedges_started"] == 1
        assert rec["hedges_won"] + rec["hedges_lost"] == 1
        out.append(plan.as_dict()["slowed"])
        deadline = time.time() + 10
        while time.time() < deadline and not sess.ledger_consistent():
            time.sleep(0.02)
        assert sess.ledger_consistent()
    with pkg.new_session(_devices(pkg, "a"), retry=_fast(pkg)) as sess:
        _roundtrip(pkg, sess, opts(max_replicas=4, deadline_ms=30_000.0))
        out.append(sess.stats()["recovery"]["hedges_started"])
    return out


def _nodewise_ladder(pkg):
    stages = [(lambda x: x * 3.0 + 5.0, "fs0"), (lambda x: x * x - 2.0,
                                                 "fs1"),
              (lambda x: x * 0.25 + 1.0, "fs2")]
    plan = pkg.faults.FaultPlan(0).add("place", match="+") \
        .add("route", match="+")
    with pkg.new_session(_devices(pkg, "a"), faults=plan,
                         retry=_fast(pkg)) as sess:
        with sess.capture("t", name="pipe") as g:
            buf = g.input("x")
            for fn, name in stages:
                buf = g.call(fn, pkg.CompileOptions(max_replicas=4,
                                                    n_inputs=1, name=name),
                             buf)
        ev = sess.launch(sess.instantiate(g), X)
        assert sess.stats()["recovery"]["fallback_nodewise"] >= 1
        return host(ev.outputs[0]).tobytes(), _summary(sess)


def _template_ladder(pkg):
    plan = pkg.faults.FaultPlan(0).add("stamp", times=1)
    with pkg.new_session(_devices(pkg, "a"), faults=plan,
                         retry=_fast(pkg)) as sess:
        fut, ev = _roundtrip(pkg, sess)
        return (fut.result().compiled.pr_path, session_event(ev),
                _summary(sess))


def _disk_faults(pkg, tmp_path):
    fm, opts = pkg.faults, pkg.CompileOptions(max_replicas=4)
    out = []
    plan = fm.FaultPlan(0).add("disk_write", times=1)
    with pkg.new_session(_devices(pkg, "a"),
                         persist_dir=str(tmp_path / pkg.root / "w"),
                         faults=plan, retry=_fast(pkg)) as sess:
        _roundtrip(pkg, sess)
        out.append(_summary(sess))
    persist = str(tmp_path / pkg.root / "r")
    with pkg.new_session(_devices(pkg, "a"), persist_dir=persist) as warm:
        warm.compile(_src(pkg, "poly1"), opts).result(60)
    plan = fm.FaultPlan(0).add("disk_read", times=1)
    with pkg.new_session(_devices(pkg, "a"), persist_dir=persist,
                         faults=plan, retry=_fast(pkg)) as sess:
        _roundtrip(pkg, sess, opts)
        out.append(_summary(sess))
    return out


FAULT_CASES = [_retry_budgets, _failed_single_flight, _exec_faults_migrate,
               _device_loss, _recovered_device, _hedges, _nodewise_ladder,
               _template_ladder]


@pytest.mark.parametrize("case", FAULT_CASES,
                         ids=[c.__name__[1:] for c in FAULT_CASES])
def test_self_healing_follows_the_reference(case):
    """Retries, single-flight failures, breaker trips with migration,
    device loss with requeue, hedged builds and the degradation ladders."""
    r, t = both(case)
    assert t == r


def test_disk_faults_follow_the_reference(tmp_path):
    r, t = both(_disk_faults, tmp_path)
    assert t == r
    assert t[0]["disk"]["write_errors"] >= 1
    assert t[1]["disk"]["quarantined"] >= 1


def test_hedged_build_wins_over_a_stalled_primary(monkeypatch):
    """A primary build that stalls past its deadline loses to the cheaper
    hedge; the straggler is released when it lands."""
    with T.new_session(_devices(T, "a"), retry=_fast(T)) as sess:
        real = sess.scheduler.build_opts
        stalled = threading.Event()

        def build_opts(source, opts, **kw):
            if opts.place_effort >= 0.5:
                stalled.wait(10)
            return real(source, opts, **kw)

        monkeypatch.setattr(sess.scheduler, "build_opts", build_opts)
        fut = sess.compile(_src(T, "poly1"),
                           T.CompileOptions(max_replicas=4, deadline_ms=80.0))
        prog = fut.result(60)
        stalled.set()
        ev = sess.enqueue(prog, X)
        assert_same_bits(host(ev.wait()[0]), prog.compiled.run_reference(X))
        rec = sess.stats()["recovery"]
        assert (rec["hedges_started"], rec["hedges_won"]) == (1, 1)
        assert prog.opts.place_effort < 0.5
        deadline = time.time() + 10
        while time.time() < deadline and not sess.ledger_consistent():
            time.sleep(0.02)
        assert sess.ledger_consistent()


# --------------------------------------------------------- threaded ledger

def _concurrent_release(pkg):
    ctx = pkg.Context(pkg.Device("d", pkg.spec()), cache=pkg.JITCache())
    for _ in range(5):
        prog = ctx.build_program(_src(pkg, "poly1"),
                                 opts=pkg.CompileOptions(max_replicas=4))
        start = threading.Barrier(9)

        def racer():
            start.wait()
            prog.release()

        threads = [threading.Thread(target=racer) for _ in range(8)]
        for t in threads:
            t.start()
        start.wait()
        for t in threads:
            t.join()
        assert ctx.device.fu_used == 0 and ctx.ledger_consistent()
    return ctx.device.fu_used


def _release_during_resize(pkg):
    cache = pkg.JITCache()
    rng = random.Random(0)
    replicas = []
    for _ in range(2):
        sched = pkg.Scheduler(_devices(pkg, "a"), cache=cache)
        big = sched.build_opts(_src(pkg, "poly1"), pkg.CompileOptions(),
                               tenant="big")
        others = [sched.build_opts(_src(pkg, "chebyshev"),
                                   pkg.CompileOptions(max_replicas=4),
                                   tenant=f"t{i}") for i in range(2)]
        assert big.compiled.plan.replicas < big.planned_replicas
        replicas.append((big.planned_replicas, big.compiled.plan.replicas))
        progs = [big] + others
        rng.shuffle(progs)
        start = threading.Barrier(len(progs) + 1)

        def releaser(p):
            start.wait()
            p.release()

        threads = [threading.Thread(target=releaser, args=(p,))
                   for p in progs]
        for t in threads:
            t.start()
        start.wait()
        for t in threads:
            t.join()
        assert sched.ledger_consistent() and sched.devices[0].fu_used == 0
    return replicas


def _threaded_enqueues(pkg):
    x = np.linspace(-1, 1, 1024).astype(np.float32)
    with pkg.new_session(_devices(pkg, "a"), max_workers=2) as sess:
        prog = sess.build(_src(pkg, "poly1"),
                          pkg.CompileOptions(max_replicas=4))
        start = threading.Barrier(4)
        errors = []

        def tenant(i):
            try:
                start.wait()
                for _ in range(10):
                    ev = sess.enqueue(prog, x, tenant=f"t{i}")
                    assert_same_bits(host(ev.outputs[0]),
                                     prog.compiled.run_reference(x))
            except BaseException as e:        # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        busy = sorted(sess.contexts["a"]._engine_busy)
        assert len(busy) == 40
        for (s0, e0), (s1, e1) in zip(busy, busy[1:]):
            assert s1 >= e0 - 1e-9
        return len(busy), _summary(sess)


def _threaded_stress(pkg):
    names = ["poly1", "chebyshev", "poly2", "sgfilter"]
    with pkg.new_session(_devices(pkg, "a", "b"), max_workers=4) as sess:
        errors = []

        def tenant_loop(i):
            rng = random.Random(i)
            held = []
            try:
                for it in range(5):
                    fut = sess.compile(_src(pkg, names[(i + it) % 4]),
                                       pkg.CompileOptions(max_replicas=4),
                                       tenant=f"t{i}")
                    try:
                        prog = fut.result(120)
                    except pkg.runtime.SchedulerError:
                        continue
                    held.append(prog)
                    if rng.random() < 0.6 and held:
                        held.pop(rng.randrange(len(held))).release()
                for p in held:
                    p.release()
            except BaseException as e:        # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=tenant_loop, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert sess.ledger_consistent()
        return [(d.fu_used, d.io_used) for d in sess.devices]


THREAD_CASES = [_concurrent_release, _release_during_resize,
                _threaded_enqueues, _threaded_stress]


@pytest.mark.parametrize("case", THREAD_CASES,
                         ids=[c.__name__[1:] for c in THREAD_CASES])
def test_threaded_ledger_follows_the_reference(case):
    """Concurrent releases, releases racing a resize, tenant threads
    enqueueing onto one engine, and a build/release stress loop: the
    ledgers stay consistent and end where ``repro``'s end."""
    r, t = both(case)
    assert t == r


# ------------------------------------------------------------ port-only

def test_session_buffers_follow_its_device_and_run_the_executor():
    with T.new_session(_devices(T, "a")) as sess:
        assert sess.use_overlay_executor is True
        prog = sess.build(_src(T, "sgfilter"),
                          T.CompileOptions(max_replicas=2))
        loads = ops.image_loads
        y = X[::-1].copy()
        evs = [sess.enqueue(prog, X, torch.from_numpy(y)) for _ in range(3)]
        assert ops.image_loads == loads + 1
        assert sess.queue_for(None, "a").use_overlay_executor is True
        for ev in evs:
            out = ev.outputs[0]
            assert isinstance(out, Buffer) and out.device.type == "cpu"
            assert_same_bits(host(out), prog.compiled.run_reference(X, y))
        with pytest.raises(ValueError, match="call runs on"):
            sess.enqueue(prog, X, torch.ones(512, device="meta"))


def test_session_without_a_card_or_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: arrays go to it")
    with T.session.Session([T.Device("a", T.spec())]) as sess:
        prog = sess.build(_src(T, "poly1"), T.CompileOptions(max_replicas=2))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sess.enqueue(prog, X)


def test_partition_verification_is_left_to_the_analysis_slice():
    """A graph whose nodes ask for verification is gated by the analysis
    package's A1xx race/alias checks: the clean cut instantiates and
    launches bit for bit as the nodewise replay, and a cut with a planted
    alias raises VerificationError before any partition build is submitted,
    with the same findings in both packages."""
    def scenario(pkg):
        opts = pkg.CompileOptions(n_inputs=1, verify_level="fused")
        with pkg.new_session(_devices(pkg, "a")) as sess:
            with sess.capture(name="v") as g:
                t = g.call(lambda x: x + 1.0, opts, g.input())
                g.call(lambda x: x * x - 0.5, opts, t)
            gx = sess.instantiate(g)
            fused = host(sess.launch(gx, X).wait()[0])
            nodewise = host(sess.launch_nodewise(g, X).wait()[0])
            bad = copy.deepcopy(sess.graph_plan(g))
            bad[0].ext = bad[0].ext * 2           # one buffer, two slots
            submitted = []
            sess.compile = lambda *a, **kw: submitted.append(a)
            with pytest.raises(pkg.analysis.VerificationError) as ei:
                sess.instantiate(g, plan=bad)
            assert submitted == []
            return (gx.n_partitions, fused.tobytes(), nodewise.tobytes(),
                    [(d.code, d.message) for d in ei.value.diagnostics])
    r, t = both(scenario)
    assert t == r
    assert t[1] == t[2] and t[0] == 1
    assert {"A108", "A109"} <= {code for code, _ in t[3]}
