"""The port's OpenCL runtime (Context, Program, Kernel, CommandQueue,
Scheduler) against the JAX package's.

Every scenario runs through both packages on the same numpy inputs:
ledger debits and credits, replica counts and shedding victims must be
equal, every ``Event`` timestamp (the modelled clock, never a device clock)
must be equal, and every output must carry the same float32 bits
(tolerance 0).  ``repro`` computes outputs with the numpy
``run_reference`` (its default); the port runs the overlay executor (its
default), here its plain PyTorch version on CPU buffers.

The port keeps one executor image per program and device: loaded at the
first enqueue, rewritten in place when shedding or migration swaps a new
artifact into the program, never stored on the pickled artifact.
"""

import io
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.runtime import Buffer
from repro_torch.kernels.overlay_exec import kernel, ops
from torch_runtime_pair import (T, assert_same_bits, both, event_record,
                                host)

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

X = np.linspace(-2, 2, 512).astype(np.float32)
# chebyshev with other constants: the same program shape, other immediates
CHEB_VARIANT = T.BENCHMARKS["chebyshev"][0].replace("16*x*x-20", "15*x*x-19")


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _ctx(pkg, name="d"):
    return pkg.Context(pkg.Device(name, pkg.spec()), cache=pkg.JITCache())


def _build(ctx, pkg, name, **opts):
    return ctx.build_program(pkg.BENCHMARKS[name][0],
                             opts=pkg.CompileOptions(**opts))


def _run(q, prog, pkg, *xs, **kw):
    return q.enqueue_kernel(
        prog.create_kernel().set_args(*[pkg.buf(x) for x in (xs or (X,))]),
        **kw)


def _ledger(ctx):
    d = ctx.device
    return (d.fu_used, d.io_used, d.fu_free, d.io_free, len(ctx.programs),
            ctx.ledger_consistent())


# ---------------------------------------------------------------- buffers

def test_buffer_holds_a_contiguous_float32_tensor_on_a_device():
    b = Buffer(np.arange(6, dtype=np.float64).reshape(2, 3)[:, ::-1],
               device="cpu")
    assert b.data.dtype == torch.float32 and b.data.is_contiguous()
    assert b.device == torch.device("cpu") and b.data.shape == (2, 3)
    got = b.read()
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    got[0, 0] = 99.0                            # read() is a copy
    assert b.read()[0, 0] == 2.0
    t = torch.ones(4)
    assert Buffer(t).device == t.device          # a tensor stays where it is
    assert Buffer([1.0, 2.0], device="cpu").read().tolist() == [1.0, 2.0]
    with pytest.raises(ValueError, match="call runs on"):
        Buffer(t, device="meta")


def test_buffer_without_a_card_or_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy buffers go to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Buffer(X)


# ----------------------------------------------------------------- ledger

def _ledger_cycle(pkg):
    ctx = pkg.Context(pkg.Device("d", pkg.spec()))
    free0 = ctx.device.fu_free
    p1 = _build(ctx, pkg, "chebyshev", max_replicas=8)
    after1 = _ledger(ctx)
    assert ctx.device.fu_free == free0 - p1.compiled.plan.fus_used
    p2 = _build(ctx, pkg, "chebyshev")
    other = _build(pkg.Context(pkg.Device("e", pkg.spec())), pkg,
                   "chebyshev")
    after2 = _ledger(ctx)
    p1.release()
    p2.release()
    p1.release()                                  # idempotent
    ctx.reserve(fus=4)
    with pytest.raises(RuntimeError):
        ctx.release(fus=10)
    ctx.release(fus=4)
    return (after1, after2, _ledger(ctx), p1.compiled.plan.replicas,
            p2.compiled.plan.replicas, other.compiled.plan.replicas)


def test_builds_debit_and_releases_credit_as_the_reference():
    r, t = both(_ledger_cycle)
    assert t == r
    assert t[4] < t[5] and t[2][:2] == (0, 0)


def _released_program(pkg):
    ctx = _ctx(pkg)
    p = _build(ctx, pkg, "poly1")
    k = p.create_kernel().set_args(pkg.buf(X[:32]))
    with p:
        (out,) = p.create_kernel().set_args(pkg.buf(X[:64])).enqueue()
        inside = host(out)
    with pytest.raises(RuntimeError):
        p.create_kernel()
    with pytest.raises(RuntimeError):
        k.enqueue()
    q = ctx.create_queue()
    with pytest.raises(RuntimeError):
        q.enqueue_kernel(k)
    assert q.events == [] and ctx._engine_busy == []
    return inside.tobytes(), _ledger(ctx)


def test_released_programs_reject_kernels_as_the_reference():
    r, t = both(_released_program)
    assert t == r


def _shared_cache(pkg):
    cache = pkg.JITCache()
    src = pkg.BENCHMARKS["poly1"][0]
    a = pkg.jit.jit_compile(src, pkg.spec(), cache=cache)
    b = pkg.jit.jit_compile(pkg.jit.lower_to_dfg(src, parse_source=True),
                            pkg.spec(), cache=cache)
    c0 = pkg.Context(pkg.Device("d0", pkg.spec()), cache=cache)
    c1 = pkg.Context(pkg.Device("d1", pkg.spec()), cache=cache)
    pa, pb = c0.build_program(src, opts=pkg.CompileOptions()), \
        c1.build_program(src, opts=pkg.CompileOptions())
    return (b is a, pb.compiled is pa.compiled, _ledger(c0), _ledger(c1),
            cache.stats.as_dict())


def test_entry_points_and_contexts_share_the_cache_as_the_reference():
    r, t = both(_shared_cache)
    assert t == r
    assert t[0] and t[1]


# ------------------------------------------------------------------ queues

def _in_order(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "poly1")
    q = ctx.create_queue(in_order=True)
    evs = [_run(q, prog, pkg) for _ in range(4)]
    for prev, ev in zip(evs, evs[1:]):
        assert ev.deps[-1] is prev and ev.t_submit_us >= prev.t_end_us
    return [event_record(e) for e in evs], q.profile()


def _out_of_order(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "poly1")
    q = ctx.create_queue(in_order=False)
    _run(q, prog, pkg)
    gate = pkg.queue.user_event(t_end_us=10_000.0)
    blocked = _run(q, prog, pkg, wait_for=[gate])
    free = _run(q, prog, pkg)
    assert blocked.t_submit_us >= 10_000.0
    assert free.t_end_us < blocked.t_submit_us
    return [event_record(e) for e in q.events]


def _no_backfill_unconfigured(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "poly1")
    q = ctx.create_queue(in_order=False)
    first = _run(q, prog, pkg,
                 wait_for=[pkg.queue.user_event(t_end_us=10_000.0)])
    second = _run(q, prog, pkg)
    assert second.t_submit_us >= first.t_submit_us
    return [event_record(e) for e in q.events]


def _late_compile_event(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "poly1")
    q = ctx.create_queue(in_order=False)
    first = _run(q, prog, pkg)
    _run(q, prog, pkg, wait_for=[pkg.queue.user_event(t_end_us=10_000.0)])
    late = _run(q, prog, pkg, wait_for=[
        pkg.queue.user_event(t_end_us=7_000.0, name="jit:poly1")])
    assert first.t_end_us < 7_000.0 <= late.t_submit_us
    assert late.config_us == 0.0 and late.t_end_us < 10_000.0
    return [event_record(e) for e in q.events]


def _barriers(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "poly1")
    q = ctx.create_queue(in_order=False)
    _run(q, prog, pkg)
    _run(q, prog, pkg, wait_for=[pkg.queue.user_event(t_end_us=10_000.0)])
    bar = q.enqueue_barrier()
    late = _run(q, prog, pkg)
    assert late.t_submit_us >= bar.t_end_us >= 10_000.0
    before = [_run(q, prog, pkg) for _ in range(3)]
    bar2 = q.enqueue_barrier()
    after = _run(q, prog, pkg)
    assert after.t_submit_us >= bar2.t_end_us >= max(e.t_end_us
                                                     for e in before)
    return [event_record(e) for e in q.events], q.finish()


def _reconfiguration(pkg):
    ctx = _ctx(pkg)
    p1 = _build(ctx, pkg, "poly1", max_replicas=4)
    q = ctx.create_queue()
    evs = [_run(q, p1, pkg), _run(q, p1, pkg)]
    p2 = _build(ctx, pkg, "chebyshev", max_replicas=4)
    evs += [_run(q, p2, pkg), _run(q, p1, pkg)]
    assert [e.config_us > 0.0 for e in evs] == [True, False, True, True]
    return ([event_record(e) for e in evs], q.config_charges,
            q.config_us_total, q.throughput_kernels_per_sec())


def _shared_engine(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "poly1")
    qa, qb = ctx.create_queue(), ctx.create_queue()
    for _ in range(3):
        _run(qa, prog, pkg)
        _run(qb, prog, pkg)
    spans = sorted((e.t_submit_us, e.t_end_us) for e in qa.events + qb.events)
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        assert s1 >= e0 - 1e-9
    drained = qa.drain()
    assert all(e.deps == () for e in drained) and qa.events == []
    return ([event_record(e) for e in drained + qb.events],
            list(ctx._engine_busy), list(ctx._config_switches))


def _failed_enqueues(pkg):
    ctx = _ctx(pkg)
    prog = _build(ctx, pkg, "sgfilter")
    q = ctx.create_queue()
    with pytest.raises(RuntimeError):
        _run(q, prog, pkg, X)                      # one buffer of two
    assert ctx._engine_busy == [] and ctx._config_switches == []
    ok = _run(q, prog, pkg, X, X[::-1].copy())
    sched = pkg.Scheduler([pkg.Device("a", pkg.spec()),
                           pkg.Device("b", pkg.spec())])
    pa = _build(sched.contexts["a"], pkg, "poly1", max_replicas=2)
    qb = sched.contexts["b"].create_queue()
    with pytest.raises(RuntimeError):
        _run(qb, pa, pkg)
    assert qb.events == []
    return event_record(ok)


QUEUE_CASES = [_in_order, _out_of_order, _no_backfill_unconfigured,
               _late_compile_event, _barriers, _reconfiguration,
               _shared_engine, _failed_enqueues]


@pytest.mark.parametrize("case", QUEUE_CASES,
                         ids=[c.__name__[1:] for c in QUEUE_CASES])
def test_queue_events_equal_the_reference(case):
    """In- and out-of-order queues, dependencies, backfill, barriers and
    configuration charges: every Event timestamp and output bit equal."""
    r, t = both(case)
    assert t == r


def _paper_kernels(pkg, spec):
    rng = np.random.default_rng(7)
    ctx = pkg.Context(pkg.Device("d", pkg.spec(*spec)), cache=pkg.JITCache())
    q = ctx.create_queue()
    out = []
    for name in sorted(pkg.BENCHMARKS):
        prog = _build(ctx, pkg, name)
        n_in = len(prog.compiled.dfg.inputs)
        xs = [rng.uniform(-2, 2, (3, 77)).astype(np.float32)
              for _ in range(n_in)]
        xs[0][0, :4] = [np.nan, np.inf, -0.0, 1e-42]
        ev = _run(q, prog, pkg, *xs)
        assert ev.outputs[0].read().shape == (3, 77)
        out.append(event_record(ev))
        prog.release()
    return out


@pytest.mark.parametrize("spec", [(8, 8, 2), (32, 8, 2)])
def test_paper_kernels_run_bit_exact_against_the_reference(spec):
    r, t = both(_paper_kernels, spec)
    assert t == r


def test_parity_path_puts_run_reference_on_the_buffers_device():
    ctx = _ctx(T)
    prog = _build(ctx, T, "mibench")
    xs = [T.buf(X), T.buf(X[::-1].copy())]
    q_exec = ctx.create_queue()
    q_ref = ctx.create_queue(use_overlay_executor=False)
    assert q_exec.use_overlay_executor is True
    a = q_exec.enqueue_kernel(prog.create_kernel().set_args(*xs))
    b = q_ref.enqueue_kernel(prog.create_kernel().set_args(*xs))
    assert b.outputs[0].device == torch.device("cpu")
    assert_same_bits(host(a.outputs[0]), host(b.outputs[0]))
    assert_same_bits(host(a.outputs[0]),
                     prog.compiled.run_reference(X, X[::-1].copy()))
    # the parity path never moves work off a device to the host: buffers
    # that are not on the CPU raise (a meta tensor stands in for the card)
    off_host = [T.runtime.Buffer(torch.empty(8, device="meta"))
                for _ in xs]
    with pytest.raises(T.runtime.RuntimeError_, match="CPU buffers only"):
        q_ref.enqueue_kernel(prog.create_kernel().set_args(*off_host))


# --------------------------------------------------------------- scheduler

def _fleet(pkg):
    sched = pkg.Scheduler([pkg.Device("a", pkg.spec()),
                           pkg.Device("b", pkg.spec())])
    trail = []
    for name in ("poly1", "chebyshev", "poly2", "sgfilter", "mibench"):
        p = sched.build_opts(pkg.BENCHMARKS[name][0])
        trail.append((p.ctx.device.name, p.compiled.plan.replicas,
                      sched.ledger(), sched.ledger_consistent()))
    again = sched.build_opts(pkg.BENCHMARKS["poly1"][0])
    trail.append((again.compiled.plan.replicas, sched.cache.stats.as_dict()))
    return trail


def _shedding(pkg):
    sched = pkg.Scheduler([pkg.Device("a", pkg.spec())])
    big = sched.build_opts(pkg.BENCHMARKS["poly1"][0])
    r0 = big.compiled.plan.replicas
    nxt = sched.build_opts(pkg.BENCHMARKS["chebyshev"][0])
    assert not big.released and big.compiled.plan.replicas < r0
    big.create_kernel()
    tiny = pkg.Scheduler([pkg.Device("t", pkg.spec(2, 2))])
    with pytest.raises(pkg.runtime.SchedulerError):
        tiny.build_opts(pkg.BENCHMARKS["mibench"][0])
    return (r0, big.compiled.plan.replicas, nxt.compiled.plan.replicas,
            sched.ledger(), sched.ledger_consistent())


def _priority_shedding(pkg):
    sched = pkg.Scheduler([pkg.Device("a", pkg.spec(4, 4))])
    sched.set_priority("gold", 10)
    opts, b = pkg.CompileOptions, pkg.BENCHMARKS
    gold = sched.build_opts(b["poly1"][0], opts(max_replicas=3),
                            tenant="gold")
    bronze = sched.build_opts(b["chebyshev"][0], opts(max_replicas=2),
                              tenant="bronze")
    third = sched.build_opts(b["sgfilter"][0], opts(max_replicas=1),
                             tenant="new")
    grown = []
    third.release()                     # frees fabric: bronze re-inflates
    grown.append(bronze.compiled.plan.replicas)
    return (gold.compiled.plan.replicas, bronze.compiled.plan.replicas,
            third.compiled.plan.replicas, grown, sched.ledger(),
            sched.ledger_consistent())


SCHEDULER_CASES = [_fleet, _shedding, _priority_shedding]


@pytest.mark.parametrize("case", SCHEDULER_CASES,
                         ids=[c.__name__[1:] for c in SCHEDULER_CASES])
def test_scheduler_placement_and_shedding_equal_the_reference(case):
    """Placement, replica counts, shedding victims and re-inflation."""
    r, t = both(case)
    assert t == r


# ------------------------------------------ resident images (hazards 1, 2)

def _counts():
    return ops.image_loads, ops.image_writes


def test_each_program_loads_its_image_once_per_device():
    ctx = _ctx(T)
    p1 = _build(ctx, T, "poly1", max_replicas=4)
    p2 = _build(ctx, T, "sgfilter", max_replicas=2)
    q = ctx.create_queue()
    loads, writes = _counts()
    for _ in range(5):
        _run(q, p1, T)
        _run(q, p2, T, X, X)
    assert _counts() == (loads + 2, writes)
    (dev, (ck, img)), = p1._images.items()
    assert dev == torch.device("cpu") and ck is p1.compiled
    assert img.n_instr == p1.compiled.program.n_instr + 1   # + output move
    p1.release()
    assert p1._images == {}
    assert kernel.LIBRARY.builds == 0            # CPU tensors build nothing


def test_threads_enqueueing_one_program_load_its_image_once(monkeypatch):
    """Tenant threads enqueue the same programs at once: the image lookup
    is one atomic step, so each program loads one image, not one per
    thread, and every output is right.  Each load sleeps a millisecond, so
    an unguarded lookup would let every thread load its own."""
    real = ops.resident_image

    def slow_load(*args):
        time.sleep(1e-3)
        return real(*args)

    monkeypatch.setattr(ops, "resident_image", slow_load)
    ctx = _ctx(T)
    progs = [_build(ctx, T, n, max_replicas=2) for n in ("poly1", "poly2")]
    want = [p.compiled.run_reference(X) for p in progs]
    loads = ops.image_loads
    errors = []
    start = threading.Barrier(8)

    def tenant(i):
        try:
            q = ctx.create_queue(in_order=False)
            start.wait(timeout=30)
            for j in range(10):
                k = (i + j) % 2
                ev = q.enqueue_kernel(progs[k].create_kernel().set_args(
                    T.buf(X)))
                assert_same_bits(host(ev.outputs[0]), want[k])
        except BaseException as e:          # noqa: BLE001
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert ops.image_loads == loads + 2


def test_launch_runs_the_current_artifact_under_the_image_lock(monkeypatch):
    """The artifact is read and the executor launched under the image
    lock: an enqueue that began before a swap can never rewrite the shared
    image back to the artifact that was swapped out."""
    ctx = _ctx(T)
    prog = _build(ctx, T, "chebyshev", max_replicas=2)
    old_ck = prog.compiled
    _enqueue_on(prog)
    new_ck = T.jit.jit_compile(CHEB_VARIANT, prog.ctx.device.spec,
                               opts=T.CompileOptions(max_replicas=2))
    real = kernel.overlay_execute
    seen = []

    def checked(image, x):
        (ck, img), = prog._images.values()
        seen.append((prog._image_lock.locked(), ck is prog.compiled,
                     img is image))
        return real(image, x)

    monkeypatch.setattr(kernel, "overlay_execute", checked)
    loads, writes = _counts()
    for ck in (new_ck, old_ck, new_ck):
        prog.compiled = ck
        assert_same_bits(_enqueue_on(prog), ck.run_reference(X))
    assert seen == [(True, True, True)] * 3
    assert _counts() == (loads, writes + 3)
    assert not np.array_equal(new_ck.run_reference(X),
                              old_ck.run_reference(X))


def _scheduler_with_shed_victim():
    sched = T.Scheduler([T.Device("a", T.spec(4, 4))])
    sched.set_priority("gold", 10)
    opts = T.CompileOptions
    sched.build_opts(T.BENCHMARKS["poly1"][0], opts(max_replicas=3),
                     tenant="gold")
    bronze = sched.build_opts(T.BENCHMARKS["chebyshev"][0],
                              opts(max_replicas=2), tenant="bronze")
    return sched, bronze


def _enqueue_on(prog, xs=(X,)):
    q = prog.ctx.create_queue()
    return host(q.enqueue_kernel(prog.create_kernel().set_args(
        *[T.buf(x) for x in xs])).outputs[0])


def test_shed_that_changes_the_program_rewrites_the_resident_image():
    """Hazard 1: shedding swaps a new artifact into the owner's Program.
    The victim's rebuild here compiles another program of the same shape
    (chebyshev with other constants); its next enqueue must run the new
    program, through the same image rewritten in place."""
    sched, bronze = _scheduler_with_shed_victim()
    old_ck = bronze.compiled
    assert_same_bits(_enqueue_on(bronze), old_ck.run_reference(X))
    (_, image), = bronze._images.values()
    loads, writes = _counts()
    bronze.source = CHEB_VARIANT             # what the shed rebuild compiles
    sched.build_opts(T.BENCHMARKS["sgfilter"][0],
                     T.CompileOptions(max_replicas=1), tenant="new")
    assert bronze.compiled is not old_ck
    assert bronze.compiled.plan.replicas == 1          # bronze was shed
    got = _enqueue_on(bronze)
    want = bronze.compiled.run_reference(X)
    assert not np.array_equal(want, old_ck.run_reference(X))
    assert_same_bits(got, want)
    assert _counts() == (loads, writes + 1)
    (ck, img), = bronze._images.values()
    assert img is image and ck is bronze.compiled
    assert sched.ledger_consistent()


def test_migration_to_another_program_signature_loads_a_new_image():
    """Hazard 1 through ``migrate_programs``: the program moves to the
    other overlay device and its rebuild has another (M, n_regs, n_out)
    signature, so a new image is loaded; the old one is not reused."""
    sched = T.Scheduler([T.Device("a", T.spec()), T.Device("b", T.spec())])
    prog = sched.contexts["a"].build_program(
        T.BENCHMARKS["poly1"][0], opts=T.CompileOptions(max_replicas=2))
    _enqueue_on(prog)
    (_, image), = prog._images.values()
    loads, writes = _counts()
    prog.source = T.BENCHMARKS["poly2"][0]
    sched.contexts["a"].device.fail()
    assert sched.migrate_programs("a") == (1, 0)
    assert prog.ctx.device.name == "b"
    assert_same_bits(_enqueue_on(prog), prog.compiled.run_reference(X))
    assert _counts() == (loads + 1, writes)
    (ck, img), = prog._images.values()
    assert img is not image and ck is prog.compiled
    assert sched.ledger_consistent()


def test_migration_rewrites_the_image_like_the_reference_requeue():
    """A migrated program of the same signature keeps its image (one
    write), and its outputs equal ``repro``'s after the same migration."""
    def scenario(pkg):
        sched = pkg.Scheduler([pkg.Device("a", pkg.spec()),
                               pkg.Device("b", pkg.spec())])
        prog = sched.contexts["a"].build_program(
            pkg.BENCHMARKS["chebyshev"][0],
            opts=pkg.CompileOptions(max_replicas=2))
        q = prog.ctx.create_queue()
        first = q.enqueue_kernel(prog.create_kernel().set_args(pkg.buf(X)))
        prog.source = CHEB_VARIANT
        sched.contexts["a"].device.fail()
        moved = sched.migrate_programs("a")
        q = prog.ctx.create_queue()
        second = q.enqueue_kernel(prog.create_kernel().set_args(pkg.buf(X)))
        return (event_record(first), event_record(second), moved,
                prog.ctx.device.name, sched.ledger())
    loads, writes = _counts()
    r, t = both(scenario)
    assert t == r
    assert _counts() == (loads + 1, writes + 1)
    assert t[0][-1] != t[1][-1]                  # the program did change


def _pickled_tensors(obj) -> int:
    """Tensors a pickle of ``obj`` would hold."""
    seen = []

    class Probe(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor):
                seen.append(o)
            return NotImplemented

    Probe(io.BytesIO()).dump(obj)
    return len(seen)


def test_artifacts_that_ran_carry_no_tensor_to_the_cache(tmp_path):
    """Hazard 2: the image lives on the Program; the CompiledKernel that
    the cache pickles (to disk here) holds no tensor after it has run."""
    cache = T.JITCache(persist_dir=tmp_path)
    ctx = T.Context(T.Device("d", T.spec()), cache=cache)
    prog = ctx.build_program(T.BENCHMARKS["poly1"][0],
                             opts=T.CompileOptions(max_replicas=4))
    q = ctx.create_queue()
    for _ in range(2):
        q.enqueue_kernel(prog.create_kernel().set_args(T.buf(X)))
    assert prog._images
    ck = prog.compiled
    assert isinstance(ck._config_id, str)
    assert _pickled_tensors(ck) == 0
    # a pickled tensor names its rebuild function in torch._utils
    blobs = [p.read_bytes() for p in tmp_path.glob("*/*.bin")]
    assert len(blobs) == 3 and not any(b"torch._utils" in b for b in blobs)
    cache.put("after-run", ck)                   # write-through again
    assert b"torch._utils" not in \
        cache.disk._path("after-run").read_bytes()
    warm = T.JITCache(persist_dir=tmp_path).get("after-run")
    assert warm.bitstream.sha256() == ck.bitstream.sha256()


# --------------------------------------------------------------- on a card

@gpu
def test_queue_on_the_card_keeps_outputs_there_and_loads_images_once():
    ctx = T.Context(T.Device("d", T.spec()), cache=T.JITCache())
    progs = [ctx.build_program(T.BENCHMARKS[n][0],
                               opts=T.CompileOptions(max_replicas=2))
             for n in ("poly1", "sgfilter", "chebyshev")]
    q = ctx.create_queue()
    rng = np.random.default_rng(0)
    loads = ops.image_loads
    launches = kernel.overlay_execute.launches
    for _ in range(3):
        for p in progs:
            xs = [rng.uniform(-2, 2, 100_003).astype(np.float32)
                  for _ in p.compiled.dfg.inputs]
            ev = q.enqueue_kernel(p.create_kernel().set_args(
                *[Buffer(x) for x in xs]))
            out = ev.outputs[0]
            assert out.device.type == "cuda"
            assert_same_bits(out.read(), p.compiled.run_reference(*xs))
    assert ops.image_loads == loads + 3
    assert kernel.overlay_execute.launches == launches + 9
