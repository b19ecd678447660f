"""The port's kernel fusion and graph replay against the JAX package's.

``fuse_dfgs`` must give the fused DFG ``repro`` gives (equal content
fingerprints) and refuse the same malformed fusions with ``FusionError``;
capture, partitioning and instantiation must give the same partitions; and
a replay — one executor launch per fused partition — must equal the
nodewise replay and ``repro``'s outputs bit for bit, with the same modelled
configuration charges (the flow of ``examples/graph_replay.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.overlay_exec import kernel, ops
from torch_runtime_pair import (R, T, assert_same_bits, both, host,
                                session_event)

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

X = np.linspace(-2.0, 2.0, 257).astype(np.float32)
Y = np.linspace(1.5, -1.5, 257).astype(np.float32)
XG = np.linspace(-1.5, 1.5, 1024).astype(np.float32)

STAGES = [
    (lambda x: x * 3.0 + 5.0, "s0"),
    (lambda x: x * x - 2.0, "s1"),
    (lambda x: x * 0.25 + 1.0, "s2"),
    (lambda x: x * x + x, "s3"),
]


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _dfg(pkg, fn, n, name):
    return pkg.jit.lower_to_dfg(fn, n, name)


def _fingerprint(pkg, g):
    return pkg.cache.dfg_fingerprint(g)


# ----------------------------------------------------------------- fusion

def _fusions(pkg):
    """The fusions of ``tests/test_fuse.py``: chains, tees, shared inputs,
    cross-kernel CSE, multi-output wiring."""
    fuse = pkg.fuse.fuse_dfgs
    a = _dfg(pkg, lambda x: x * 2.0 + 1.0, 1, "a")
    b = _dfg(pkg, lambda x: x * x - 3.0, 1, "b")
    ab = _dfg(pkg, lambda x, y: x * y + 2.0, 2, "ab")
    sq = _dfg(pkg, lambda t: t * t, 1, "sq")
    inc = _dfg(pkg, lambda x: x + 1.0, 1, "inc")
    mul = _dfg(pkg, lambda x, t: x * t, 2, "mul")
    xx1 = _dfg(pkg, lambda x: x * x + 1.0, 1, "xx1")
    xxt = _dfg(pkg, lambda x, t: x * x + t, 2, "xxt")
    two = _dfg(pkg, lambda x: (x + 1.0, x - 1.0), 1, "two")
    cases = [
        ([(a, [("ext", "x")]), (b, [("int", 0, 0)])], [(1, 0)], "a>b", True),
        ([(ab, [("ext", 0), ("ext", 1)]), (sq, [("int", 0, 0)])],
         [(0, 0), (1, 0)], "tee", True),
        ([(ab, [("ext", 0), ("ext", 1)]), (sq, [("int", 0, 0)])],
         [(1, 0)], "lean", True),
        ([(inc, [("ext", "x")]), (mul, [("ext", "x"), ("int", 0, 0)])],
         [(1, 0)], "diamond", True),
        ([(xx1, [("ext", "x")]), (xxt, [("ext", "x"), ("int", 0, 0)])],
         [(1, 0)], "cse", True),
        ([(xx1, [("ext", "x")]), (xxt, [("ext", "x"), ("int", 0, 0)])],
         [(1, 0)], "raw", False),
        ([(two, [("ext", "x")]), (mul, [("int", 0, 1), ("int", 0, 0)])],
         [(1, 0)], "swap", True),
    ]
    out = []
    for parts, keep, name, opt in cases:
        fused, ext = fuse(parts, keep_outputs=keep, name=name,
                          run_optimize=opt)
        n_in = len(fused.inputs)
        vals = fused.evaluate([X, Y][:n_in])
        out.append((name, _fingerprint(pkg, fused), ext, fused.n_ops,
                    len(fused.inputs), len(fused.outputs),
                    pkg.fuse.to_fu_graph(fused).n_io,
                    [np.asarray(v, np.float32).tobytes() for v in vals]))
    g = pkg.dfg.trace(lambda x, y: x * y + 3.0, 2, "ma")
    m = pkg.fuse.fuse_muladd(g)
    out.append(("muladd", [n.op for n in m.op_nodes()],
                np.asarray(m.evaluate([X, Y])[0]).tobytes()))
    return out


def test_fused_dfgs_equal_the_reference():
    r, t = both(_fusions)
    assert t == r
    by_name = {c[0]: c for c in t}
    assert by_name["a>b"][4:6] == (1, 1)
    assert by_name["cse"][3] < by_name["raw"][3]
    assert by_name["lean"][6] < by_name["tee"][6]


def test_fused_pair_equals_sequential_execution():
    a = _dfg(T, lambda x: x * 2.0 + 1.0, 1, "a")
    b = _dfg(T, lambda x: x * x - 3.0, 1, "b")
    fused, ext = T.fuse.fuse_dfgs([(a, [("ext", "x")]), (b, [("int", 0, 0)])],
                                  keep_outputs=[(1, 0)], name="a>b")
    assert ext == ["x"]
    xt = torch.from_numpy(X)
    np.testing.assert_array_equal(fused.evaluate([X])[0],
                                  b.evaluate([a.evaluate([X])[0]])[0])
    assert torch.equal(fused.evaluate([xt])[0],
                       b.evaluate([a.evaluate([xt])[0]])[0])


def _bad_fusions(pkg):
    fuse, err = pkg.fuse.fuse_dfgs, pkg.fuse.FusionError
    a = _dfg(pkg, lambda x: x + 1.0, 1, "a")
    b = _dfg(pkg, lambda x: x * 2.0, 1, "b")
    msgs = []
    for parts, keep in (([(a, [])], [(0, 0)]),
                        ([(a, [("int", 1, 0)]), (b, [("int", 0, 0)])],
                         [(1, 0)]),
                        ([(a, [("ext", "x")])], [(0, 3)]),
                        ([(a, [("ext", "x")])], []),
                        ([(a, [("bad", 0)])], [(0, 0)])):
        with pytest.raises(err) as info:
            fuse(parts, keep_outputs=keep)
        msgs.append(str(info.value))
    return msgs


def test_fusion_errors_equal_the_reference():
    r, t = both(_bad_fusions)
    assert t == r and len(t) == 5


def test_fused_dfg_failing_the_semantic_checks_raises_fusion_error(
        monkeypatch):
    """Every fused DFG passes the A0xx checks before it can reach a
    compile; a fusion that leaves a broken DFG raises FusionError."""
    from repro_torch.analysis import dfg_checks
    a = _dfg(T, lambda x: x + 1.0, 1, "a")
    real = dfg_checks.check_dfg

    def broken(g, origin=None):
        node = next(iter(g.op_nodes()))
        node.args = (10_000,) + tuple(node.args[1:])   # undefined producer
        return real(g, origin=origin)

    monkeypatch.setattr(dfg_checks, "check_dfg", broken)
    with pytest.raises(T.fuse.FusionError, match="semantic checks"):
        T.fuse.fuse_dfgs([(a, [("ext", "x")])], keep_outputs=[(0, 0)])


def test_random_dfg_pair_fusion_matches_the_reference():
    """For random pairs of small kernels (B reads A's result and the
    shared input) the port's fused DFG has the reference's fingerprint and
    runs bit-identically to A then B."""
    rng = np.random.default_rng(11)
    ops2 = [lambda u, v: u + v, lambda u, v: u - v, lambda u, v: u * v]

    def build_fn(code):
        def fn(*args):
            vals = list(args)
            for op, li, ri in code:
                vals.append(ops2[op](vals[li % len(vals)],
                                     vals[ri % len(vals)]))
            return vals[-1]
        return fn

    x = rng.uniform(-3, 3, 16).astype(np.float32)
    for _ in range(25):
        code_a, code_b = ([tuple(int(v) for v in rng.integers(0, (3, 8, 8)))
                           for _ in range(rng.integers(1, 6))]
                          for _ in range(2))

        def fused(pkg):
            a = _dfg(pkg, build_fn(code_a), 1, "A")
            b = _dfg(pkg, build_fn(code_b), 2, "B")
            g, ext = pkg.fuse.fuse_dfgs(
                [(a, [("ext", "x")]), (b, [("ext", "x"), ("int", 0, 0)])],
                keep_outputs=[(1, 0)], name="prop")
            seq = b.evaluate([x, a.evaluate([x])[0]])[0]
            return (_fingerprint(pkg, g), ext,
                    np.asarray(g.evaluate([x])[0], np.float32).tobytes(),
                    np.asarray(seq, np.float32).tobytes())
        r, t = both(fused)
        assert t == r and t[2] == t[3]


# ------------------------------------------------- capture and partitions

def _pipeline(pkg, sess, k=None, opts=None):
    opts = opts or pkg.CompileOptions(max_replicas=4)
    with sess.capture("tenant-a", name="pipe") as g:
        buf = g.input("x")
        for fn, name in STAGES[:k or len(STAGES)]:
            buf = g.call(fn, opts.replace(n_inputs=1, name=name), buf)
    return g


def _partition_record(parts):
    return [(p.index, p.node_ids, p.deps, list(p.ext), p.outputs,
             dataclasses.astuple(p.opts), len(p.dfg.inputs),
             len(p.dfg.outputs), p.dfg.name) for p in parts]


def _partitions(pkg):
    spec = pkg.spec()
    out = []
    with pkg.new_session([pkg.Device("a", spec)]) as sess:
        g = _pipeline(pkg, sess)
        assert sess.cache.stats.misses == 0          # recording compiles
        assert sess.stats()["queues"] == 0           # and enqueues nothing
        out.append((g.fingerprint(), [b.ref() for b in g.outputs]))
        for cap in (None, 1, 2):
            parts = pkg.graph.partition_graph(g, spec, max_partition_fus=cap)
            out.append(_partition_record(parts))
            out.append([_fingerprint(pkg, p.dfg) for p in parts])
        with sess.capture(name="mixed") as m:
            x = m.input()
            t = m.call(STAGES[0][0], pkg.CompileOptions(n_inputs=1, seed=0),
                       x)
            m.call(STAGES[1][0], pkg.CompileOptions(n_inputs=1, seed=9), t)
        out.append(_partition_record(pkg.graph.partition_graph(m, spec)))
        src = pkg.BENCHMARKS["poly1"][0]
        for name in ("warm1", "warm2"):
            with sess.capture(name=name) as w:
                w.call(src, None, w.input())
        out.append(sess.cache.stats.as_dict())
    tiny = pkg.spec(2, 2)
    with pkg.new_session([pkg.Device("t", tiny)]) as sess:
        with sess.capture(name="toolarge") as big:
            big.call(pkg.BENCHMARKS["mibench"][0], None, big.input(),
                     big.input())
    with pytest.raises(pkg.graph.GraphError, match="does not fit"):
        pkg.graph.partition_graph(big, tiny)
    return out


def test_capture_and_partitions_equal_the_reference():
    r, t = both(_partitions)
    assert t == r
    assert len(t[1]) == 1 and len(t[3]) > 1 and len(t[7]) == 2


def _wiring_errors(pkg):
    err = pkg.graph.GraphError
    opts = pkg.CompileOptions(n_inputs=1)
    with pkg.new_session([pkg.Device("a", pkg.spec())]) as sess:
        with sess.capture() as g:
            x = g.input()
            y = g.call(STAGES[0][0], opts, x)
            with pytest.raises(err, match="g.input"):
                g.call(STAGES[1][0], opts, X)
            with pytest.raises(err, match="takes 1 buffers"):
                g.call(STAGES[1][0], opts, x, y)
        with sess.capture() as g2:
            with pytest.raises(err, match="different capture"):
                g2.call(STAGES[0][0], opts, x)
            g2.call(STAGES[0][0], opts, g2.input())
        with pytest.raises(err, match="frozen"):
            g.call(STAGES[0][0], opts, x)
    g = pkg.graph.KernelGraph("manual")
    x = g.input()
    a = g.call(lambda v: v + 1.0, opts, x)
    b = g.call(lambda v: v * 2.0, opts, a)
    g.freeze()
    g.nodes[a.nid].args = (b,)
    with pytest.raises(err, match="cycle"):
        g.validate()
    g.nodes[a.nid].args = (x,)
    g.validate()
    return g.fingerprint(), g2.fingerprint()


def test_capture_validation_equals_the_reference():
    r, t = both(_wiring_errors)
    assert t == r


# ------------------------------------------------------- instantiate/launch

def _replay(pkg, cap):
    # one build worker: the partitions' compile events then end in a fixed
    # order, far apart on the host clock, so the modelled timeline (which
    # later launches backfill, and whose configurations they may reuse) is
    # the same in every run and in both packages
    with pkg.new_session([pkg.Device("a", pkg.spec())],
                         max_workers=1) as sess:
        g = _pipeline(pkg, sess)
        gx = sess.instantiate(g, max_partition_fus=cap)
        evs = [sess.launch(gx, XG) for _ in range(3)]
        q = sess.queue_for("tenant-a", "a")
        parts = [e for e in q.events if e.kernel_name.startswith("graph:")]
        for a, b in zip(parts, parts[1:gx.n_partitions]):
            assert a in b.deps and b.t_submit_us >= a.t_end_us
        node = sess.launch_nodewise(g, XG, tenant="tenant-b")
        assert_same_bits(host(node.outputs[0]), host(evs[0].outputs[0]))
        with pytest.raises(pkg.graph.GraphError, match="expected 1 inputs"):
            sess.launch(gx, XG, XG)
        fabric = sess.devices[0].fu_used
        gx.release()
        return (gx.n_partitions, [session_event(e) for e in parts],
                session_event(node), sess.config_charges(),
                fabric - sess.devices[0].fu_used, _partition_record(
                    gx.partitions), sess.cache.stats.as_dict(),
                host(evs[-1].outputs[0]).tobytes())


@pytest.mark.parametrize("cap", [None, 1])
def test_graph_replay_equals_nodewise_and_the_reference(cap):
    r, t = both(_replay, cap)
    assert t == r
    want = XG
    for fn, _ in STAGES:
        want = np.asarray(fn(want), np.float32)
    assert_same_bits(np.frombuffer(t[-1], np.float32), want)
    if cap is None:
        assert t[0] == 1


def test_graph_replay_runs_one_executor_image_per_partition():
    with T.new_session([T.Device("a", T.spec())]) as sess:
        g = _pipeline(T, sess)
        gx = sess.instantiate(g, max_partition_fus=1)
        loads = ops.image_loads
        for _ in range(4):
            ev = sess.launch(gx, XG)
        assert ops.image_loads == loads + gx.n_partitions
        assert all(o.device.type == "cpu" for o in ev.outputs)
        assert kernel.LIBRARY.builds == 0


def _graph_replay_example(pkg):
    """``examples/graph_replay.py``: five requests through a four-stage
    pipeline, nodewise and as an instantiated graph."""
    opts = pkg.CompileOptions(max_replicas=4)
    stages = [("normalize", lambda x: x * 0.5 - 1.0),
              ("poly1", pkg.BENCHMARKS["poly1"][0]),
              ("act", lambda x: x * x * 0.25 + x),
              ("rescale", lambda x: x * 0.125 + 2.0)]
    out = {}
    for mode in ("nodewise", "graph"):
        rng = np.random.default_rng(0)
        # one build worker, so the modelled timeline is the same in every
        # run (see _replay)
        with pkg.new_session([pkg.Device("ovl0", pkg.spec())],
                             max_workers=1) as sess:
            with sess.capture("tenant-a", name="pipeline") as g:
                buf = g.input("x")
                for name, src in stages:
                    buf = g.call(src, opts.replace(n_inputs=1, name=name),
                                 buf)
            gx = sess.instantiate(g) if mode == "graph" else None
            last = []
            for _ in range(5):
                x = rng.uniform(0, 2, 5_000).astype(np.float32)
                ev = sess.launch(gx, x) if gx is not None else \
                    sess.launch_nodewise(g, x)
                last.append(host(ev.wait()[0]).tobytes())
            makespan = max(c.engine_end_us for c in sess.contexts.values())
            out[mode] = (last, sess.config_charges(),
                         sess.cache.stats.misses,
                         gx.n_partitions if gx else len(g.nodes))
            out[mode + "_span"] = makespan
    assert out["graph"][0] == out["nodewise"][0]
    return {k: v for k, v in out.items() if not k.endswith("_span")}


def test_graph_replay_example_flow_equals_the_reference():
    r, t = both(_graph_replay_example)
    assert t == r
    assert t["graph"][1]["charges"] == 1
    assert t["nodewise"][1]["charges"] > t["graph"][1]["charges"]


def _warm_restart(pkg, tmp_path):
    persist = str(tmp_path / pkg.root)
    with pkg.new_session([pkg.Device("a", pkg.spec())],
                         persist_dir=persist) as sess:
        g = _pipeline(pkg, sess)
        with sess.instantiate(g).result():
            pass
        misses = sess.cache.stats.misses
        sess.instantiate(g).result()
        assert sess.cache.stats.misses == misses
        want = host(sess.launch(sess.instantiate(g), XG).outputs[0])
        first = (sess.cache.stats.as_dict(), sess.stats()["graph_plans"])
    with pkg.new_session([pkg.Device("a", pkg.spec())],
                         cache=pkg.JITCache(persist_dir=persist)) as sess:
        g = _pipeline(pkg, sess)
        gx = sess.instantiate(g).result()
        got = host(sess.launch(gx, XG).outputs[0])
        assert sess.cache.stats.disk_hits == gx.n_partitions
        return first, sess.cache.stats.as_dict(), got.tobytes(), \
            want.tobytes()


def test_reinstantiation_is_warm_as_in_the_reference(tmp_path):
    r, t = both(_warm_restart, tmp_path)
    assert t == r
    assert t[1]["misses"] == 0 and t[2] == t[3]


def _mixed_traffic(pkg):
    with pkg.new_session([pkg.Device("a", pkg.spec())]) as sess:
        gx = sess.instantiate(_pipeline(pkg, sess, k=2))
        fut = sess.compile(pkg.BENCHMARKS["poly1"][0],
                           pkg.CompileOptions(max_replicas=4),
                           tenant="tenant-b")
        ev_g = sess.launch(gx, XG)
        ev_k = sess.enqueue(fut, XG)
        assert sess.ledger_consistent()
        return (session_event(ev_g), session_event(ev_k),
                sess.config_charges(), sess.ledger())


def test_graph_and_kernel_traffic_interleave_as_in_the_reference():
    r, t = both(_mixed_traffic)
    assert t == r


# --------------------------------------------------------------- on a card

@gpu
def test_graph_replay_on_the_card_is_one_launch_per_partition():
    x = np.random.default_rng(0).uniform(-1.5, 1.5, 1 << 20) \
        .astype(np.float32)
    with T.session.Session([T.Device("a", T.spec())]) as sess:
        g = _pipeline(T, sess)
        for cap in (None, 1):
            gx = sess.instantiate(g, max_partition_fus=cap).result()
            before = kernel.overlay_execute.launches
            ev = sess.launch(gx, x)
            assert kernel.overlay_execute.launches - before == \
                gx.n_partitions
            out = ev.outputs[0]
            assert out.device.type == "cuda"
            node = sess.launch_nodewise(g, x, tenant="tenant-b")
            assert_same_bits(out.read(), node.outputs[0].read())
    with R.session.Session([R.Device("a", R.spec())]) as sess:
        want = sess.launch(sess.instantiate(_pipeline(R, sess)), x)
    assert_same_bits(out.read(), want.outputs[0].read())
