"""The port's observability plane against the JAX package's.

Each claim of ``tests/test_obs.py`` runs through ``repro.obs`` and
``repro_torch.obs`` on the same inputs: span nesting and the disabled
path, the metrics instruments, the Chrome-trace export (byte for byte
against ``tests/data/obs_trace_golden.json``), replay profiles through the
port's disk and remote cache tiers, the re-cutter's never-worse contract
(the swap bit-identical and warm), the Session's stats sections, the SLO
violation counters and the serving trace's coverage.

Every time a profile, a re-cut estimate or a modelled span holds is the
queues' model, so it must equal the reference's exactly.  The Sessions
build on one held worker with their host clock frozen
(``torch_runtime_pair.ordered_builds`` and ``freeze_clock``), which makes
that model the same in every run; the tracer's own wall clock is compared
only through the spans' structure.
"""

import json
import threading

import numpy as np
import pytest
import torch

import repro_torch.obs as tobs
from torch_runtime_pair import (R, T, both, modelled_session,
                                ordered_builds)

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning",
                                        "ignore::DeprecationWarning")

GOLDEN = "tests/data/obs_trace_golden.json"


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def ticking_clock(step_us=10.0):
    """Deterministic injectable tracer clock: 0, step, 2*step, ..."""
    state = {"t": -step_us}

    def clock():
        state["t"] += step_us
        return state["t"]

    return clock


def span_record(s) -> tuple:
    return (s.name, s.cat, s.track, s.ts_us, s.dur_us, s.depth,
            s.parent, s.sid, dict(s.args), s.error)


def session(pkg, devices=None, **kw):
    devices = devices or [pkg.Device("a", pkg.spec())]
    return modelled_session(pkg, devices, **kw)


def instantiate(sess, graph, **kw):
    """Instantiate ``graph`` with its builds in order, all landed."""
    with ordered_builds(sess):
        return sess.instantiate(graph, **kw)


# ------------------------------------------------------------------ tracer

def _nest_one_thread(pkg):
    tr = pkg.trace.Tracer(clock=ticking_clock())
    with pkg.trace.activate(tr):
        with pkg.trace.span("outer", "compile", kernel="k") as sp:
            sp["hit"] = False
            with pkg.trace.span("inner", "cache"):
                pass
    outer = next(s for s in tr.spans() if s.name == "outer")
    inner = next(s for s in tr.spans() if s.name == "inner")
    assert outer.parent is None and outer.depth == 0
    assert inner.parent == outer.sid and inner.depth == 1
    assert outer.args == {"kernel": "k", "hit": False}
    assert inner.ts_us >= outer.ts_us and outer.dur_us > inner.dur_us
    return [span_record(s) for s in tr.spans()]


def test_spans_nest_on_one_thread_as_the_reference():
    r, t = both(_nest_one_thread)
    assert t == r


def _nest_threads(pkg):
    tr = pkg.trace.Tracer()
    barrier = threading.Barrier(4)

    def worker(tag):
        with pkg.trace.activate(tr):
            with pkg.trace.span(f"outer:{tag}", "compile"):
                barrier.wait(timeout=30)       # all outers open at once
                with pkg.trace.span(f"inner:{tag}", "compile"):
                    barrier.wait(timeout=30)

    threads = [threading.Thread(target=worker, args=(i,), name=f"w{i}")
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    spans = {s.name: s for s in tr.spans()}
    assert len(spans) == 8
    for i in range(4):
        outer, inner = spans[f"outer:{i}"], spans[f"inner:{i}"]
        assert outer.parent is None and inner.parent == outer.sid
        assert outer.track == inner.track == f"w{i}"
    return sorted((s.name, s.track, s.depth) for s in spans.values())


def test_span_nesting_across_threads_as_the_reference():
    r, t = both(_nest_threads)
    assert t == r


def test_disabled_path_is_shared_noop():
    tr_mod = T.trace
    assert tr_mod.active_tracer() is None
    sp = tr_mod.span("anything", "compile", key="v")
    assert sp is tr_mod._NULL_SPAN             # one shared object, no alloc
    with sp as h:
        h["outcome"] = "ignored"
    tr = tr_mod.Tracer()
    with tr_mod.activate(tr):
        assert tr_mod.active_tracer() is tr
        with tr_mod.activate(None):
            assert tr_mod.active_tracer() is None
            assert tr_mod.span("x") is tr_mod._NULL_SPAN
        assert tr_mod.active_tracer() is tr
    assert tr_mod.active_tracer() is None
    assert tr.n_spans == 0
    assert tobs.span is tr_mod.span and tobs.Tracer is tr_mod.Tracer


def _error_and_modelled(pkg):
    tr = pkg.trace.Tracer(clock=ticking_clock())
    with pkg.trace.activate(tr):
        with pytest.raises(ValueError):
            with pkg.trace.span("boom", "compile"):
                raise ValueError("injected")
    tr.add_modelled("exec:k", "dev:a/t0", 100.0, 50.0, items=64)
    boom = next(s for s in tr.spans() if s.name == "boom")
    assert boom.error == "ValueError: injected"
    dev = next(s for s in tr.spans() if s.name == "exec:k")
    assert dev.parent is None and dev.depth == 0
    assert (dev.ts_us, dev.dur_us, dev.cat) == (100.0, 50.0, "device")
    assert tr.counts_by_cat() == {"compile": 1, "device": 1}
    return [span_record(s) for s in tr.spans()], tr.summary()


def test_span_records_error_and_modelled_spans_are_roots_as_the_reference():
    r, t = both(_error_and_modelled)
    assert t == r


# ----------------------------------------------------------------- metrics

def _instruments(pkg):
    m = pkg.metrics.MetricsRegistry()
    c = m.counter("a.count")
    assert m.counter("a.count") is c           # get-or-create
    c.inc()
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1)
    m.gauge("a.gauge").set(7)
    h = m.histogram("a.hist")
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(50.0) == 50.0 and h.percentile(99.0) == 99.0
    s = h.summary()
    assert s["n"] == 100 and s["max"] == 100.0 and s["mean"] == 50.5
    with pytest.raises(TypeError):
        m.gauge("a.count")                     # kind mismatch is an error
    d = m.as_dict()
    assert d["counters"] == {"a.count": 3.5}
    assert d["gauges"] == {"a.gauge": 7.0}
    assert d["histograms"]["a.hist"]["p99"] == 99.0
    return d, repr(m), repr(c), repr(h)


def test_metrics_instruments_and_registry_as_the_reference():
    r, t = both(_instruments)
    assert t == r


def _window(pkg):
    h = pkg.metrics.MetricsRegistry().histogram("w", window=8)
    for v in range(100):
        h.observe(float(v))
    s = h.summary()
    assert s["n"] == 100 and s["p50"] >= 92.0
    with pytest.raises(ValueError):
        pkg.metrics.Histogram("bad", window=0)
    return s


def test_histogram_window_bounds_samples_keeps_totals_as_the_reference():
    r, t = both(_window)
    assert t == r


def _install(pkg):
    with session(pkg, metrics=pkg.metrics.MetricsRegistry()) as sess:
        sess.metrics.counter("builds").inc(3)
        obs = sess.stats()["obs"]
        assert obs["counters"] == {"builds": 3.0}
        return obs


def test_metrics_install_lands_in_session_stats_as_the_reference():
    r, t = both(_install)
    assert t == r


# ------------------------------------------------------------------ export

def golden_tracer(pkg):
    """The deterministic trace behind tests/data/obs_trace_golden.json."""
    tr = pkg.trace.Tracer(clock=ticking_clock())
    with pkg.trace.activate(tr):
        with pkg.trace.span("jit:build", "compile", kernel="poly1"):
            with pkg.trace.span("jit:frontend", "compile"):
                pass
            with pkg.trace.span("cache:disk", "cache", kind="kernel") as sp:
                sp["hit"] = False
        try:
            with pkg.trace.span("jit:route", "compile", kernel="poly1"):
                raise RuntimeError("no feasible route")
        except RuntimeError:
            pass
    tr.add_modelled("wait:k", "dev:a/t0", 0.0, 5.5, cat="queue",
                    gap_us=5.5)
    tr.add_modelled("config:k", "dev:a/t0", 5.5, 40.0, cat="device")
    tr.add_modelled("k", "dev:a/t0", 45.5, 100.0, cat="device",
                    items=4096, replicas=4)
    return tr


def test_chrome_trace_export_matches_golden(tmp_path):
    """Byte-stable export: the golden file IS the format contract."""
    path = tobs.write_chrome_trace(golden_tracer(T),
                                   str(tmp_path / "t.json"))
    got = open(path, encoding="utf-8").read()
    want = open(GOLDEN, encoding="utf-8").read()
    assert got == want
    assert tobs.render_summary(golden_tracer(T)) == \
        R.export.render_summary(golden_tracer(R))
    assert tobs.render_summary(T.trace.Tracer()) == \
        R.export.render_summary(R.trace.Tracer())


def _structure(pkg):
    doc = pkg.export.chrome_trace(golden_tracer(pkg))
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert {e["pid"] for e in xs if e["name"].startswith("jit:")} == {1}
    assert {e["pid"] for e in xs if e["name"] == "k"} == {2}
    assert next(e for e in xs if e["name"] == "wait:k")["pid"] == 2
    build = next(e for e in xs if e["name"] == "jit:build")
    disk = next(e for e in xs if e["name"] == "cache:disk")
    assert disk["args"]["parent"] == build["args"]["sid"]
    assert disk["args"]["hit"] is False
    route = next(e for e in xs if e["name"] == "jit:route")
    assert route["args"]["error"] == "RuntimeError: no feasible route"
    names = {(m["name"], m["args"]["name"]) for m in metas}
    assert ("process_name", "host") in names
    assert ("process_name", "overlay (modelled)") in names
    assert ("thread_name", "dev:a/t0") in names
    return json.dumps(doc, sort_keys=True)


def test_chrome_trace_structure_as_the_reference():
    r, t = both(_structure)
    assert t == r


# ------------------------------------------------------------ profile store

def _chain_graph(pkg, sess, mults=18, name="g"):
    """``tests/test_obs.py``'s two-stage chain of multiply-add ladders."""
    opts = pkg.CompileOptions(max_replicas=4, n_inputs=1)

    def wide(k):
        def fn(x):
            for _ in range(k):
                x = x * 1.01 + 0.001
            return x
        return fn

    with sess.capture("t", name=name) as g:
        b = g.input("x")
        b = g.call(wide(mults), opts.replace(name="s0"), b)
        b = g.call(wide(mults), opts.replace(name="s1"), b)
    return g


def _replays(pkg, sess, gx, x, n):
    for _ in range(n):
        sess.launch(gx, x).wait()


def _profile_round_trip(pkg, root):
    root = root / pkg.root
    sticky = pkg.recovery.RetryPolicy(breaker_cooldown_s=60.0)
    Store = pkg.profile.ProfileStore
    blobs = pkg.remote.RemoteBlobStore()
    rc = pkg.remote.RemoteCache([pkg.remote.RemoteEndpoint(blobs, "r0")],
                                retry=sticky)
    x = np.linspace(0, 1, 50_000).astype(np.float32)
    with session(pkg, persist_dir=root, remote=rc) as sess:
        sess.profiles = Store(cache=sess.cache)
        g = _chain_graph(pkg, sess)
        gx = instantiate(sess, g)
        _replays(pkg, sess, gx, x, 3)
        spec = sess.scheduler.partition_spec()
        key = pkg.profile.profile_key(g.fingerprint(), spec)
        prof = sess.profiles.get(key)
        assert prof is not None and prof.replays == 3
        assert prof.items_per_replay() == 50_000.0
        assert prof.config_unit_us() > 0
        assert sess.profiles.stats_dict()["flushes"] == 3
        assert pkg.profile.hot_profiles(sess.profiles) == [prof]
        first = (prof.as_dict(), sess.profiles.stats_dict(),
                 sess.stats()["profiles"])
    disk_only = Store(cache=pkg.JITCache(persist_dir=root))
    got = disk_only.get(key)
    assert got is not None and got.replays == 3
    assert got.graph_fp == g.fingerprint()
    assert type(got).__module__ == f"{pkg.root}.obs.profile"
    assert disk_only.stats_dict()["loads_disk"] == 1
    assert disk_only.get(key) is got              # memory tier after load
    assert disk_only.stats_dict()["loads_memory"] == 1
    rc2 = pkg.remote.RemoteCache([pkg.remote.RemoteEndpoint(blobs, "r1")],
                                 retry=sticky)
    promote = root / "host2"
    remote_host = Store(cache=pkg.JITCache(persist_dir=promote, remote=rc2))
    got2 = remote_host.get(key)
    assert got2 is not None and got2.replays == 3
    assert remote_host.stats_dict()["loads_remote"] == 1
    assert Store(cache=pkg.JITCache(persist_dir=promote)).get(key) \
        is not None
    assert Store(cache=pkg.JITCache()).get("profile:nope") is None
    return (key, first, got.as_dict(), disk_only.stats_dict(),
            got2.as_dict(), remote_host.stats_dict())


def test_profile_store_round_trip_disk_and_remote_as_the_reference(
        tmp_path):
    r, t = both(_profile_round_trip, tmp_path)
    assert t == r


def test_port_profile_blobs_are_the_ports_own(tmp_path):
    """A profile the JAX package persisted is quarantined by the port's
    disk tier, never unpickled (the blobs' magic differs)."""
    _profile_round_trip(R, tmp_path)
    root = tmp_path / "repro"
    with R.session.Session([R.Device("a", R.spec())]) as sess:
        g = _chain_graph(R, sess)
        key = R.profile.profile_key(g.fingerprint(),
                                    sess.scheduler.partition_spec())
    store = T.profile.ProfileStore(cache=T.JITCache(persist_dir=root))
    assert store.get(key) is None
    assert store.stats_dict()["load_misses"] == 1


def _profile_reset(pkg):
    x = np.linspace(0, 1, 10_000).astype(np.float32)
    with session(pkg) as sess:
        sess.profiles = pkg.profile.ProfileStore(cache=sess.cache)
        g = _chain_graph(pkg, sess)
        gx = instantiate(sess, g)
        _replays(pkg, sess, gx, x, 2)
        spec = sess.scheduler.partition_spec()
        prof = sess.profiles.get(pkg.profile.profile_key(g.fingerprint(),
                                                         spec))
        assert prof.replays == 2
        before = prof.as_dict()
        gx.release()
        gx2 = instantiate(sess, g, max_partition_fus=20)
        assert gx2.n_partitions == 2
        sess.launch(gx2, x).wait()
        assert prof.replays == 1
        assert prof.cut == tuple(tuple(p.node_ids) for p in gx2.partitions)
        return before, prof.as_dict()


def test_profile_resets_when_the_cut_changes_as_the_reference():
    r, t = both(_profile_reset)
    assert t == r


# -------------------------------------------------------------- re-cutting

def _recut_swap(pkg):
    x = np.linspace(0, 1, 4_000_000).astype(np.float32)
    with session(pkg) as sess:
        sess.profiles = pkg.profile.ProfileStore(cache=sess.cache)
        g = _chain_graph(pkg, sess)
        spec = sess.scheduler.partition_spec()
        sess.adopt_graph_plan(g, pkg.graph.partition_graph_grouped(
            g, spec, [[0], [1]]))
        gx = instantiate(sess, g)
        assert gx.n_partitions == 2               # the stale cut is live
        _replays(pkg, sess, gx, x, 2)
        out_old = sess.launch(gx, x).outputs[0].read()
        ctx = next(iter(sess.contexts.values()))
        mark = ctx.engine_end_us
        sess.launch(gx, x).wait()
        old_replay_us = ctx.engine_end_us - mark
        gx.release()

        rec = pkg.recut.ReCutter(sess, sess.profiles)
        with ordered_builds(sess):
            res = rec.consider(g)
        assert res.swapped and res.reason == "swapped"
        assert res.old_cut == ((0,), (1,)) and res.new_cut == ((0, 1),)
        assert res.new_est_us * rec.min_gain <= res.old_est_us
        assert res.gain > 1.0 and rec.stats_dict()["swapped"] == 1
        out_new = sess.launch(res.gexec, x).outputs[0].read()
        np.testing.assert_array_equal(out_old, out_new)   # bit-identical
        assert sess.recovery.as_dict()["fallback_nodewise"] == 0
        mark = ctx.engine_end_us
        sess.launch(res.gexec, x).wait()
        new_replay_us = ctx.engine_end_us - mark
        assert new_replay_us < old_replay_us
        res.gexec.release()
        misses = sess.cache.stats.misses
        gx2 = instantiate(sess, g)                 # rides the adopted plan
        assert tuple(tuple(p.node_ids) for p in gx2.partitions) == \
            res.new_cut
        sess.launch(gx2, x).wait()
        assert sess.cache.stats.misses == misses  # fully warm
        return (res.as_dict(), old_replay_us, new_replay_us,
                out_new[::4099].tobytes(), rec.stats_dict())


def test_recut_swap_wins_bit_identical_and_warm_as_the_reference():
    r, t = both(_recut_swap)
    assert t == r


def _recut_refuses_split(pkg):
    x = np.linspace(0, 1, 4_000_000).astype(np.float32)
    with session(pkg) as sess:
        sess.profiles = pkg.profile.ProfileStore(cache=sess.cache)
        g = _chain_graph(pkg, sess)
        gx = instantiate(sess, g)
        assert gx.n_partitions == 1               # greedy fuses the chain
        _replays(pkg, sess, gx, x, 3)
        misses = sess.cache.stats.misses
        res = pkg.recut.ReCutter(sess, sess.profiles).consider(g)
        assert not res.swapped and res.reason == "kept"
        assert res.new_cut == res.old_cut == ((0, 1),)
        assert sess.cache.stats.misses == misses  # no compile
        return res.as_dict()


def test_recut_refuses_optimistic_split_of_fused_cut_as_the_reference():
    r, t = both(_recut_refuses_split)
    assert t == r


def _recut_config_dominated(pkg):
    x = np.linspace(0, 1, 10_000).astype(np.float32)
    with session(pkg) as sess:
        sess.profiles = pkg.profile.ProfileStore(cache=sess.cache)
        g = _chain_graph(pkg, sess)
        gx = instantiate(sess, g)
        _replays(pkg, sess, gx, x, 3)
        misses = sess.cache.stats.misses
        res = pkg.recut.ReCutter(sess, sess.profiles).consider(g)
        assert not res.swapped and res.reason == "kept"
        assert res.gain == 1.0
        assert res.new_est_us >= res.old_est_us / 1.01
        assert sess.cache.stats.misses == misses
        spec = sess.scheduler.partition_spec()
        prof = sess.profiles.get(pkg.profile.profile_key(g.fingerprint(),
                                                         spec))
        plan = pkg.recut.plan_recut(g, spec, prof)
        est = pkg.recut.estimate_cut_us(g, spec, [[0, 1]], prof)
        return res.as_dict(), plan, est


def test_recut_never_worse_guard_config_dominated_as_the_reference():
    r, t = both(_recut_config_dominated)
    assert t == r


def _recut_cold(pkg):
    with session(pkg) as sess:
        store = pkg.profile.ProfileStore(cache=sess.cache)
        g = _chain_graph(pkg, sess)
        g.freeze()
        rec = pkg.recut.ReCutter(sess, store)
        res = rec.consider(g)
        assert not res.swapped and res.reason == "cold"
        assert rec.stats_dict() == dict(attempts=1, swapped=0, kept=0,
                                        cold=1, infeasible=0)
        return res.reason, res.old_cut, rec.stats_dict()


def test_recut_requires_a_hot_matching_profile_as_the_reference():
    r, t = both(_recut_cold)
    assert t == r


# ----------------------------------------------------------- session stats

def _sections(pkg):
    with session(pkg) as sess:
        sess.register_stats_section("zeta", lambda: {"z": 1})
        sess.register_stats_section("alpha", lambda: {"a": 1})
        keys = list(sess.stats())
        assert keys.index("alpha") == len(keys) - 2
        assert keys.index("zeta") == len(keys) - 1
        for builtin in ("cache", "devices", "queues", "recovery"):
            assert keys.index(builtin) < keys.index("alpha")
        for name in ("cache", "recovery", "profiles", "devices"):
            with pytest.raises(pkg.session.SessionError):
                sess.register_stats_section(name, dict)
        return keys


def test_stats_sections_order_and_collision_guard_as_the_reference():
    r, t = both(_sections)
    assert t == r


def _profiles_section(pkg):
    with session(pkg) as sess:
        assert "profiles" not in sess.stats()
        sess.profiles = pkg.profile.ProfileStore(cache=sess.cache)
        blob = sess.stats()["profiles"]
        assert blob["profiles"] == 0 and blob["records"] == 0
        return blob


def test_profiles_section_appears_when_attached_as_the_reference():
    r, t = both(_profiles_section)
    assert t == r


# ------------------------------------------------------------- serving SLO

def _slo_violations(pkg):
    tight = pkg.serve.SLOClass("tight", priority=25, target_p99_us=1e-6,
                               max_queue=16)
    rng = np.random.default_rng(0)
    devices = [pkg.Device("a", pkg.spec()), pkg.Device("b", pkg.spec())]
    with session(pkg, devices,
                 metrics=pkg.metrics.MetricsRegistry()) as sess:
        with ordered_builds(sess):
            srv = pkg.serve.InferenceServer(sess, ["mamba2"], max_batch=4)
        with srv:
            dim = srv.zoo["mamba2"].state_dim
            reqs = [pkg.serve.Request(
                "mamba2", rng.standard_normal(dim).astype(np.float32),
                decode_steps=3, slo=tight if i % 2 == 0 else None)
                for i in range(4)]
            for r in reqs:
                assert srv.submit(r)
            srv.run()
            serving = sess.stats()["serving"]
            assert serving["slo_violations"] == {"tight": 2}
            assert serving["latency_us"]["tight"]["n"] == 2
            counters = sess.stats()["obs"]["counters"]
            assert counters["serving.slo_violations.tight"] == 2.0
            return serving, counters, [r.output.tobytes() for r in reqs]


def test_slo_violations_counted_per_class_and_in_metrics_as_the_reference():
    r, t = both(_slo_violations)
    assert t == r


# --------------------------------------------------- end-to-end trace cover

def _serving_trace(pkg, root, device="cpu"):
    rng = np.random.default_rng(1)
    tracer = pkg.trace.Tracer()
    outputs = []
    with session(pkg, persist_dir=root / pkg.root, tracer=tracer,
                 device=device) as sess:
        with ordered_builds(sess):
            srv = pkg.serve.InferenceServer(sess, ["mamba2", "moe"],
                                            max_batch=2)
        with srv:
            for _ in range(2):
                reqs = []
                for fam in ("mamba2", "moe"):
                    dim = srv.zoo[fam].state_dim
                    for _ in range(2):
                        reqs.append(pkg.serve.Request(
                            fam, rng.standard_normal(dim).astype(np.float32),
                            decode_steps=2))
                        assert srv.submit(reqs[-1])
                srv.run()
                outputs += [r.output.tobytes() for r in reqs]
    cats = tracer.counts_by_cat()
    for cat in ("compile", "cache", "queue", "device", "serving"):
        assert cats.get(cat, 0) > 0, (cat, cats)
    names = {s.name for s in tracer.spans()}
    assert any(n.startswith("serve:step:") for n in names)
    assert "jit:build" in names and "cache:disk" in names
    assert any(s.track.startswith("dev:a/") for s in tracer.spans())
    # the modelled rows (queue waits, config loads, executions) are the
    # model's own numbers
    rows = sorted((s.cat, s.name, s.track, s.ts_us, s.dur_us)
                  for s in tracer.spans() if s.cat in ("queue", "device"))
    steps = sorted(dict(s.args).get("joined", 0) for s in tracer.spans()
                   if s.name.startswith("serve:step:"))
    return cats, sorted(names), rows, steps, outputs


def test_serving_trace_covers_all_pipeline_boundaries_as_the_reference(
        tmp_path):
    r, t = both(_serving_trace, tmp_path)
    assert t == r


@gpu
def test_serving_trace_on_the_card_equals_the_cpu_port(tmp_path):
    card = _serving_trace(T, tmp_path / "card", device="cuda")
    host = _serving_trace(T, tmp_path / "host")
    assert card == host
