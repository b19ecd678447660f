"""The port's compile cache against the JAX package's.

Keys are content-only, so ``repro_torch`` must compute ``repro``'s keys for
the same kernel (fingerprints, full keys, template and graph keys); the
in-memory, disk and remote tiers must count the same hits, misses and
quarantines over the same sequence of builds; and the artifacts they hand
out must be the ones ``repro`` builds (bitstream and program hashes).

The port's blobs carry a wire magic of their own: a blob ``repro`` wrote
into a shared directory is quarantined as corrupt by the port, never
unpickled (which would import ``repro`` and JAX) — checked in a fresh
interpreter.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_runtime_pair import R, T, both

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(T.BENCHMARKS)


def _entry_files(root: Path):
    return sorted(root.glob("*/*.bin"))


def _artifact(ck) -> tuple:
    return (ck.name, ck.plan.replicas, ck.pr_path, ck.bitstream.sha256(),
            ck.program.content_hash())


# ----------------------------------------------------------------- keys

def _keys(pkg, name):
    cache = pkg.cache
    src = pkg.BENCHMARKS[name][0]
    spec = pkg.spec()
    g = pkg.jit.lower_to_dfg(src, parse_source=True)
    opts = pkg.CompileOptions
    keys = [cache.kernel_fingerprint(src),
            cache.kernel_fingerprint(g),
            cache.dfg_fingerprint(g),
            cache.spec_fingerprint(spec),
            cache.make_template_key(g, spec),
            cache.make_template_key(g, spec, seed=3, place_effort=0.5),
            cache.make_graph_key(cache.dfg_fingerprint(g), spec),
            cache.make_graph_key(cache.dfg_fingerprint(g), spec, 6)]
    for free_fus, free_io in ((64, 64), (40, 64), (64, 9), (7, 64)):
        for o in (opts(), opts(max_replicas=4, seed=1),
                  opts(pr_mode="joint", place_effort=0.5),
                  opts(min_template_fill=0.5, retry_budget=3)):
            keys.append(cache.make_cache_key(src, spec, free_fus=free_fus,
                                             free_io=free_io, opts=o))
    keys.append(cache.make_cache_key(src, pkg.spec(32, 8, 2), free_fus=256,
                                     free_io=80))
    return keys


@pytest.mark.parametrize("name", NAMES)
def test_cache_keys_equal_the_reference(name):
    r, t = both(_keys, name)
    assert t == r
    assert len(set(t)) > 10


def test_traced_kernel_keys_equal_the_reference():
    def keys(pkg):
        fp = pkg.cache.kernel_fingerprint
        def make(c):
            return lambda x: x * c + 1.0
        g = pkg.dfg.trace(lambda x, y: x * y + 3.0, 2, "ma")
        return [fp(make(2.0), n_inputs=1), fp(make(3.0), n_inputs=1),
                pkg.cache.dfg_fingerprint(g),
                pkg.cache.make_cache_key(make(2.0), pkg.spec(), 64, 64,
                                         n_inputs=1)]
    r, t = both(keys)
    assert t == r and t[0] != t[1]


# ------------------------------------------------------- in-memory tier

def _hit_miss_sequence(pkg):
    """The same builds against one JITCache: repeats, snapshot jitter
    inside one replica footprint, a new cap, a new mode, LRU eviction."""
    cache = pkg.JITCache(capacity=3)
    spec = pkg.spec()
    opts = pkg.CompileOptions
    b = pkg.BENCHMARKS
    seq = [(b["poly1"][0], opts(), 0),
           (b["poly1"][0], opts(), 0),
           (b["chebyshev"][0], opts(max_replicas=4), 0),
           (b["chebyshev"][0], opts(max_replicas=4), 1),
           (b["chebyshev"][0], opts(), 1),
           (b["chebyshev"][0], opts(), 2),
           (b["chebyshev"][0], opts(), 3),
           (b["poly2"][0], opts(max_replicas=2), 0),
           (b["poly1"][0], opts(), 0),
           (b["chebyshev"][0], opts(max_replicas=4, pr_mode="joint"), 0)]
    seen, trail = [], []
    for src, o, headroom in seq:
        ck = pkg.jit.jit_compile(src, spec, opts=o, fu_headroom=headroom,
                                 cache=cache)
        trail.append((any(ck is s for s in seen), _artifact(ck),
                      cache.stats.as_dict()))
        seen.append(ck)
    return trail, list(cache.keys())


def test_jitcache_statistics_follow_the_reference():
    r, t = both(_hit_miss_sequence)
    assert t == r
    stats = t[0][-1][2]
    assert stats["hits"] >= 2 and stats["evictions"] >= 1
    assert stats["template_hits"] >= 1 and stats["frontend_hits"] >= 1


def test_lru_eviction_order_follows_the_reference():
    def lru(pkg):
        spec, b = pkg.spec(), pkg.BENCHMARKS
        key = pkg.cache.make_cache_key
        cache = pkg.JITCache(capacity=2)
        ka, kb, kc = (key(b[n][0], spec, free_fus=64, free_io=64)
                      for n in ("poly1", "chebyshev", "poly2"))
        cache.put(ka, "A")
        cache.put(kb, "B")
        assert cache.get(ka) == "A"
        cache.put(kc, "C")
        assert kb not in cache
        assert cache.get(ka) == "A" and cache.get(kc) == "C"
        return cache.stats.as_dict(), list(cache.keys())
    r, t = both(lru)
    assert t == r
    assert t[0]["evictions"] == 1


def test_reservation_and_occupancy_jitter_follow_the_reference():
    def ledger(pkg):
        cache = pkg.JITCache()
        ctx = pkg.Context(pkg.Device("d", pkg.spec()), cache=cache)
        cheb = pkg.BENCHMARKS["chebyshev"][0]
        opts = pkg.CompileOptions(max_replicas=4)
        ctx.reserve(fus=1)
        p1 = ctx.build_program(cheb, opts=opts)
        p1.release()
        ctx.release(fus=1)
        ctx.reserve(fus=2)
        p2 = ctx.build_program(cheb, opts=opts)
        hit = p2.compiled is p1.compiled
        p2.release()
        ctx.release(fus=2)
        full = ctx.build_program(cheb, opts=pkg.CompileOptions())
        full.release()
        ctx.reserve(fus=ctx.device.spec.n_fus - 2 * full.compiled.fug.n_fus)
        small = ctx.build_program(cheb, opts=pkg.CompileOptions())
        return (hit, full.compiled.plan.replicas, small.compiled.plan.replicas,
                cache.stats.as_dict(), ctx.ledger_consistent())
    r, t = both(ledger)
    assert t == r
    assert t[0] is True and t[2] < t[1] and t[4]


def test_jit_compile_with_cache_returns_the_cached_artifact():
    cache = T.JITCache()
    src = T.BENCHMARKS["poly1"][0]
    a = T.jit.jit_compile(src, T.spec(), cache=cache)
    b = T.jit.jit_compile(src, T.spec(), cache=cache,
                          opts=T.CompileOptions())
    assert b is a
    assert (cache.stats.hits, cache.stats.misses) == (1, 1)
    # verified and unverified builds share one entry; "full" re-proves the
    # hit, which is clean, so nothing is quarantined
    for level in ("fused", "full"):
        assert T.jit.jit_compile(src, T.spec(), cache=cache,
                                 opts=T.CompileOptions(
                                     verify_level=level)) is a
    assert (cache.stats.hits, cache.stats.misses) == (3, 1)
    assert cache.stats.verify_quarantined == 0


# ------------------------------------------------------------ disk tier

def _disk_round_trip(pkg, tmp_path):
    d = tmp_path / pkg.root
    opts = pkg.CompileOptions(max_replicas=4)
    src, spec = pkg.BENCHMARKS["poly1"][0], pkg.spec()
    cold_cache = pkg.JITCache(persist_dir=d)
    cold = pkg.jit.jit_compile(src, spec, opts=opts, cache=cold_cache)
    warm_cache = pkg.JITCache(persist_dir=d)
    warm = pkg.jit.jit_compile(src, spec, opts=opts, cache=warm_cache)
    again = pkg.jit.jit_compile(src, spec, opts=opts, cache=warm_cache)
    assert warm is not cold and again is warm
    assert warm.placement.fu_pos == cold.placement.fu_pos
    assert warm.latency.delays == cold.latency.delays
    # a new replica count misses the full key but hits the template on disk
    fresh = pkg.JITCache(persist_dir=d)
    tpl = pkg.jit.jit_compile(src, spec, cache=fresh,
                              opts=pkg.CompileOptions(max_replicas=2,
                                                      pr_mode="template"))
    assert tpl.stage_times_ms["place"] == 0.0
    assert tpl.stage_times_ms["stamp"] > 0.0
    return (_artifact(cold), _artifact(warm), cold_cache.disk.writes,
            warm_cache.stats.as_dict(), fresh.stats.as_dict(),
            len(_entry_files(d)))


def test_disk_round_trip_follows_the_reference(tmp_path):
    r, t = both(_disk_round_trip, tmp_path)
    assert t == r
    assert t[3]["disk_hits"] == 1 and t[4]["disk_template_hits"] == 1


def test_disk_round_trip_cross_process(tmp_path):
    cache = T.JITCache(persist_dir=tmp_path)
    opts = T.CompileOptions(max_replicas=4)
    cold = T.jit.jit_compile(T.BENCHMARKS["poly1"][0], T.spec(), opts=opts,
                             cache=cache)
    child = (
        "import json, sys\n"
        "from repro_torch.configs.paper_suite import BENCHMARKS\n"
        "from repro_torch.core.cache import JITCache\n"
        "from repro_torch.core.jit import jit_compile\n"
        "from repro_torch.core.options import CompileOptions\n"
        "from repro_torch.core.overlay import OverlaySpec\n"
        f"cache = JITCache(persist_dir={str(tmp_path)!r})\n"
        "ck = jit_compile(BENCHMARKS['poly1'][0], OverlaySpec(8, 8, 2),\n"
        "                 opts=CompileOptions(max_replicas=4), cache=cache)\n"
        "print(json.dumps(dict(disk_hits=cache.stats.disk_hits,\n"
        "                      bs=ck.bitstream.sha256(),\n"
        "                      prog=ck.program.content_hash())))\n")
    got = _child(child)
    assert got == dict(disk_hits=1, bs=cold.bitstream.sha256(),
                       prog=cold.program.content_hash())


def _damage(pkg, tmp_path, how):
    d = tmp_path / pkg.root
    opts = pkg.CompileOptions(max_replicas=4)
    src, spec = pkg.BENCHMARKS["poly1"][0], pkg.spec()
    cold = pkg.jit.jit_compile(src, spec, opts=opts,
                               cache=pkg.JITCache(persist_dir=d))
    entries = _entry_files(d)
    for entry in entries:
        blob = bytearray(entry.read_bytes())
        if how == "flip":
            blob[len(blob) // 2] ^= 0xFF
        elif how == "truncate":
            blob = blob[:20]
        entry.write_bytes(bytes(blob))
    if how == "version":
        pkg.cache.DiskCache.SCHEMA_VERSION = 2
    try:
        fresh = pkg.JITCache(persist_dir=d)
        ck = pkg.jit.jit_compile(src, spec, opts=opts, cache=fresh)
        again = pkg.JITCache(persist_dir=d)
        pkg.jit.jit_compile(src, spec, opts=opts, cache=again)
    finally:
        pkg.cache.DiskCache.SCHEMA_VERSION = pkg.cache.WIRE_VERSION
    assert _artifact(ck) == _artifact(cold)
    return (len(entries), fresh.disk.quarantined, fresh.disk.invalidated,
            len(list(d.glob("*/*.corrupt"))), fresh.stats.as_dict(),
            again.stats.disk_hits)


@pytest.mark.parametrize("how", ["flip", "truncate", "version"])
def test_damaged_disk_entries_follow_the_reference(tmp_path, how):
    r, t = both(_damage, tmp_path, how)
    assert t == r
    n, quarantined, invalidated, corrupt, _, warm_hits = t
    assert n == 3 and warm_hits == 1
    if how == "version":
        assert (quarantined, invalidated, corrupt) == (0, 3, 0)
    else:
        assert quarantined == corrupt == 3 and invalidated == 0


def test_disk_writes_are_best_effort_and_survive_memory_eviction(tmp_path):
    def scenario(pkg):
        d = tmp_path / pkg.root
        dc = pkg.cache.DiskCache(d / "raw")
        dc.put("key", lambda: None)              # unpicklable payload
        assert dc.write_errors == 1 and dc.get("key") is None
        cache = pkg.JITCache(capacity=1, persist_dir=d / "jit")
        opts = pkg.CompileOptions(max_replicas=2)
        b, spec = pkg.BENCHMARKS, pkg.spec()
        a = pkg.jit.jit_compile(b["poly1"][0], spec, opts=opts, cache=cache)
        pkg.jit.jit_compile(b["chebyshev"][0], spec, opts=opts, cache=cache)
        c = pkg.jit.jit_compile(b["poly1"][0], spec, opts=opts, cache=cache)
        assert c.bitstream.data == a.bitstream.data
        return cache.stats.as_dict()
    r, t = both(scenario)
    assert t == r
    assert t["evictions"] >= 1 and t["disk_hits"] >= 1


# ----------------------------------------- hazard: the other package's blobs

def _child(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=180,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_blobs_are_quarantined_never_unpickled(tmp_path):
    """``repro`` fills a directory; the port, in a fresh interpreter, finds
    the same file names (equal keys), refuses every blob as corrupt, builds
    cold, and never imports ``repro`` or JAX."""
    ref = R.jit.jit_compile(R.BENCHMARKS["poly1"][0], R.spec(),
                            opts=R.CompileOptions(max_replicas=4),
                            cache=R.JITCache(persist_dir=tmp_path))
    names = {p.name for p in _entry_files(tmp_path)}
    assert len(names) == 3
    child = (
        "import json, sys\n"
        "from repro_torch.configs.paper_suite import BENCHMARKS\n"
        "from repro_torch.core.cache import JITCache\n"
        "from repro_torch.core.jit import jit_compile\n"
        "from repro_torch.core.options import CompileOptions\n"
        "from repro_torch.core.overlay import OverlaySpec\n"
        f"cache = JITCache(persist_dir={str(tmp_path)!r})\n"
        "ck = jit_compile(BENCHMARKS['poly1'][0], OverlaySpec(8, 8, 2),\n"
        "                 opts=CompileOptions(max_replicas=4), cache=cache)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('repro', 'jax', 'jaxlib'))\n"
        "print(json.dumps(dict(quarantined=cache.disk.quarantined,\n"
        "                      disk_hits=cache.stats.disk_hits,\n"
        "                      misses=cache.stats.misses, bad=bad,\n"
        "                      bs=ck.bitstream.sha256())))\n")
    got = _child(child)
    assert got == dict(quarantined=3, disk_hits=0, misses=1, bad=[],
                       bs=ref.bitstream.sha256())
    # the port's own blobs took the names; repro's are set aside
    assert {p.name for p in _entry_files(tmp_path)} == names
    assert len(list(tmp_path.glob("*/*.corrupt"))) == 3


def test_each_package_refuses_the_others_wire_format():
    assert T.cache.WIRE_MAGIC != R.cache.WIRE_MAGIC
    blob_r = R.cache.encode_blob("k", {"a": 1})
    blob_t = T.cache.encode_blob("k", {"a": 1})
    assert T.cache.decode_blob("k", blob_t) == {"a": 1}
    with pytest.raises(T.cache.WireCorruptError, match="magic"):
        T.cache.decode_blob("k", blob_r)
    with pytest.raises(R.cache.WireCorruptError, match="magic"):
        R.cache.decode_blob("k", blob_t)


# ----------------------------------------------------------- remote tier

def _fleet(pkg, n_endpoints=1, **ep_kw):
    rm = pkg.remote
    store = rm.RemoteBlobStore()
    eps = [rm.RemoteEndpoint(store, f"r{i}", **ep_kw)
           for i in range(n_endpoints)]
    sticky = pkg.recovery.RetryPolicy(breaker_cooldown_s=60.0)
    return store, rm.RemoteCache(eps, retry=sticky)


def _build(pkg, cache, name="poly1", **kw):
    return pkg.jit.jit_compile(pkg.BENCHMARKS[name][0], pkg.spec(),
                               opts=pkg.CompileOptions(max_replicas=4),
                               cache=cache, **kw)


def _remote_wire(pkg, tmp_path):
    c = pkg.cache
    blob = c.encode_blob("k1", {"a": 1})
    assert c.decode_blob("k1", blob) == {"a": 1}
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    for bad in (blob[:-3], bytes(flipped), b"JUNK" + blob[4:]):
        with pytest.raises(c.WireCorruptError):
            c.decode_blob("k1", bad)
    for key, b in (("k1", c.encode_blob("k1", 1, version=99)),
                   ("other", blob)):
        with pytest.raises(c.WireStaleError):
            c.decode_blob(key, b)
    cache = pkg.JITCache(persist_dir=tmp_path / pkg.root)
    cold = _build(pkg, cache)
    store, rc = _fleet(pkg)
    key = next(iter(cache.keys()))
    store.write(pkg.remote.RemoteBlobStore.addr(key),
                cache.disk._path(key).read_bytes())
    got = rc.get(key)
    return _artifact(got) == _artifact(cold), rc.stats_dict()


def _remote_warm_start(pkg, tmp_path):
    store, rc = _fleet(pkg)
    host_a = pkg.JITCache(remote=rc)
    cold = _build(pkg, host_a)
    host_b = pkg.JITCache(remote=rc)
    warm = _build(pkg, host_b)
    jitter = pkg.JITCache(remote=rc)
    cross = pkg.jit.jit_compile(pkg.BENCHMARKS["poly1"][0], pkg.spec(),
                                opts=pkg.CompileOptions(max_replicas=2),
                                cache=jitter)
    host_c = pkg.JITCache(remote=rc)
    busy = pkg.jit.jit_compile(pkg.BENCHMARKS["poly1"][0], pkg.spec(),
                               opts=pkg.CompileOptions(max_replicas=2),
                               cache=host_c, fu_headroom=3, io_headroom=1)
    disk = pkg.JITCache(persist_dir=tmp_path / pkg.root, remote=rc)
    _build(pkg, disk)
    for ep in rc.endpoints:
        ep.fail()
    restarted = pkg.JITCache(persist_dir=tmp_path / pkg.root, remote=rc)
    _build(pkg, restarted)
    assert restarted.stats.misses == 0
    return (_artifact(cold), _artifact(warm), _artifact(cross),
            _artifact(busy), len(store), host_b.stats.as_dict(),
            host_c.stats.as_dict(), disk.stats.as_dict(),
            restarted.stats.as_dict())


def _remote_quarantine(pkg, tmp_path):
    store, rc = _fleet(pkg)
    cold = _build(pkg, pkg.JITCache(remote=rc))
    for addr in list(store._blobs):
        assert store.corrupt(addr)
    host = pkg.JITCache(persist_dir=tmp_path / pkg.root, remote=rc)
    ck = _build(pkg, host)
    again = pkg.JITCache(persist_dir=tmp_path / pkg.root)
    _build(pkg, again)
    fresh = pkg.JITCache(remote=rc)
    _build(pkg, fresh)
    stale_store, stale_rc = _fleet(pkg)
    stale_store.write(pkg.remote.RemoteBlobStore.addr("some-key"),
                      pkg.cache.encode_blob("some-key", {"v": 1},
                                            version=99))
    assert stale_rc.get("some-key") is None
    return (_artifact(ck) == _artifact(cold), host.stats.as_dict(),
            rc.stats_dict(), again.stats.as_dict(), again.disk.quarantined,
            fresh.stats.as_dict(), stale_rc.stats_dict(), len(stale_store))


def _remote_outage(pkg, tmp_path):
    store, rc = _fleet(pkg, n_endpoints=2)
    _build(pkg, pkg.JITCache(remote=rc), "chebyshev")
    for ep in rc.endpoints:
        ep.fail()
    host = pkg.JITCache(remote=rc)
    ck = _build(pkg, host, "chebyshev")
    outage = (rc.total_outage(), sorted(b.state for b in
                                        rc.breakers.values()))
    for ep in rc.endpoints:
        ep.recover()
    for b in rc.breakers.values():
        b.record_success()
        b.state = "closed"
    fresh = pkg.JITCache(remote=rc)
    _build(pkg, fresh, "chebyshev")
    assert fresh.stats.remote_hits == 1
    return (ck.plan.replicas, host.stats.as_dict(), outage, rc.stats_dict(),
            fresh.stats.as_dict())


def _remote_lossy_and_hedged(pkg, tmp_path):
    rm = pkg.remote
    sticky = pkg.recovery.RetryPolicy(breaker_cooldown_s=60.0)
    store = rm.RemoteBlobStore()
    flaky = rm.RemoteEndpoint(store, "flaky", loss_rate=0.999, seed=3)
    solid = rm.RemoteEndpoint(store, "solid")
    rc = rm.RemoteCache([flaky, solid], retry=sticky)
    store.write(rm.RemoteBlobStore.addr("k"), pkg.cache.encode_blob("k", [1]))
    assert rc.get("k") == [1]
    out = [rc.stats_dict()]
    assert issubclass(rm.RemoteUnavailable, OSError)
    assert isinstance(rm.RemoteUnavailable("x"), pkg.recovery.TRANSIENT)
    for latency, rebuild, want in ((1_000_000.0, 5_000.0, None),
                                   (30_000.0, 500_000.0, "artifact")):
        store = rm.RemoteBlobStore()
        slow = rm.RemoteEndpoint(store, "slow", latency_us=latency,
                                 jitter=0.0)
        rc = rm.RemoteCache([slow], hedge_deadline_us=10_000.0,
                            rebuild_est_us=rebuild, retry=sticky)
        store.write(rm.RemoteBlobStore.addr("k"),
                    pkg.cache.encode_blob("k", "artifact"))
        assert rc.get("k") == want
        assert rc.get("k", rebuild_est_us=1_000.0) is None
        out.append(rc.stats_dict())
    return out


def _remote_injected_faults(pkg, tmp_path):
    fm = pkg.faults
    out = []
    store, rc = _fleet(pkg)
    _build(pkg, pkg.JITCache(remote=rc))
    plan = fm.FaultPlan(seed=5).add("remote_read", rate=1.0)
    host = pkg.JITCache(remote=rc)
    with fm.activate(plan):
        ck = _build(pkg, host)
    out.append((ck.plan.replicas, host.stats.as_dict(), plan.as_dict(),
                rc.stats_dict()))
    store, rc = _fleet(pkg)
    store.write(pkg.remote.RemoteBlobStore.addr("k"),
                pkg.cache.encode_blob("k", 42))
    plan = fm.FaultPlan(seed=1).add("remote_read", kind="corrupt", times=1)
    with fm.activate(plan):
        assert rc.get("k") is None
    out.append((rc.stats_dict(), len(store), rc.breakers["r0"].closed))
    store, rc = _fleet(pkg)
    plan = fm.FaultPlan(seed=2).add("remote_write", rate=1.0)
    with fm.activate(plan):
        _build(pkg, pkg.JITCache(remote=rc))
    out.append((rc.stats_dict(), len(store)))
    for stage in ("remote_read", "remote_write", "farm_rpc"):
        fm.FaultPlan().add(stage)
    return out


def _remote_farm(pkg, tmp_path):
    fm, rm = pkg.faults, pkg.remote
    hot = pkg.CompileOptions(max_replicas=4)
    poly1, cheb = pkg.BENCHMARKS["poly1"][0], pkg.BENCHMARKS["chebyshev"][0]
    store, rc = _fleet(pkg)
    farm = rm.CompileFarm(pkg.spec(), rc)
    for _ in range(3):
        farm.observe(poly1, hot)
    farm.observe(cheb, hot)
    assert farm.hot(top_n=2)[0] == (poly1, hot)
    assert farm.prefetch_hot(top_n=2) == 2
    fresh = pkg.JITCache(remote=rc)
    _build(pkg, fresh)
    _build(pkg, fresh, "chebyshev")
    out = [farm.stats_dict(), fresh.stats.as_dict()]
    store, rc = _fleet(pkg)
    farm = rm.CompileFarm(pkg.spec(), rc,
                          retry=pkg.recovery.RetryPolicy(max_retries=1))
    with fm.activate(fm.FaultPlan(seed=9).add("farm_rpc", rate=1.0)):
        assert farm.prefetch([(poly1, hot)]) == 0
    out.append(farm.stats_dict())
    store, rc = _fleet(pkg)
    farm = rm.CompileFarm(pkg.spec(), rc)
    plan = fm.FaultPlan(seed=9).add("farm_rpc", times=1)
    with fm.activate(plan):
        assert farm.prefetch([(poly1, hot)]) == 1
    out.append((farm.stats_dict(), plan.as_dict()))
    return out


def _remote_session(pkg, tmp_path):
    opts = pkg.CompileOptions(max_replicas=4)
    store, rc = _fleet(pkg)
    _build(pkg, pkg.JITCache(remote=rc))
    with pkg.new_session([pkg.Device("d0", pkg.spec())], remote=rc) as sess:
        sess.compile(pkg.BENCHMARKS["poly1"][0], opts).result(120)
        with_remote = sess.stats()
    with pkg.new_session([pkg.Device("d0", pkg.spec())]) as sess:
        sess.compile(pkg.BENCHMARKS["poly1"][0], opts).result(120)
        without = sess.stats()
    assert "remote" not in without
    return with_remote["remote"], with_remote["cache"], without["cache"]


REMOTE_CASES = [_remote_wire, _remote_warm_start, _remote_quarantine,
                _remote_outage, _remote_lossy_and_hedged,
                _remote_injected_faults, _remote_farm, _remote_session]


@pytest.mark.parametrize("case", REMOTE_CASES,
                         ids=[c.__name__[1:] for c in REMOTE_CASES])
def test_remote_tier_follows_the_reference(case, tmp_path):
    """Each case of the remote tier's fault ladder (wire classes, warm
    start, quarantine, outage, loss, hedging, injected faults, the compile
    farm, the Session's stats section) gives the port the reference's
    counters: the endpoints' latency and loss model is a hash of the key,
    and the keys are equal."""
    r, t = both(case, tmp_path)
    assert t == r
