#!/usr/bin/env python3
"""Tracing costs nothing when it is off; re-cutting is never worse.

    PYTHONPATH=src python3 benchmarks/torch_trace_overhead_perf.py \
        [--device cuda] [--json out.json]

The port of ``benchmarks/trace_overhead_perf.py``, on one CUDA card
(``--device cpu`` rehearses on the CPU).  Every gate exits 1.

**Tracing off is free on the warm hit path.**

  * a disabled ``span()`` returns the one shared no-op object (tens of
    ns, no allocation), and a Session with no metrics registry grows no
    ``obs`` section;
  * the modelled queue timeline is identical with and without a tracer;
  * a warm compile books no place/route/stamp span;
  * ``Session.enqueue`` of a built program (2048 work-items, the
    executor launched on the card) timed on the host clock with the
    tracer off and on, in turns (off, on, on, off), each turn the median
    of ``--reps`` calls after as many untimed ones.  The trace probes one
    enqueue passes are counted (calls of ``span``, ``activate`` and
    ``active_tracer``), and their cost when off — that count times a
    disabled probe's ns — must stay below what the off readings can
    resolve: their spread, or 1 % of the enqueue where the spread is
    smaller.

**Profile-guided re-cutting is never worse, and wins where it should**
(the reference's two legs, every replay through the executor on the
card): the six-stage ``graph_replay_perf`` pipeline at 200,000 items
keeps its cut with no compile, and a stale per-stage cut of two
18-rung stages at 4,000,000 items is re-fused, faster on the modelled
engine timeline, bit-identical, and warm when re-instantiated.

The first line is ``nvidia-smi``'s name and power limit of the card; the
last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache  # noqa: E402
from repro_torch.core.graph import partition_graph_grouped  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.runtime import Buffer, Context, Device  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.obs import (ProfileStore, ReCutter, Tracer,  # noqa: E402
                             activate)
from repro_torch.obs.trace import _NULL_SPAN, span  # noqa: E402

SPEC_KW = dict(width=8, height=8, dsp_per_fu=2)
SPEC = OverlaySpec(**SPEC_KW)
OPTS = CompileOptions(max_replicas=4)
# benchmarks/graph_replay_perf.py's serving pipeline and batch size
N_ITEMS = 200_000
N_REQUESTS = 4
STAGES = [
    ("poly1", BENCHMARKS["poly1"][0]),
    ("cheb", BENCHMARKS["chebyshev"][0]),
    ("scale", lambda x: x * 0.125 + 0.5),
    ("sq", lambda x: x * x - 1.0),
    ("mix", lambda x: x * 0.75 + x * x * 0.25),
    ("out", lambda x: x * 2.0 - 3.0),
]
N_ENQUEUE = 2048
# the kinds of trace probe the runtime passes
PROBES = ("span", "activate", "active_tracer")


def fail(msg: str) -> None:
    raise SystemExit(f"GATE FAILED: {msg}")


def card_line(device: str) -> str:
    if device == "cpu":
        return "cpu (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def bench_disabled_probe(device: str) -> Dict:
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        span("queue_submit", "queue")
    ns_off = (time.perf_counter() - t0) / n * 1e9
    tr = Tracer()
    with activate(tr):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("queue_submit", "queue"):
                pass
        ns_on = (time.perf_counter() - t0) / n * 1e9
    print(f"span probe: {ns_off:.0f} ns/site disabled, {ns_on:.0f} ns/span "
          f"enabled ({tr.n_spans} spans recorded)")
    if span("x", "queue") is not _NULL_SPAN:
        fail("disabled span() allocated instead of returning the shared "
             "no-op")
    with Session([Device("d", SPEC)], device=device) as sess:
        sess.compile(BENCHMARKS["poly1"][0], OPTS).result(120)
        if "obs" in sess.stats():
            fail("Session.stats() grew an obs section with no metrics "
                 "registry attached")
    return dict(span_off_ns=ns_off, span_on_ns=ns_on)


def bench_timeline_unperturbed(device: str, n_kernels: int = 64) -> Dict:
    def timeline(tracer):
        ctx = Context(Device("d", SPEC), cache=JITCache())
        pa = ctx.build_program(BENCHMARKS["poly1"][0], opts=OPTS)
        pb = ctx.build_program(BENCHMARKS["chebyshev"][0], opts=OPTS)
        x = Buffer(np.linspace(-2, 2, 4096).astype(np.float32),
                   device=device)
        q = ctx.create_queue()
        with activate(tracer):
            for i in range(n_kernels):
                p = pa if i % 2 == 0 else pb
                q.enqueue_kernel(p.create_kernel().set_args(x))
        return [(e.t_queued_us, e.t_submit_us, e.config_us, e.t_end_us)
                for e in q.events]

    bare = timeline(None)
    tr = Tracer()
    if timeline(tr) != bare:
        fail("a tracer attached changed the modelled timeline")
    dev_spans = [s for s in tr.spans() if s.track.startswith("dev:")]
    if len(dev_spans) < n_kernels:
        fail(f"the traced queue booked {len(dev_spans)} device spans for "
             f"{n_kernels} kernels")
    print(f"timeline determinism: {n_kernels} kernels, {len(dev_spans)} "
          f"device spans, timestamps identical")
    return dict(kernels=n_kernels, device_spans=len(dev_spans),
                identical=True)


def bench_warm_hit_books_no_stages() -> Dict:
    cache = JITCache()
    jit_compile(BENCHMARKS["poly1"][0], SPEC, cache=cache)
    tr = Tracer()
    with activate(tr):
        jit_compile(BENCHMARKS["poly1"][0], SPEC, cache=cache)
    names = {s.name for s in tr.spans()}
    leaked = sorted(names & {"jit:place", "jit:route", "jit:latency",
                             "jit:bitstream", "jit:stamp",
                             "jit:template_build", "jit:infill"})
    if leaked:
        fail(f"a warm hit booked compiler-stage spans: {leaked}")
    if "jit:cache" not in names:
        fail("a warm hit booked no cache-probe span")
    print(f"warm hit books: {sorted(names)} (no P&R stages)")
    return dict(warm_spans=sorted(names))


def _host_us(call, drain, reps: int) -> float:
    """Median host µs of ``call`` over ``reps`` calls, after as many
    untimed ones (the allocator then holds the outputs' memory)."""
    for timed in (False, True):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e6)
        drain()
    return statistics.median(times)


def count_probes(call) -> Dict[str, int]:
    """The trace probes one ``call()`` passes with the tracer off, by kind:
    calls of ``span``, ``activate`` and ``active_tracer`` (the module's,
    and the queue's own binding of the last)."""
    from repro_torch.core import queue as queue_mod
    from repro_torch.obs import trace as trace_mod
    counts = dict.fromkeys(PROBES, 0)

    def counting(name, fn):
        def probe(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return probe

    sites = [(trace_mod, "span"), (trace_mod, "activate"),
             (trace_mod, "active_tracer"), (queue_mod, "active_tracer")]
    saved = [getattr(mod, name) for mod, name in sites]
    for (mod, name), fn in zip(sites, saved):
        setattr(mod, name, counting(name, fn))
    try:
        call()
    finally:
        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, fn)
    return counts


def disabled_probe_ns(n: int = 200_000) -> Dict[str, float]:
    """ns of one probe of each kind with no tracer active."""
    from repro_torch.obs import trace as trace_mod

    def enter_activate():
        with trace_mod.activate(None):
            pass

    calls = {"span": lambda: trace_mod.span("queue_submit", "queue"),
             "activate": enter_activate,
             "active_tracer": trace_mod.active_tracer}
    out = {}
    for name in PROBES:
        fn = calls[name]
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e9
    return out


def bench_enqueue_tracer_off(device: str, reps: int) -> Dict:
    """The warm hit path of Session.enqueue, tracer off and on in turns."""
    rng = np.random.default_rng(0)
    with Session([Device("d", SPEC)], device=device) as sess:
        prog = sess.build(BENCHMARKS["poly1"][0], OPTS, tenant="t")
        buf = Buffer(rng.uniform(-1, 1, N_ENQUEUE).astype(np.float32),
                     device=device)
        queue = sess.queue_for("t", "d")

        def drain():
            _sync(device)
            queue.drain()

        def call():
            sess.enqueue(prog, buf, tenant="t")

        call()
        probes = count_probes(call)
        turns = []
        for on in (False, True, True, False):
            sess.tracer = Tracer() if on else None
            turns.append(dict(tracer=on, host_us=_host_us(call, drain, reps)))
        sess.tracer = None
    offs = [t["host_us"] for t in turns if not t["tracer"]]
    ons = [t["host_us"] for t in turns if t["tracer"]]
    off, on = statistics.median(offs), statistics.median(ons)
    spread = max(offs) - min(offs)
    probe_ns = disabled_probe_ns()
    disabled_us = sum(n * probe_ns[k] for k, n in probes.items()) * 1e-3
    resolvable = max(spread, 0.01 * off)
    print(f"Session.enqueue at N={N_ENQUEUE}, warm hit: tracer off "
          f"{off:.2f} us host (turns {offs[0]:.2f}, {offs[1]:.2f}), on "
          f"{on:.2f} us ({ons[0]:.2f}, {ons[1]:.2f}); probes an enqueue "
          f"{probes} at ns {probe_ns}: {disabled_us:.3f} us when off, "
          f"against "
          f"{resolvable:.3f} us the off readings resolve")
    if disabled_us > resolvable:
        fail(f"the disabled probes cost {disabled_us:.3f} us an enqueue, "
             f"more than the {resolvable:.3f} us the readings resolve")
    return dict(n=N_ENQUEUE, reps=reps, turns=turns, off_us=off, on_us=on,
                probes=probes, probe_ns=probe_ns,
                disabled_probe_us=disabled_us,
                resolvable_us=resolvable)


def _wide_stage(rungs: int):
    def fn(x):
        for _ in range(rungs):
            x = x * 1.01 + 0.001
        return x
    return fn


def _recut_case(device: str, name: str, stages, items: int, replays: int,
                expect_swap: bool, stale_groups=None) -> Dict:
    rng = np.random.default_rng(0)
    with Session([Device("ovl0", SPEC)], device=device) as sess:
        sess.profiles = ProfileStore(cache=sess.cache)
        with sess.capture("t", name=f"recut_{name}") as g:
            buf = g.input("x")
            for sname, src in stages:
                buf = g.call(src, OPTS.replace(n_inputs=1, name=sname), buf)
        if stale_groups is not None:
            spec = sess.scheduler.partition_spec()
            sess.adopt_graph_plan(g, partition_graph_grouped(
                g, spec, stale_groups))
        gx = sess.instantiate(g).result()
        old_parts = gx.n_partitions
        x = Buffer(rng.uniform(0, 1, items).astype(np.float32),
                   device=device)
        for _ in range(replays):
            sess.launch(gx, x).wait()
        out_old = sess.launch(gx, x).outputs[0].read()
        before = max(c.engine_end_us for c in sess.contexts.values())
        sess.launch(gx, x).wait()
        old_replay_us = max(c.engine_end_us
                            for c in sess.contexts.values()) - before
        gx.release()
        misses = sess.cache.stats.misses
        res = ReCutter(sess, sess.profiles).consider(g)
        row = dict(case=name, items=items, stages=len(stages),
                   old_partitions=old_parts, reason=res.reason,
                   old_est_us=res.old_est_us, new_est_us=res.new_est_us,
                   est_ratio=res.old_est_us / max(res.new_est_us, 1e-9))
        if res.swapped != expect_swap:
            fail(f"{name}: expected swap={expect_swap}, got {res.reason}")
        if not res.swapped:
            if sess.cache.stats.misses != misses:
                fail(f"{name}: kept the cut but compiled anyway")
            row.update(measured_ratio=1.0, identical=True,
                       reinstantiate_misses=0)
            return row
        if res.new_est_us > res.old_est_us:
            fail(f"{name}: the swap adopted a worse estimate")
        sess.launch(res.gexec, x).wait()
        out_new = sess.launch(res.gexec, x).outputs[0].read()
        before = max(c.engine_end_us for c in sess.contexts.values())
        sess.launch(res.gexec, x).wait()
        new_replay_us = max(c.engine_end_us
                            for c in sess.contexts.values()) - before
        if not np.array_equal(out_old.view(np.int32), out_new.view(np.int32)):
            fail(f"{name}: re-cut outputs differ bit-wise")
        if new_replay_us >= old_replay_us:
            fail(f"{name}: the re-cut replay is not faster")
        res.gexec.release()
        misses = sess.cache.stats.misses
        gx2 = sess.instantiate(g).result()
        if sess.cache.stats.misses != misses:
            fail(f"{name}: re-instantiation after the swap compiled")
        row.update(new_partitions=gx2.n_partitions,
                   old_replay_us=old_replay_us, new_replay_us=new_replay_us,
                   measured_ratio=old_replay_us / new_replay_us,
                   identical=True, reinstantiate_misses=0)
        return row


def bench_recut(device: str) -> Dict:
    keep = _recut_case(device, "graph_replay_6stage", STAGES, N_ITEMS,
                       max(2, N_REQUESTS), expect_swap=False)
    win = _recut_case(device, "wide_2stage_stale_split",
                      [("w0", _wide_stage(18)), ("w1", _wide_stage(18))],
                      4_000_000, 2, expect_swap=True,
                      stale_groups=[[0], [1]])
    for row in (keep, win):
        print(f"recut/{row['case']}: {row['reason']} est "
              f"{row['est_ratio']:.3f}x measured {row['measured_ratio']:.3f}x"
              f" (modelled) identical={row['identical']}")
    return dict(keep=keep, win=win)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the Sessions run (default: the CUDA card)")
    ap.add_argument("--reps", type=int, default=200,
                    help="enqueues timed in each turn")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_trace_overhead_perf: no CUDA device (pass --device cpu "
              "to rehearse on the CPU)", file=sys.stderr)
        return 2
    card = card_line(args.device)
    print(card, flush=True)
    probe = bench_disabled_probe(args.device)
    result = dict(
        card=card, device=args.device, spec=SPEC_KW, probe=probe,
        timeline=bench_timeline_unperturbed(args.device),
        warm_hit=bench_warm_hit_books_no_stages(),
        enqueue=bench_enqueue_tracer_off(args.device, args.reps),
        recut=bench_recut(args.device))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
