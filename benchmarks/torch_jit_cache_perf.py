#!/usr/bin/env python3
"""The JIT cache and the command queue on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_jit_cache_perf.py \
        [--device cuda] [--json out.json]

The port of ``benchmarks/jit_cache_perf.py``, for the paper's six kernels
on ``OverlaySpec(8, 8, 2)``.  Its five sections and their gates (the
process exits 1 on any):

  1. cold against warm builds through one ``JITCache``: the warm build is
     a content-addressed lookup, at least ``WARM_GATE`` (10) times faster
     for every kernel;
  2. command-queue throughput over ``N_KERNELS`` enqueues of 4096
     work-items, each of which launches the executor on a buffer on the
     card: the host's enqueue rate (the clock ends in a synchronise), the
     modelled overlay rate and makespan, and alternating programs with a
     reconfiguration charged per switch; every output is held bit for bit
     against ``run_reference``;
  3. the static verifier at ``verify_level`` off, "fused" and "full": off
     books no verify stage, the others do, and a "full" warm hit
     re-verifies without quarantining a clean artifact;
  4. with no fault plan a warm serving loop on a ``Session`` books no
     recovery work: every build takes one attempt and no breaker moves
     (the Session builds on one worker, where the reference's had four: a
     replica shed racing a parallel build can fail to re-debit the
     program it restores, in both packages);
  5. with no remote tier the cache's hot path books no remote counter and
     ``Session.stats()`` has no remote section.

Each artifact that sections 1 and 3 build is launched once on the card
over 2^20 work-items and held bit for bit against ``run_reference``,
outside every timed window.  ``BENCH_compile.json`` stays the
reference's record: this script never writes it.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache, make_cache_key  # noqa: E402
from repro_torch.core.faults import fault_point  # noqa: E402
from repro_torch.core.jit import jit_compile, lower_to_dfg  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.runtime import Buffer, Context, Device  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
WARM_GATE = 10.0
N_KERNELS = 200
N_QUEUE = 4096
N_LAUNCH = 1 << 20
VERIFY_LEVELS = ("off", "fused", "full")


def bench_cold_vs_warm(device: str, failures: List[str]) -> Dict:
    """Section 1: each kernel cold, then warm, through one cache."""
    cache = JITCache()
    rows, built = [], []
    for name in sorted(BENCHMARKS):
        src = BENCHMARKS[name][0]
        t0 = time.perf_counter()
        ck = jit_compile(src, SPEC, cache=cache)
        cold = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        warm_ck = jit_compile(src, SPEC, cache=cache)
        warm = (time.perf_counter() - t0) * 1e3
        if warm_ck is not ck:
            failures.append(f"{name}: the warm build is not the cached "
                            f"artifact")
        rows.append(dict(kernel=name, replicas=ck.plan.replicas,
                         cold_ms=cold, warm_ms=warm,
                         speedup=cold / max(warm, 1e-9)))
        built.append(ck)
    worst = min(r["speedup"] for r in rows)
    if worst < WARM_GATE:
        failures.append(f"worst warm speedup {worst:.1f}x < {WARM_GATE}x")
    for ck in built:
        if not port_bench.launch_checked(ck, N_LAUNCH, device):
            failures.append(f"{ck.name}: the launch differs from "
                            f"run_reference")
    return dict(rows=rows, worst_speedup=worst,
                cache_stats=cache.stats.as_dict())


def _outputs_exact(events, want: np.ndarray) -> bool:
    return all(port_bench.same_bits(ev.outputs[0].read(), want)
               for ev in events)


def bench_queue_throughput(device: str, failures: List[str],
                           n_kernels: int = N_KERNELS) -> Dict:
    """Section 2: enqueue rates, every enqueue an executor launch."""
    x_np = np.linspace(-2, 2, N_QUEUE).astype(np.float32)
    ctx = Context(Device("d", SPEC), cache=JITCache())
    prog = ctx.build_program(BENCHMARKS["poly1"][0], opts=CompileOptions())
    x = Buffer(x_np, device=device)
    q = ctx.create_queue()
    port_bench.sync(device)
    t0 = time.perf_counter()
    for _ in range(n_kernels):
        q.enqueue_kernel(prog.create_kernel().set_args(x))
    port_bench.sync(device)
    wall_s = time.perf_counter() - t0
    same = dict(host_kernels_per_s=n_kernels / wall_s,
                modelled_kernels_per_s=q.throughput_kernels_per_sec(),
                makespan_us=q.makespan_us,
                bit_exact=_outputs_exact(
                    q.events, prog.compiled.run_reference(x_np)))
    # alternating programs on a fresh context: every enqueue pays the
    # reconfiguration
    ctx2 = Context(Device("d2", SPEC), cache=JITCache())
    pa = ctx2.build_program(BENCHMARKS["poly1"][0],
                            opts=CompileOptions(max_replicas=8))
    pb = ctx2.build_program(BENCHMARKS["chebyshev"][0],
                            opts=CompileOptions(max_replicas=8))
    q2 = ctx2.create_queue()
    for i in range(n_kernels):
        p = pa if i % 2 == 0 else pb
        q2.enqueue_kernel(p.create_kernel().set_args(x))
    alt = dict(modelled_kernels_per_s=q2.throughput_kernels_per_sec(),
               makespan_us=q2.makespan_us,
               reconfigs=sum(1 for e in q2.events if e.config_us > 0),
               bit_exact=(_outputs_exact(
                   q2.events[0::2], pa.compiled.run_reference(x_np))
                   and _outputs_exact(
                   q2.events[1::2], pb.compiled.run_reference(x_np))))
    for key, r in (("same program", same), ("alternating", alt)):
        if not r["bit_exact"]:
            failures.append(f"queue ({key}): an output differs from "
                            f"run_reference")
    return dict(kernels=n_kernels, items=N_QUEUE, same=same,
                alternating=alt)


def bench_verify_overhead(device: str, failures: List[str]) -> Dict:
    """Section 3: cold build and warm hit per kernel at every level."""
    rows = []
    for name in sorted(BENCHMARKS):
        src, reps, _ = BENCHMARKS[name]
        row: Dict = {"name": name}
        hashes = set()
        for level in VERIFY_LEVELS:
            cache = JITCache()
            opts = CompileOptions(max_replicas=reps, verify_level=level)
            t0 = time.perf_counter()
            ck = jit_compile(src, SPEC, opts=opts, cache=cache)
            row[f"cold_ms_{level}"] = (time.perf_counter() - t0) * 1e3
            booked = ck.stage_times_ms.get("verify")
            row[f"verify_booked_{level}"] = booked is not None
            if level == "off" and booked is not None:
                failures.append(f"{name}: verify stage booked on the "
                                f"default (off) path")
            if level != "off" and booked is None:
                failures.append(f"{name}: verify_level={level} booked no "
                                f"verify stage")
            row[f"verify_ms_{level}"] = booked or 0.0
            hashes.add((ck.bitstream.sha256(), ck.program.content_hash()))
            if level == "full":
                t0 = time.perf_counter()
                if jit_compile(src, SPEC, opts=opts, cache=cache) is not ck:
                    failures.append(f"{name}: the full warm hit is not the "
                                    f"cached artifact")
                row["hit_reverify_ms"] = (time.perf_counter() - t0) * 1e3
                row["verify_quarantined"] = cache.stats.verify_quarantined
                if cache.stats.verify_quarantined:
                    failures.append(f"{name}: clean artifact quarantined")
                if not port_bench.launch_checked(ck, N_LAUNCH, device):
                    failures.append(f"{name}: the verified artifact's "
                                    f"launch differs from run_reference")
        row["replicas"] = ck.plan.replicas
        row["same_artifact_every_level"] = len(hashes) == 1
        rows.append(row)
    mean_off = statistics.fmean(r["cold_ms_off"] for r in rows)
    mean_full = statistics.fmean(r["cold_ms_full"] for r in rows)
    frac = sum(r["verify_ms_full"] for r in rows) / max(
        sum(r["cold_ms_full"] for r in rows), 1e-9)
    return dict(spec=dict(width=SPEC.width, height=SPEC.height,
                          dsp_per_fu=SPEC.dsp_per_fu),
                rows=rows, mean_cold_ms_off=mean_off,
                mean_cold_ms_full=mean_full, verify_fraction_full=frac)


def bench_fault_free_overhead(device: str, failures: List[str]) -> Dict:
    """Section 4: no fault plan, no recovery work."""
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        fault_point("place", "bench")
    ns_per_point = (time.perf_counter() - t0) / n * 1e9
    x = np.linspace(-2, 2, N_QUEUE).astype(np.float32)
    # one build worker: with parallel builds a replica shed can fail to
    # re-debit the program it restores (ROADMAP §3, open in both packages)
    with Session([Device("d", SPEC)], max_workers=1,
                 device=device) as sess:
        opts = CompileOptions(max_replicas=4)
        futs = [sess.compile(BENCHMARKS[k][0], opts)
                for k in sorted(BENCHMARKS) for _ in range(4)]
        for fut in futs:
            fut.result(120)       # every build settled, shedding included
        exact = True
        for fut in futs:          # then served from the steady fleet
            n_in = len(fut.result().compiled.dfg.inputs)
            ev = sess.enqueue(fut, *([x] * n_in))
            want = port_bench.as_list(
                fut.result().compiled.run_reference(*([x] * n_in)))
            exact &= all(port_bench.same_bits(b.read(), w)
                         for b, w in zip(ev.wait(), want))
        stats = sess.stats()
        rec = stats["recovery"]
        breakers = rec.pop("breakers")
        attempts = sorted({f._record["attempts"] for f in futs})
        all_zero = sess.recovery.all_zero()
    if not all_zero:
        failures.append(f"fault-free serving loop booked recovery work: "
                        f"{rec}")
    if attempts != [1]:
        failures.append(f"fault-free builds took {attempts} attempts, "
                        f"expected exactly 1")
    if any(b["state"] != "closed" or b["trips"] for b in breakers.values()):
        failures.append(f"fault-free run moved a breaker: {breakers}")
    if not exact:
        failures.append("fault-free serving: an output differs from "
                        "run_reference")
    return dict(fault_point_ns=ns_per_point, recovery=rec,
                attempts=attempts, breakers=breakers, bit_exact=exact)


def bench_remote_disabled_overhead(device: str,
                                   failures: List[str]) -> Dict:
    """Section 5: no remote tier, no remote work."""
    cache = JITCache()
    src = BENCHMARKS["poly1"][0]
    jit_compile(src, SPEC, cache=cache)
    key = make_cache_key(lower_to_dfg(src, None, None, parse_source=True),
                         SPEC, free_fus=SPEC.n_fus, free_io=SPEC.n_io,
                         opts=CompileOptions())
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        cache.get(key)
    ns_per_hit = (time.perf_counter() - t0) / n * 1e9
    remote_counters = {k: v for k, v in cache.stats.as_dict().items()
                       if k.startswith("remote")}
    if any(remote_counters.values()):
        failures.append(f"remote-disabled serving booked remote work: "
                        f"{remote_counters}")
    with Session([Device("d", SPEC)], device=device) as sess:
        sess.compile(src, CompileOptions()).result(120)
        remote_section = "remote" in sess.stats()
    if remote_section:
        failures.append("Session.stats() grew a remote section with no "
                        "remote tier attached")
    return dict(warm_hit_ns=ns_per_hit, remote_counters=remote_counters,
                remote_section=remote_section)


def run(device: str = "cuda") -> Dict:
    """The five sections, the card's line and the gates' failures."""
    failures: List[str] = []
    result = dict(
        spec=dict(width=SPEC.width, height=SPEC.height,
                  dsp_per_fu=SPEC.dsp_per_fu), device=device,
        cold_warm=bench_cold_vs_warm(device, failures),
        queue=bench_queue_throughput(device, failures),
        verify=bench_verify_overhead(device, failures),
        fault_free=bench_fault_free_overhead(device, failures),
        remote=bench_remote_disabled_overhead(device, failures))
    result["card"] = port_bench.card_line(device)
    result["gate_failures"] = failures
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows (verify, faults, remote), then the cold
    against warm builds and the queue."""
    verify = result["verify"]
    out = [dict(name=f"verify/{r['name']}/{level}",
                us_per_call=r[f"cold_ms_{level}"] * 1e3,
                derived=f"verify {r[f'verify_ms_{level}']:.3f} ms")
           for r in verify["rows"] for level in VERIFY_LEVELS]
    out.append(dict(
        name="verify/mean_fraction_full",
        us_per_call=verify["mean_cold_ms_full"] * 1e3,
        derived=f"{100 * verify['verify_fraction_full']:.1f}% of full "
                f"cold build is verification"))
    ff = result["fault_free"]
    out.append(dict(
        name="faults/fault_point_off_ns",
        us_per_call=ff["fault_point_ns"] * 1e-3,
        derived=f"fault-free: {ff['fault_point_ns']:.0f} ns/site, "
                f"recovery all-zero, attempts={ff['attempts']}"))
    remote = result["remote"]
    out.append(dict(
        name="remote/disabled_warm_hit_ns",
        us_per_call=remote["warm_hit_ns"] * 1e-3,
        derived=f"no remote tier: {remote['warm_hit_ns']:.0f} ns/warm hit, "
                f"remote counters all-zero"))
    out += [dict(name=f"jit_cache/{r['kernel']}",
                 us_per_call=r["warm_ms"] * 1e3,
                 derived=(f"cold={r['cold_ms']:.2f}ms "
                          f"warm={r['warm_ms']:.4f}ms "
                          f"speedup={r['speedup']:.0f}x"))
            for r in result["cold_warm"]["rows"]]
    q = result["queue"]
    alt = q["alternating"]
    out.append(dict(
        name="queue/same_program",
        us_per_call=1e6 / q["same"]["host_kernels_per_s"],
        derived=(f"host {q['same']['host_kernels_per_s']:.0f} kernels/s "
                 f"(executor launched per enqueue), modelled "
                 f"{q['same']['modelled_kernels_per_s']:.0f} kernels/s, "
                 f"alternating {alt['modelled_kernels_per_s']:.0f} "
                 f"kernels/s ({alt['reconfigs']} reconfigs)")))
    return out


def report(result: Dict) -> None:
    card = result["card"]
    cw = result["cold_warm"]
    print("kernel     | cold ms  | warm ms  | speedup")
    for r in cw["rows"]:
        print(f"{r['kernel']:<11}| {r['cold_ms']:8.2f} | {r['warm_ms']:8.4f} "
              f"| {r['speedup']:7.0f}x")
    print(f"cache stats: {cw['cache_stats']}")
    print(f"worst-case warm speedup: {cw['worst_speedup']:.0f}x (gate "
          f">= {WARM_GATE}x)")
    q = result["queue"]
    print(f"queue throughput ({q['kernels']} kernels of {q['items']} "
          f"work-items, each an executor launch): host "
          f"{q['same']['host_kernels_per_s']:.0f} kernels/s, modelled "
          f"{q['same']['modelled_kernels_per_s']:.0f} kernels/s (makespan "
          f"{q['same']['makespan_us']:.0f} us); alternating programs "
          f"{q['alternating']['modelled_kernels_per_s']:.0f} kernels/s "
          f"modelled ({q['alternating']['reconfigs']} reconfigs); "
          f"bit-exact "
          f"{q['same']['bit_exact'] and q['alternating']['bit_exact']}; "
          f"{card}")
    v = result["verify"]
    for r in v["rows"]:
        print(f"verify {r['name']:<10} cold off {r['cold_ms_off']:.2f} / "
              f"fused {r['cold_ms_fused']:.2f} / full {r['cold_ms_full']:.2f}"
              f" ms, full hit re-verify {r['hit_reverify_ms']:.4f} ms "
              f"(verify {r['verify_ms_full']:.2f} ms)")
    print(f"{100 * v['verify_fraction_full']:.1f}% of the full build is "
          f"verification")
    ff, remote = result["fault_free"], result["remote"]
    print(f"fault-free: fault_point {ff['fault_point_ns']:.0f} ns/site, "
          f"recovery {ff['recovery']}, attempts {ff['attempts']}")
    print(f"remote-disabled: warm hit {remote['warm_hit_ns']:.0f} ns, remote "
          f"counters {remote['remote_counters']}")


def main(argv: Optional[List[str]] = None) -> int:
    return port_bench.bench_main("torch_jit_cache_perf",
                                 argparse.ArgumentParser(), argv, run,
                                 report)


if __name__ == "__main__":
    sys.exit(main())
