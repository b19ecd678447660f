#!/usr/bin/env python3
"""Template-stamped against joint-annealed builds, and uncapped replica
fill, with every artifact launched on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_template_build_perf.py \
        [--smoke] [--device cuda] [--json out.json]

The port of ``benchmarks/template_build_perf.py``.  For each kernel and
replica count R on ``OverlaySpec(32, 8, 2)``, three cold-to-warm rungs:

  * ``joint_ms`` — a cold build through the joint annealer (all R
    replicas annealed at once);
  * ``template_cold_ms`` — a cold build through the template path (place
    and route one replica, stamp R copies), best of two;
  * ``template_stamp_ms`` — a build at a new free-resource snapshot with
    the template cached: only the stamp runs, best of two.

Then uncapped fill on ``OverlaySpec(32, 8, 2, io_per_edge_tile=4)``:
``pr_mode="auto"`` (four-edge stamping and gap fill) against the joint
annealer, each given the whole overlay.

The reference's gates, unchanged (the process exits 1 on any): the cold
template build at least 5x faster than joint at R >= 8 (3x with
``--smoke``, which runs chebyshev and sgfilter at R 2 and 8); the auto
fill at least 0.95 of the joint annealer's with the joint path never run.
Beyond the reference: every artifact a rung built (joint, template cold,
stamped; auto and joint fill) is launched once on the card over 2^20
work-items and held bit for bit against ``run_reference``, outside every
timed window.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402

SPEC = OverlaySpec(width=32, height=8, dsp_per_fu=2)
# the serving config for fill: 4 pads per perimeter tile, so deep stamp
# bands are legal and the fill fight is at maximum occupancy
FILL_SPEC = OverlaySpec(width=32, height=8, dsp_per_fu=2, io_per_edge_tile=4)
KERNELS = ("chebyshev", "mibench", "qspline", "sgfilter")
REPLICAS = (1, 2, 4, 8, 16)
SMOKE_KERNELS = ("chebyshev", "sgfilter")
SMOKE_REPLICAS = (2, 8)
GATE, SMOKE_GATE, FILL_GATE = 5.0, 3.0, 0.95
N_LAUNCH = 1 << 20


def bench(kernels: Sequence[str] = KERNELS,
          replicas: Sequence[int] = REPLICAS, spec=SPEC):
    """The reference's rungs → (rows, the artifacts they built)."""
    rows, built = [], []
    for name in kernels:
        src = BENCHMARKS[name][0]
        cache = JITCache()
        # prime the template cache at a replica count NOT in the sweep, so
        # every sweep point's full key misses
        jit_compile(src, spec, cache=cache,
                    opts=CompileOptions(max_replicas=3, pr_mode="template"))
        for r in replicas:
            gc.collect()   # keep joint-build garbage out of the timed runs
            t0 = time.perf_counter()
            ck_j = jit_compile(src, spec, opts=CompileOptions(
                max_replicas=r, pr_mode="joint"))
            joint_ms = (time.perf_counter() - t0) * 1e3
            # short runs: one GC pause would dominate, so best of two
            gc.collect()
            cold_ms = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                ck_t = jit_compile(src, spec, opts=CompileOptions(
                    max_replicas=r, pr_mode="template"))
                cold_ms = min(cold_ms, (time.perf_counter() - t0) * 1e3)
            # a new free-resource snapshot each time: the full key misses,
            # the template hits, only the stamp runs
            stamp_ms = float("inf")
            for headroom in (0, 1):
                t0 = time.perf_counter()
                ck_s = jit_compile(src, spec, fu_headroom=headroom,
                                   cache=cache, opts=CompileOptions(
                                       max_replicas=r, pr_mode="template"))
                stamp_ms = min(stamp_ms, (time.perf_counter() - t0) * 1e3)
            if not ck_j.plan.replicas == ck_t.plan.replicas == \
                    ck_s.plan.replicas == r:
                raise RuntimeError(f"{name} R={r}: unfair comparison, "
                                   f"replica mismatch")
            if ck_s.stage_times_ms["place"] or ck_s.stage_times_ms["route"]:
                raise RuntimeError(f"{name} R={r}: a template cache hit "
                                   f"ran place/route")
            rows.append(dict(
                kernel=name, replicas=r,
                joint_ms=round(joint_ms, 3),
                template_cold_ms=round(cold_ms, 3),
                template_stamp_ms=round(stamp_ms, 3),
                speedup_cold=round(joint_ms / max(cold_ms, 1e-9), 1),
                speedup_stamp=round(joint_ms / max(stamp_ms, 1e-9), 1),
                stamp_stage_ms=round(ck_s.stage_times_ms["stamp"], 3),
                pipeline_depth_joint=ck_j.pipeline_depth,
                pipeline_depth_template=ck_t.pipeline_depth))
            built += [ck_j, ck_t, ck_s]
    return rows, built


def check_gate(rows: List[Dict], gate: float) -> List[str]:
    """The cold template build beats joint by ``gate`` at R >= 8."""
    return [f"{row['kernel']} R={row['replicas']}: cold template only "
            f"{row['speedup_cold']}x vs joint (gate {gate}x)"
            for row in rows
            if row["replicas"] >= 8 and row["speedup_cold"] < gate]


def fill_bench(kernels: Sequence[str] = KERNELS, spec=FILL_SPEC):
    """Uncapped fill, auto against joint → (rows, the artifacts)."""
    rows, built = [], []
    for name in kernels:
        src = BENCHMARKS[name][0]
        gc.collect()
        t0 = time.perf_counter()
        ck_a = jit_compile(src, spec)                     # auto, no cache
        auto_ms = (time.perf_counter() - t0) * 1e3
        gc.collect()
        t0 = time.perf_counter()
        ck_j = jit_compile(src, spec, opts=CompileOptions(pr_mode="joint"))
        joint_ms = (time.perf_counter() - t0) * 1e3
        never_joint = (ck_a.pr_path == "template" and
                       "joint_probe" not in ck_a.stage_times_ms and
                       "template_probe" not in ck_a.stage_times_ms)
        rows.append(dict(
            kernel=name, auto_replicas=ck_a.plan.replicas,
            joint_replicas=ck_j.plan.replicas,
            fill_ratio=round(ck_a.plan.replicas /
                             max(1, ck_j.plan.replicas), 3),
            auto_never_joint=never_joint,
            auto_ms=round(auto_ms, 3), joint_ms=round(joint_ms, 3),
            speedup=round(joint_ms / max(auto_ms, 1e-9), 1),
            infill_ms=round(ck_a.stage_times_ms.get("infill", 0.0), 3)))
        built += [ck_a, ck_j]
    return rows, built


def check_fill_gate(rows: List[Dict], gate: float) -> List[str]:
    """Auto stays on the template path and reaches ``gate`` of joint."""
    failures = []
    for row in rows:
        if not row["auto_never_joint"]:
            failures.append(f"{row['kernel']}: auto invoked the joint "
                            f"annealer")
        if row["fill_ratio"] < gate:
            failures.append(
                f"{row['kernel']}: auto fill {row['auto_replicas']} is only "
                f"{row['fill_ratio']} of joint {row['joint_replicas']} "
                f"(gate {gate})")
    return failures


def run(device: str = "cuda", smoke: bool = False) -> Dict:
    """Both sections at the reference's sizes (``smoke``: its CI sweep),
    every artifact then launched once, and the gates."""
    kernels = SMOKE_KERNELS if smoke else KERNELS
    gate = SMOKE_GATE if smoke else GATE
    rows, built = bench(kernels, SMOKE_REPLICAS if smoke else REPLICAS)
    fill_rows, fill_built = fill_bench(kernels)
    failures = check_gate(rows, gate) + check_fill_gate(fill_rows, FILL_GATE)
    exact = [port_bench.launch_checked(ck, N_LAUNCH, device)
             for ck in built + fill_built]
    if not all(exact):
        failures.append(f"{exact.count(False)} of {len(exact)} launches "
                        f"differ from run_reference")
    return dict(
        spec=dict(width=SPEC.width, height=SPEC.height,
                  dsp_per_fu=SPEC.dsp_per_fu,
                  channel_width=SPEC.channel_width),
        device=device, smoke=smoke, gate=gate, rows=rows,
        fill=dict(spec=dict(width=FILL_SPEC.width, height=FILL_SPEC.height,
                            dsp_per_fu=FILL_SPEC.dsp_per_fu,
                            channel_width=FILL_SPEC.channel_width,
                            io_per_edge_tile=FILL_SPEC.io_per_edge_tile),
                  gate=FILL_GATE, rows=fill_rows),
        launches=len(exact), launch_items=N_LAUNCH,
        launches_bit_exact=all(exact),
        card=port_bench.card_line(device), gate_failures=failures)


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows."""
    out = [dict(
        name=f"template_build/{r['kernel']}(R{r['replicas']})",
        us_per_call=r["template_cold_ms"] * 1e3,
        derived=(f"joint={r['joint_ms']:.1f}ms "
                 f"cold={r['template_cold_ms']:.1f}ms "
                 f"stamp={r['template_stamp_ms']:.1f}ms "
                 f"speedup_cold={r['speedup_cold']}x "
                 f"speedup_stamp={r['speedup_stamp']}x"))
        for r in result["rows"]]
    out += [dict(
        name=f"template_fill/{r['kernel']}(uncapped)",
        us_per_call=r["auto_ms"] * 1e3,
        derived=(f"auto R={r['auto_replicas']} "
                 f"joint R={r['joint_replicas']} fill={r['fill_ratio']} "
                 f"never_joint={r['auto_never_joint']} "
                 f"speedup={r['speedup']}x"))
        for r in result["fill"]["rows"]]
    return out


def report(result: Dict) -> None:
    print(f"{'kernel':<10} {'R':>3} {'joint':>9} {'tpl cold':>9} "
          f"{'tpl stamp':>9} {'cold x':>7} {'stamp x':>8}")
    for r in result["rows"]:
        print(f"{r['kernel']:<10} {r['replicas']:>3} "
              f"{r['joint_ms']:>7.1f}ms {r['template_cold_ms']:>7.1f}ms "
              f"{r['template_stamp_ms']:>7.1f}ms "
              f"{r['speedup_cold']:>6.1f}x {r['speedup_stamp']:>7.1f}x")
    print(f"{'kernel':<10} {'auto R':>7} {'joint R':>8} {'fill':>6} "
          f"{'no-joint':>8} {'auto':>9} {'joint':>9} {'speedup':>8}")
    for r in result["fill"]["rows"]:
        print(f"{r['kernel']:<10} {r['auto_replicas']:>7} "
              f"{r['joint_replicas']:>8} {r['fill_ratio']:>6} "
              f"{str(r['auto_never_joint']):>8} {r['auto_ms']:>7.1f}ms "
              f"{r['joint_ms']:>7.1f}ms {r['speedup']:>7.1f}x")
    print(f"gates: cold template >= {result['gate']}x joint at R >= 8, "
          f"fill >= {result['fill']['gate']}; {result['launches']} "
          f"artifacts launched over {result['launch_items']} work-items, "
          f"bit-exact {result['launches_bit_exact']}; {result['card']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI sweep (gate 3x)")
    return port_bench.bench_main("torch_template_build_perf", ap, argv, run,
                                 report)


if __name__ == "__main__":
    sys.exit(main())
