#!/usr/bin/env python3
"""A serving process restarting over the port's persistent compile cache,
its restored programs launched on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_persistent_cache_perf.py \
        [--smoke] [--device cuda] [--json out.json]

The port of ``benchmarks/persistent_cache_perf.py``: two separate Python
processes, each importing ``repro_torch``, share one ``persist_dir``:

  * ``cold_ms`` — process A boots with an empty disk cache and compiles
    the kernels uncapped on ``OverlaySpec(32, 8, 2, io_per_edge_tile=4)``
    (template stamping and gap fill), writing every artifact through;
  * ``warm_ms`` — process B restarts over the same directory and builds
    the same kernels: each a disk hit, deserialised and checksummed, no
    compiler stage run.

Each child times its builds (imports excluded) and reports the bitstream
and program hashes.  The directory is fresh under
``build/persistent_cache/``: the port's blobs carry the port's own magic,
and a blob of the JAX package in the same directory would be quarantined,
not loaded, so each package keeps its own.

The reference's gates (the process exits 1 on any): the warm restart at
least 50x faster than the cold boot in total, every warm build a disk
hit, every warm artifact bit-identical to the persisted one.  Then this
process restores each artifact from the same directory, checks its
hashes against the children's, and launches its program once on the card
over 2^20 work-items, bit for bit against ``run_reference``, outside the
children's timed windows.  ``--smoke`` runs chebyshev and sgfilter, as
the reference's CI does; the reference recorded its 50x gate on all four
kernels (62.3x in ``BENCH_compile.json``), and its recorded builds of the
smoke pair alone give 47.5x, so ``torch_run.py`` and ``chip_smoke.py``
run the full set.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache  # noqa: E402
from repro_torch.core.jit import jit_compile  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402

KERNELS = ("chebyshev", "mibench", "qspline", "sgfilter")
SMOKE_KERNELS = ("chebyshev", "sgfilter")
# the serving config: wide overlay, 4 pads a perimeter tile
SPEC_KW = dict(width=32, height=8, dsp_per_fu=2, io_per_edge_tile=4)
GATE = 50.0
N_LAUNCH = 1 << 20

_CHILD = r"""
import json, sys, time
from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core.cache import JITCache
from repro_torch.core.jit import jit_compile
from repro_torch.core.overlay import OverlaySpec

cfg = json.loads(sys.argv[1])
spec = OverlaySpec(**cfg["spec"])
cache = JITCache(persist_dir=cfg["dir"])
rows = []
for name in cfg["kernels"]:
    t0 = time.perf_counter()
    ck = jit_compile(BENCHMARKS[name][0], spec, cache=cache)
    ms = (time.perf_counter() - t0) * 1e3
    rows.append(dict(kernel=name, ms=ms, replicas=ck.plan.replicas,
                     pr_path=ck.pr_path, bs=ck.bitstream.sha256(),
                     prog=ck.program.content_hash()))
print(json.dumps(dict(rows=rows, disk_hits=cache.stats.disk_hits,
                      disk_writes=cache.disk.writes)))
"""


def _run_child(persist_dir: Path, kernels: Sequence[str]) -> Dict:
    cfg = json.dumps(dict(dir=str(persist_dir), kernels=list(kernels),
                          spec=SPEC_KW))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(port_bench.ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD, cfg], env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"child process failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def restore_and_launch(persist_dir: Path, kernels: Sequence[str],
                       device: str) -> List[Dict]:
    """Each artifact restored from ``persist_dir`` by this process, its
    hashes, and its program launched once against ``run_reference``."""
    cache = JITCache(persist_dir=persist_dir)
    spec = OverlaySpec(**SPEC_KW)
    out = []
    for name in kernels:
        hits = cache.stats.disk_hits
        ck = jit_compile(BENCHMARKS[name][0], spec, cache=cache)
        out.append(dict(kernel=name, disk_hit=cache.stats.disk_hits > hits,
                        bs=ck.bitstream.sha256(),
                        prog=ck.program.content_hash(),
                        bit_exact=port_bench.launch_checked(ck, N_LAUNCH,
                                                            device)))
    return out


def bench(device: str = "cuda", kernels: Sequence[str] = KERNELS) -> Dict:
    """Cold process, then warm (restarted) process, over one directory;
    then each restored program launched."""
    d = port_bench.fresh_dir("persistent_cache", "ovl-cache")
    try:
        cold = _run_child(d, kernels)
        warm = _run_child(d, kernels)
        restored = restore_and_launch(d, kernels, device)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rows: List[Dict] = []
    total_cold = total_warm = 0.0
    for c, w, r in zip(cold["rows"], warm["rows"], restored):
        rows.append(dict(
            kernel=c["kernel"], replicas=c["replicas"], pr_path=c["pr_path"],
            cold_ms=round(c["ms"], 3), warm_ms=round(w["ms"], 3),
            speedup=round(c["ms"] / max(w["ms"], 1e-9), 1),
            bit_identical=c["bs"] == w["bs"] and c["prog"] == w["prog"],
            bitstream_sha256=c["bs"], program_hash=c["prog"],
            restored_disk_hit=r["disk_hit"],
            restored_identical=(r["bs"], r["prog"]) == (c["bs"], c["prog"]),
            launch_bit_exact=r["bit_exact"]))
        total_cold += c["ms"]
        total_warm += w["ms"]
    return dict(
        spec=SPEC_KW, device=device, rows=rows,
        total_cold_ms=round(total_cold, 3),
        total_warm_ms=round(total_warm, 3),
        speedup_total=round(total_cold / max(total_warm, 1e-9), 1),
        warm_disk_hits=warm["disk_hits"],
        cold_disk_writes=cold["disk_writes"], launch_items=N_LAUNCH)


def check_gate(result: Dict, gate: float = GATE) -> List[str]:
    """The reference's three gates, and the restored launches."""
    failures = []
    if result["speedup_total"] < gate:
        failures.append(f"warm restart only {result['speedup_total']}x "
                        f"faster than cold (gate {gate}x)")
    if result["warm_disk_hits"] < len(result["rows"]):
        failures.append(f"only {result['warm_disk_hits']} of "
                        f"{len(result['rows'])} warm builds hit the disk "
                        f"cache")
    for row in result["rows"]:
        if not row["bit_identical"]:
            failures.append(f"{row['kernel']}: warm artifact differs from "
                            f"persisted cold artifact")
        if not (row["restored_disk_hit"] and row["restored_identical"]):
            failures.append(f"{row['kernel']}: the artifact restored for "
                            f"the launch is not the persisted one")
        if not row["launch_bit_exact"]:
            failures.append(f"{row['kernel']}: the restored program's "
                            f"launch differs from run_reference")
    return failures


def run(device: str = "cuda", smoke: bool = False) -> Dict:
    """``bench`` (``smoke``: chebyshev and sgfilter) with the card's line
    and the gates' failures."""
    result = bench(device, SMOKE_KERNELS if smoke else KERNELS)
    result["smoke"] = smoke
    result["card"] = port_bench.card_line(device)
    result["gate"] = GATE
    result["gate_failures"] = check_gate(result)
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows."""
    out = [dict(
        name=f"persistent_cache/{r['kernel']}",
        us_per_call=r["warm_ms"] * 1e3,
        derived=(f"cold={r['cold_ms']:.1f}ms warm={r['warm_ms']:.2f}ms "
                 f"speedup={r['speedup']}x R={r['replicas']} "
                 f"bit_identical={r['bit_identical']}"))
        for r in result["rows"]]
    out.append(dict(
        name="persistent_cache/total",
        us_per_call=result["total_warm_ms"] * 1e3,
        derived=(f"cold={result['total_cold_ms']:.0f}ms "
                 f"warm={result['total_warm_ms']:.1f}ms "
                 f"speedup={result['speedup_total']}x")))
    return out


def report(result: Dict) -> None:
    print(f"{'kernel':<10} {'R':>3} {'cold':>9} {'warm':>9} {'speedup':>8} "
          f"{'identical':>9} {'launch':>7}")
    for r in result["rows"]:
        print(f"{r['kernel']:<10} {r['replicas']:>3} {r['cold_ms']:>7.1f}ms "
              f"{r['warm_ms']:>7.2f}ms {r['speedup']:>7.1f}x "
              f"{str(r['bit_identical']):>9} {str(r['launch_bit_exact']):>7}")
    print(f"{'TOTAL':<10} {'':>3} {result['total_cold_ms']:>7.1f}ms "
          f"{result['total_warm_ms']:>7.2f}ms "
          f"{result['speedup_total']:>7.1f}x (gate {result['gate']}x); "
          f"{result['card']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="chebyshev and sgfilter only, as the reference's CI")
    return port_bench.bench_main("torch_persistent_cache_perf", ap, argv,
                                 run, report)


if __name__ == "__main__":
    sys.exit(main())
