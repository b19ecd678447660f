#!/usr/bin/env python3
"""Roofline table from the port's dry-run artifact: the port of
``benchmarks/roofline_report.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        --out experiments/torch_dryrun_single_pod.json
    PYTHONPATH=src python3 benchmarks/torch_roofline_report.py \
        [--art PATH] [--device cpu]

Reads ``experiments/torch_dryrun_single_pod.json`` (the artifact is made
on the host, never committed) and prints the reference's rows: one
``roofline/<arch>/<shape>`` row a cell, its roofline step time in µs and
the terms in the H100's data-sheet rates, or ``SKIP:`` with the cell's
skip reason or error; ``roofline/missing`` when there is no artifact.  No
gate, as the reference has none; nothing runs on the card.  The harness's
16th suite (``benchmarks/torch_run.py --suite roofline_report``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "experiments",
                   "torch_dryrun_single_pod.json")


def run(device: str = "cuda", art: Optional[str] = None) -> Dict:
    path = art or ART
    cells = None
    if os.path.exists(path):
        with open(path) as f:
            cells = json.load(f)
    return dict(device=port_bench.card_line(device), cells=cells,
                gate_failures=[])


def rows(result: Dict) -> List[Dict]:
    """The reference's rows, in its format."""
    if result["cells"] is None:
        return [{"name": "roofline/missing", "us_per_call": 0,
                 "derived": "run repro_torch.launch.dryrun --all first"}]
    out = []
    for c in result["cells"]:
        if "roofline" not in c:
            reason = c.get("skipped", c.get("error", "?"))
            out.append({"name": f"roofline/{c['arch']}/{c['shape']}",
                        "us_per_call": 0,
                        "derived": f"SKIP: {str(reason)[:80]}"})
            continue
        r = c["roofline"]
        out.append({
            "name": f"roofline/{c['arch']}/{c['shape']}",
            "us_per_call": r["step_s"] * 1e6,
            "derived": (f"dom={r['dominant']} "
                        f"comp={r['compute_s']*1e3:.2f}ms "
                        f"mem={r['memory_s']*1e3:.2f}ms "
                        f"coll={r['collective_s']*1e3:.2f}ms "
                        f"mfu={r['mfu']:.3f} "
                        f"useful={r['useful_flops_ratio']:.2f}"),
        })
    return out


def report(result: Dict) -> None:
    for row in rows(result):
        print(f"{row['name']},{row['us_per_call']:.2f},\"{row['derived']}\"")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--art", default=None,
                    help="the dry run's --out JSON (default: "
                         "experiments/torch_dryrun_single_pod.json)")
    return port_bench.bench_main("torch_roofline_report", ap, argv, run,
                                 report)


if __name__ == "__main__":
    sys.exit(main())
