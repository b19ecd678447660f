"""One cell of BENCHMARK.json run once: set-up, the measured window (and in
a traced run the profiled sub-window), the output check against the plain
reference, and the result line.

The traffic kind's driver (``traffic/<kind>.py``) runs the cell and
returns an :class:`Outcome`; this module turns it into the result line:
the end-to-end metrics (``--trace 0``) or the per-layer metrics, read by
``metrics/<name>.py`` from the traced records (``--trace 1``), ``correct``
from the compared numbers and ``limits/<workload>.json``, and the device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from bench.spec import Spec
from bench.trace import Records

# top-level module names that may not be loaded when the window closes:
# JAX, and the JAX package that the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Cell:
    """Everything a driver needs to run one cell once."""
    spec: Spec
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    family: ModuleType
    counts: ModuleType
    # a reference mode in float8 ("fp8", "fp8_attn": ``reference.common.
    # MODES``) also read at the check, in the program's place (the control)
    control: Optional[str] = None

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config["torch_dtype"]]

    def trace_path(self):
        return self.spec.root / "build" / "bench" / f"trace-{self.name}.json"


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.  ``numbers``: the compared numbers of the
    output check, by name; ``control``: the same numbers read from the
    control, where the cell asked for it; ``notes``: lines for standard
    error, printed before the compared numbers."""
    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak: int
    records: Optional[Records] = None
    control: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def make_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
              device, t0: float, overrides: Optional[Dict] = None,
              control: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``spec``; ``overrides`` ({"config": {...},
    "traffic": {...}}) replace keys of the configuration file and the mix
    (the tests' tiny sizes)."""
    overrides = overrides or {}
    wl = spec.workload(name)
    cfg = {**spec.config(wl["config"]), **overrides.get("config", {})}
    mix = {**spec.traffic(wl["traffic"]), **overrides.get("traffic", {})}
    return Cell(spec=spec, name=name, workload=wl, config=cfg, mix=mix,
                seed=seed, seconds=seconds, trace=trace,
                device=torch.device(device), t0=t0,
                family=spec.module("families", cfg["family"]),
                counts=spec.module("counts", cfg["family"]),
                control=control)


def run_cell(cell: Cell) -> Outcome:
    driver = cell.spec.module("traffic", cell.mix["kind"])
    return driver.run(cell)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def result(cell: Cell, out: Outcome) -> Dict[str, Any]:
    """The result line's object; ``checked`` last."""
    spec, name = cell.spec, cell.name
    metrics: Dict[str, Dict[str, Any]] = {}
    if not cell.trace:
        values = {**out.e2e, "setup_s": out.setup_s}
        for m in spec.end_to_end(name):
            if m["name"] not in values:
                raise RuntimeError(f"{name}'s driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec.per_layer(name):
            value = spec.module("metrics", m["name"]).read(out.records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = spec.limits(name)["numbers"]
    checked = {k: {"value": out.numbers.get(k), "limit": v["limit"]}
               for k, v in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checked.values())
    dev = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
           "kind": device_name(cell.device),
           "count": cell.workload["chips"],
           "memory_peak_bytes": out.memory_peak}
    line: Dict[str, Any] = {"correct": correct, "attempted": out.attempted,
                            "failed": out.failed, "metrics": metrics,
                            "device": dev}
    if cell.trace and out.records is not None:
        dev["busy_s"] = out.records.busy_s()
        dev["window_s"] = out.records.window_s
        line["breakdown"] = out.records.breakdown()
    line["checked"] = checked
    return line


def main(args, t0: float) -> int:
    """Run ``args.workload`` once on the card and print its result line;
    an exit code other than 0 and no result line where it cannot."""
    spec = Spec()
    wl = spec.workload(args.workload)
    if not (spec.root / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"bench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    cell = make_cell(spec, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", t0)
    out = run_cell(cell)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 4
    line = result(cell, out)
    for note in out.notes:
        print(note, file=sys.stderr)
    for k, c in line["checked"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def now() -> float:
    return time.perf_counter()


def chip_peaks(device: torch.device):
    """The data sheet's peaks of the card (None for a chip the table lacks,
    and on the CPU)."""
    from bench.counts.peaks import peaks
    return peaks(device_name(device)) if device.type == "cuda" else None
