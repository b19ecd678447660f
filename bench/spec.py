"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, so a cell, a mix or a metric
is added as new files plus entries in BENCHMARK.json:

  configs/<config>.json     the configuration as run (``file`` in BENCHMARK.json)
  families/<family>.py      builds a family's model, weights and reference
  traffic/<mix>.json        a traffic mix: its ``kind`` and parameters
  traffic/<kind>.py         the driver of one kind of traffic
  limits/<workload>.json    the limits of the cell's output check
  metrics/<metric>.py       the reader of one per-layer metric
  counts/<family>.py        operations and bytes of a family's steps
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json of a checkout (``root``), and the bench files beside it."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "bench"
        self.data = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = sorted(w["name"] for w in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {known}")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict[str, Any]:
        return load_json(self.bench / "limits" / f"{workload}.json")

    def module(self, folder: str, name: str) -> ModuleType:
        """``bench/<folder>/<name>.py`` loaded by path (a name may hold dots)."""
        path = self.bench / folder / f"{name}.py"
        key = re.sub(r"\W", "_", f"bench_{folder}_{name}_{path}")
        if key in sys.modules:
            return sys.modules[key]
        loader = importlib.util.spec_from_file_location(key, path)
        if loader is None or not path.exists():
            raise FileNotFoundError(f"no {path}")
        mod = importlib.util.module_from_spec(loader)
        sys.modules[key] = mod
        loader.loader.exec_module(mod)
        return mod

    def end_to_end(self, workload: str) -> List[Dict[str, Any]]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[Dict[str, Any]]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list whose end-to-end metric it
        reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]
