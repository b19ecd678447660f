"""BENCHMARK.json against the contract's shape, and its files found by
name: a cell, a traffic mix and a per-layer metric added as new files and
entries in a copy are found and run with no file edited."""

import json
import re
import shutil

import pytest

from bench.spec import Spec, load_json
from bench.tests import tiny
from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_units_and_files():
    spec = Spec()
    data = spec.data
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["bench"]
    assert 1 <= data["run_seconds"] <= 51
    names = [c["name"] for c in data["configs"]] + \
        [w["name"] for w in data["workloads"]] + \
        [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in data["configs"]:
        cfg = spec.config(c["name"])
        assert c["source"] == cfg["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]
    for w in data["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        spec.traffic(w["traffic"])
        assert spec.limits(w["name"])["numbers"]
        reported = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(w["name"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in data["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in data["end_to_end"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    Spec().data["per_layer"]])
def test_metric_reader_declares_what_benchmark_says(metric):
    spec = Spec()
    entry = next(m for m in spec.data["per_layer"] if m["name"] == metric)
    mod = spec.module("metrics", metric)
    assert mod.UNIT == entry["unit"] and mod.MOVES == entry["moves"]
    assert entry["layer"].startswith(mod.LAYER)
    assert mod.read(None) is None          # nothing to read: left out
    for w in entry.get("workloads", ()):
        assert entry["moves"] in {m["name"] for m in spec.end_to_end(w)}


@pytest.mark.parametrize("path", sorted(
    p.name for p in (Spec().bench / "configs").glob("*.json")))
def test_config_files_state_their_cuts(path):
    """Every configuration file, in BENCHMARK.json or not: each key in
    ``reduced`` has its published value under ``published`` and differs
    from it; the source, the assumptions and the deployment are given."""
    cfg = load_json(Spec().bench / "configs" / path)
    assert cfg["name"] + ".json" == path
    assert sorted(cfg["reduced"]) == sorted(cfg["published"])
    for key in cfg["reduced"]:
        assert cfg[key] != cfg["published"][key], key
    assert cfg["source"].startswith("https://")
    assert cfg["assumed"] and cfg["deployment"]


def test_a_new_config_cell_mix_and_metric_need_no_edit(tmp_path):
    """Files added in a copy of the benchmark: a configuration, a mix, its
    cell's limits, a metric reader; entries added to the copy's
    BENCHMARK.json; no file of the copy edited but BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(Spec().bench, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((Spec().root / "BENCHMARK.json").read_text())
    config = {**Spec().config("qwen3-moe-235b-a22b"), **tiny.MOE,
              "name": "qwen3-moe-mini"}
    (root / "bench" / "configs" / "qwen3-moe-mini.json").write_text(
        json.dumps(config))
    (root / "bench" / "traffic" / "prefill_2x64.json").write_text(json.dumps(
        {"kind": "prefill_batch", "batch": 2, "seq": 64, "check_steps": 1,
         "trace_steps": 2}))
    (root / "bench" / "limits" / "qwen3-moe-mini.prefill.json").write_text(
        json.dumps({"numbers": {"logit_rel_err": {"limit": 0.01}}}))
    (root / "bench" / "metrics" / "steps_traced.py").write_text(
        'UNIT, LAYER, MOVES = "steps", "device", "prefill_tok_s"\n'
        "def read(rec):\n"
        "    return None if rec is None else float(rec.steps)\n")
    data["configs"].append({"name": "qwen3-moe-mini",
                            "source": config["source"],
                            "file": "bench/configs/qwen3-moe-mini.json",
                            "reduced": [], "why": "a test's configuration"})
    data["workloads"].append({"name": "qwen3-moe-mini.prefill",
                              "config": "qwen3-moe-mini",
                              "traffic": "prefill_2x64", "chips": 1,
                              "why": "a test's cell"})
    for m in data["end_to_end"]:
        if m["name"] == "prefill_tok_s":
            m["workloads"].append("qwen3-moe-mini.prefill")
    data["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "prefill_tok_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(root)
    assert "steps_traced" in [m["name"] for m in
                              spec.per_layer("qwen3-moe-mini.prefill")]
    cell = harness.make_cell(spec, "qwen3-moe-mini.prefill", tiny.SEED, 0.2,
                             True, "cpu", 0.0)
    out = harness.run_cell(cell)
    line = harness.result(cell, out)
    assert line["correct"]
    assert line["metrics"]["steps_traced"] == {"value": 2.0, "unit": "steps"}
    assert list(line)[-1] == "checked"
