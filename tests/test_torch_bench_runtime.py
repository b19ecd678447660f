"""The port's runtime suites against the reference's: the JIT cache, queue
scheduling, chaos serving, template builds, the persistent cache and the
fleet warm start, and the port's harness ``benchmarks/torch_run.py``.

Each port suite runs on the CPU (``device="cpu"``: the executor's plain
version) beside the reference module of ``benchmarks/``, loaded from its
file, at the same (smoke) sizes.  Sessions build on one worker with the
host clock held at 0 µs in both packages (the port's suites do so
themselves; the reference's are given such a Session here), so modelled
makespans, speed-ups, placements, recovery counters and output sha256s
compare exactly.  The fleet's chaos scenario half-opens its breakers
after a wall-clock cooldown in both packages, so here both read one
stepping clock instead.  Cache counters and artifact hashes compare
exactly; timings are only checked to be positive, and each timing gate is
checked to keep the reference's value.  The card legs run under the
``gpu`` marker.
"""

import ast
import hashlib
import importlib.util
import json
import re
import sys
import types
from pathlib import Path

import pytest
import torch  # noqa: F401 - read by the gpu skipif condition
from torch_runtime_pair import R, T

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
N_LAUNCH = 4096


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


class ModelledSession(R.session.Session):
    """The reference's Session on one build worker, clock at 0 µs."""

    def __init__(self, *args, **kw):
        kw["max_workers"] = 1
        super().__init__(*args, **kw)

    def now_us(self) -> float:
        return 0.0


def without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


# ------------------------------------------------------------- jit cache

@pytest.fixture(scope="module")
def jit_cache():
    port = load("torch_jit_cache_perf")
    port.N_LAUNCH = N_LAUNCH
    return port, port.run("cpu")


def test_jit_cache_gates_hold_on_the_cpu(jit_cache):
    port, result = jit_cache
    assert result["gate_failures"] == []
    assert port.WARM_GATE == 10.0
    cw = result["cold_warm"]
    assert cw["worst_speedup"] == min(r["speedup"] for r in cw["rows"])
    assert all(r["cold_ms"] > 0 and r["warm_ms"] > 0 for r in cw["rows"])


def test_jit_cache_cold_warm_and_queue_match_the_reference(jit_cache,
                                                           capsys):
    _, result = jit_cache
    ref = load("jit_cache_perf")
    capsys.readouterr()
    ref.bench_cold_vs_warm()
    ref.bench_queue_throughput()
    out = capsys.readouterr().out
    stats = ast.literal_eval(re.search(r"cache stats: (\{.*\})", out)[1])
    assert result["cold_warm"]["cache_stats"] == stats
    for row in result["cold_warm"]["rows"]:
        ck = R.jit.jit_compile(R.BENCHMARKS[row["kernel"]][0], R.spec())
        assert row["replicas"] == ck.plan.replicas
    q = result["queue"]
    assert (f"modelled overlay: {q['same']['modelled_kernels_per_s']:10.0f} "
            f"kernels/s (makespan {q['same']['makespan_us']:.0f} us)") in out
    alt = q["alternating"]
    assert (f"alternating programs: {alt['modelled_kernels_per_s']:10.0f} "
            f"kernels/s modelled ({alt['reconfigs']} reconfigs charged)") \
        in out
    assert q["same"]["bit_exact"] and alt["bit_exact"]
    assert q["same"]["host_kernels_per_s"] > 0


class OneWorkerSession(R.session.Session):
    """The reference's Session on one build worker, as the port's suite
    builds: with four, a replica shed racing a parallel build can fail to
    re-debit the program it restores (ROADMAP §3)."""

    def __init__(self, *args, **kw):
        kw["max_workers"] = 1
        super().__init__(*args, **kw)


def test_jit_cache_verify_faults_and_remote_match_the_reference(
        jit_cache, monkeypatch):
    _, result = jit_cache
    ref = load("jit_cache_perf")
    # the reference's sections import Session when they run
    monkeypatch.setattr(R.session, "Session", OneWorkerSession)
    verify = ref.bench_verify_overhead()
    for got, want in zip(result["verify"]["rows"], verify["rows"]):
        assert got["name"] == want["name"]
        for level in ("off", "fused", "full"):
            # the reference's run above would have raised otherwise
            assert got[f"verify_booked_{level}"] == (level != "off")
            assert (got[f"verify_ms_{level}"] > 0) == (level != "off")
        assert got["same_artifact_every_level"]
        assert got["verify_quarantined"] == 0
    ff = ref.bench_fault_free_overhead()
    assert (result["fault_free"]["recovery"],
            result["fault_free"]["attempts"]) == (ff["recovery"],
                                                  ff["attempts"])
    assert result["fault_free"]["bit_exact"]
    remote = ref.bench_remote_disabled_overhead()
    assert result["remote"]["remote_counters"] == remote["remote_counters"]
    assert result["remote"]["remote_section"] is False


# -------------------------------------------------- queue and chaos suites

def test_queue_sched_matches_the_reference():
    port, ref = load("torch_queue_sched_perf"), load("queue_sched_perf")
    ref.Session = ModelledSession
    got, want = port.run("cpu"), ref.bench()
    for key in ("makespan", "free_fabric"):
        assert without(got[key], "bit_exact") == want[key]
        assert got[key]["bit_exact"]
    assert got["speedup"] == want["speedup"] >= 1.0
    assert got["gate_failures"] == ref.check_gate(want, 1.0) == []
    assert [r["name"] for r in port.rows(got)] == \
        ["queue_sched/makespan", "queue_sched/free_fabric",
         "queue_sched/speedup"]


def test_chaos_serving_matches_the_reference():
    port, ref = load("torch_chaos_serving_perf"), load("chaos_serving_perf")
    ref.Session = ModelledSession
    got, want = port.run("cpu"), ref.bench()
    for key in ("fault_free", "chaos"):
        assert without(got[key], "bit_exact") == want[key]
    assert got["fault_free"]["bit_exact"]
    assert got["chaos"]["faults"]["injected"]
    assert got["chaos"]["recovery"]["migrated_programs"] > 0
    for key in ("all_complete", "bit_identical", "degradation"):
        assert got[key] == want[key]
    assert got["degradation"] <= 2.0
    assert got["gate_failures"] == ref.check_gate(want, 2.0) == []


# -------------------------------------------------- compile-side suites

def test_template_build_matches_the_reference():
    port, ref = load("torch_template_build_perf"), load("template_build_perf")
    port.N_LAUNCH = N_LAUNCH
    got = port.run("cpu", smoke=True)
    want = ref.bench(ref.SMOKE_KERNELS, ref.SMOKE_REPLICAS)
    keys = ("kernel", "replicas", "pipeline_depth_joint",
            "pipeline_depth_template")
    assert [{k: r[k] for k in keys} for r in got["rows"]] == \
        [{k: r[k] for k in keys} for r in want]
    fill_keys = ("kernel", "auto_replicas", "joint_replicas", "fill_ratio",
                 "auto_never_joint")
    assert [{k: r[k] for k in fill_keys} for r in got["fill"]["rows"]] == \
        [{k: r[k] for k in fill_keys}
         for r in ref.fill_bench(ref.SMOKE_KERNELS)]
    assert port.check_fill_gate(got["fill"]["rows"], 0.95) == []
    assert got["launches_bit_exact"] and got["launches"] == 16
    assert (got["gate"], port.GATE, port.FILL_GATE) == (3.0, 5.0, 0.95)
    for gate in (3.0, 5.0, 1e9):     # the reference's gate, unchanged
        assert port.check_gate(got["rows"], gate) == \
            ref.check_gate(got["rows"], gate)
    assert all(r[k] > 0 for r in got["rows"]
               for k in ("joint_ms", "template_cold_ms",
                         "template_stamp_ms"))


def test_persistent_cache_restores_the_reference_artifacts(tmp_path):
    port, ref = (load("torch_persistent_cache_perf"),
                 load("persistent_cache_perf"))
    port.N_LAUNCH = N_LAUNCH
    got = port.run("cpu", smoke=True)
    want = ref._run_child(str(tmp_path), ref.SMOKE_KERNELS)
    assert [(r["kernel"], r["replicas"], r["pr_path"], r["bitstream_sha256"],
             r["program_hash"]) for r in got["rows"]] == \
        [(r["kernel"], r["replicas"], r["pr_path"], r["bs"], r["prog"])
         for r in want["rows"]]
    assert got["warm_disk_hits"] == len(got["rows"])
    assert got["cold_disk_writes"] == want["disk_writes"]
    for row in got["rows"]:
        assert row["bit_identical"] and row["restored_disk_hit"]
        assert row["restored_identical"] and row["launch_bit_exact"]
        assert row["cold_ms"] > 0 and row["warm_ms"] > 0
    assert port.GATE == 50.0
    assert [f for f in got["gate_failures"]
            if "faster than cold" not in f] == []


@pytest.mark.parametrize("faulty_round", [None, 0, 2])
def test_persistent_cache_keeps_the_least_of_its_rounds(monkeypatch,
                                                        faulty_round):
    """Each timing is the least over the rounds, the cold boot's as the
    warm restart's, the totals per round; an artifact that differs in any
    round fails its row."""
    port = load("torch_persistent_cache_perf")
    kernels = ("chebyshev", "sgfilter")
    # (cold, warm) ms of each kernel in each of three rounds
    times = [((300.0, 40.0), (9.0, 1.0)), ((250.0, 50.0), (2.0, 30.0)),
             ((280.0, 45.0), (3.0, 2.0))]
    calls = []

    class Child:
        def __init__(self, d, names):
            self.rnd, self.side = divmod(len(calls), 2)
            self.d, self.names = d, names
            calls.append(self)

        def ready(self):
            # every child is started before any builds
            assert len(calls) == 6

        def run(self):
            bs = "bad" if (self.rnd, self.side) == (faulty_round, 1) \
                else "bs"
            return dict(rows=[dict(kernel=k, ms=ms, replicas=1,
                                   pr_path="p", bs=bs + k, prog="prog" + k)
                              for k, ms in zip(self.names,
                                               times[self.rnd][self.side])],
                        disk_hits=2 * self.side,
                        disk_writes=2 * (1 - self.side))

        def close(self):
            pass

    def restore(d, names, device):
        assert d == calls[-1].d
        return [dict(kernel=k, disk_hit=True, bs="bs" + k, prog="prog" + k,
                     bit_exact=True) for k in names]
    monkeypatch.setattr(port, "_Child", Child)
    monkeypatch.setattr(port, "restore_and_launch", restore)
    assert port.ROUNDS == 3
    got = port.bench("cpu", kernels)
    assert [c.d for c in calls[0::2]] == [c.d for c in calls[1::2]]
    assert len({c.d for c in calls}) == 3
    assert [(r["cold_ms"], r["warm_ms"]) for r in got["rows"]] == \
        [(250.0, 2.0), (40.0, 1.0)]
    assert got["rounds"] == [dict(cold_ms=340.0, warm_ms=10.0),
                             dict(cold_ms=300.0, warm_ms=32.0),
                             dict(cold_ms=325.0, warm_ms=5.0)]
    assert (got["total_cold_ms"], got["total_warm_ms"],
            got["speedup_total"]) == (300.0, 5.0, 60.0)
    failures = port.check_gate(got)
    if faulty_round is None:
        assert failures == []
    else:
        assert failures == [f"{k}: warm artifact differs from persisted "
                            f"cold artifact" for k in kernels]
    assert port.check_gate(got, gate=61.0) == \
        ["warm restart only 60.0x faster than cold (gate 61.0x)"] + failures


class StepClock:
    """A monotonic clock that advances 1 ms at every reading."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        self.t += 1e-3
        return self.t


def test_fleet_warm_start_matches_the_reference(monkeypatch, tmp_path):
    port, ref = (load("torch_fleet_warm_start_perf"),
                 load("fleet_warm_start_perf"))
    port.N_LAUNCH = N_LAUNCH
    monkeypatch.setattr(T.recovery, "time", StepClock())
    got = port.run("cpu")
    monkeypatch.setattr(R.recovery, "time", StepClock())
    refs = ref.build_reference()
    assert [r.sha for r in refs.values()] == \
        [r.ck.bitstream.sha256() for r in port.build_reference().values()]
    for label, with_remote, chaos in (("disk-only", False, False),
                                      ("remote", True, False),
                                      ("chaos", True, True)):
        want = ref.replay(refs, tmp_path / label, 200, 2000, 6000,
                          with_remote, chaos, label)
        want["hashes_sha256"] = hashlib.sha256(
            "\n".join(want.pop("hashes")).encode()).hexdigest()
        assert got["scenarios"][label] == json.loads(json.dumps(want)), label
    fresh = ref.fresh_host_join(refs, tmp_path / "fresh", None)
    assert without(got["scenarios"]["fresh-host"], "served_built") == fresh
    assert got["gate_failures"] == []
    assert got["launches"] == 12 and got["launches_bit_exact"]


# ---------------------------------------------------------- the harness

def test_harness_prints_the_reference_csv(monkeypatch, tmp_path, capsys):
    monkeypatch.syspath_prepend(str(BENCH))
    harness = load("torch_run")
    monkeypatch.setitem(harness.RUN_KWARGS, "resource_table",
                        dict(items=N_LAUNCH))
    out_json = tmp_path / "rows.json"
    record = (ROOT / "BENCH_compile.json").read_bytes()
    assert harness.main(["--device", "cpu", "--suite", "resource_table",
                         "--json", str(out_json)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["cpu (no card)", "name,us_per_call,derived"]
    rows = json.loads(out_json.read_text())
    assert [r["suite"] for r in rows] == ["resource_table"] * 6
    assert [line.split(",")[0] for line in lines[2:]] == \
        [r["name"] for r in rows]
    # the reference's 16 suites, roofline_report reading the port's dry run
    assert len(harness.SUITES) == 16 and "model_step" in harness.SUITES
    assert "roofline_report" in harness.SUITES
    assert (ROOT / "BENCH_compile.json").read_bytes() == record


@pytest.mark.parametrize("fault", ["gate", "raise", "exit"])
def test_harness_exits_1_when_a_suite_fails(monkeypatch, capsys, fault):
    monkeypatch.syspath_prepend(str(BENCH))
    harness = load("torch_run")
    fake = types.ModuleType("torch_queue_sched_perf")

    def run(device):
        if fault == "raise":
            raise RuntimeError("boom")
        if fault == "exit":
            raise SystemExit("GATE FAILED: boom")
        return dict(gate_failures=["boom"])
    fake.run = run
    fake.rows = lambda result: [dict(name="queue_sched/x", us_per_call=1.0,
                                     derived="x")]
    monkeypatch.setitem(sys.modules, "torch_queue_sched_perf", fake)
    assert harness.main(["--device", "cpu", "--suite",
                         "queue_sched_perf"]) == 1
    out = capsys.readouterr()
    assert "queue_sched/" not in out.out and "ERROR" not in out.out
    assert "queue_sched_perf: FAILED" in out.err


@gpu
def test_runtime_suites_run_on_the_card():
    """The six runtime suites' ``run`` on the card (the template builds at
    the reference's smoke sweep; the persistent cache at its four kernels,
    where its 50x gate was recorded) and the harness on one suite: no gate
    fails."""
    for name, kw in (("torch_jit_cache_perf", {}),
                     ("torch_queue_sched_perf", {}),
                     ("torch_chaos_serving_perf", {}),
                     ("torch_template_build_perf", dict(smoke=True)),
                     ("torch_persistent_cache_perf", {}),
                     ("torch_fleet_warm_start_perf", {})):
        result = load(name).run("cuda", **kw)
        assert result["gate_failures"] == [], name
    sys.path.insert(0, str(BENCH))
    assert load("torch_run").main(["--suite", "resource_table"]) == 0
