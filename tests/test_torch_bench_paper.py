"""The port's paper suites against the reference's: Fig. 6, Fig. 7,
Table III and the executor micro-benchmark.

Each port suite's ``bench("cpu")`` (the executor's plain version on the
CPU) runs beside the reference module of ``benchmarks/``, loaded from its
file, at the same sizes; the deterministic columns (replicas, modelled
GOPS, peak, what limits replication, resources, configuration bytes,
depth, the paper's quoted figures, program hashes) are compared exactly,
every launch is held bit for bit against ``run_reference``, and timings
are only checked to be positive.  par_time's recompile is stubbed here,
and the yardstick itself compiles once for real.  The reference's
executor micro-benchmark runs the Pallas executor, so the port's is held
against ``run_reference`` and ``execute_image`` instead.  The card legs
run under the ``gpu`` marker.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_runtime_pair import R, assert_same_bits

from repro.core.program import compile_program as ref_compile_program

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
N = 4096


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


def fields(derived: str) -> dict:
    """A CSV row's ``key=value`` words."""
    return dict(w.split("=", 1) for w in derived.split() if "=" in w)


def same_fields(port_rows, ref_rows, keys):
    """Both suites print the same rows, equal in ``keys``."""
    assert [r["name"] for r in port_rows] == [r["name"] for r in ref_rows]
    for p, r in zip(port_rows, ref_rows):
        fp, fr = fields(p["derived"]), fields(r["derived"])
        assert {k: fp[k] for k in keys} == {k: fr[k] for k in keys}, p["name"]
        assert p["us_per_call"] > 0


@pytest.fixture(scope="module")
def replication():
    return load("torch_replication_scaling").run("cpu", items=N, reps=2)


def test_replication_scaling_rows_match_the_reference(replication):
    port = load("torch_replication_scaling")
    same_fields(port.rows(replication), load("replication_scaling").run(),
                ("replicas", "gops", "peak", "frac", "limited_by"))
    assert replication["gate_failures"] == []


def test_replication_scaling_models_the_reference_exactly(replication):
    """Full-precision modelled columns, and the one image each size's
    artifact runs, against the reference compiler's."""
    src = R.BENCHMARKS["chebyshev"][0]
    for row in replication["rows"]:
        spec = R.OverlaySpec(width=row["size"], height=row["size"],
                             dsp_per_fu=row["dsp"])
        ck = R.jit.jit_compile(src, spec,
                               opts=R.CompileOptions(place_effort=0.3))
        assert (row["replicas"], row["throughput_gops"], row["peak_gops"],
                row["limited_by"]) == (ck.plan.replicas,
                                       ck.throughput_gops(),
                                       spec.peak_gops(), ck.plan.limited_by)
        assert row["program_hash"] == \
            ref_compile_program(ck.dfg).content_hash()
        assert row["ops_per_item"] == len(ck.dfg.op_nodes())
    for r in replication["executor"].values():
        assert r["bit_exact"] and r["items"] == N and r["gops"] > 0
        assert sorted(r["dsps"]) == [1, 2]   # one image for both fusions
        assert all(t > 0 for t in r["ms_all"])


def test_par_time_rows_match_the_reference(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))    # par_time imports benchmarks.*
    port = load("torch_par_time")
    stub = dict(first_ms=2.0, warm_ms=1.0, compile_ms=1.0)
    calls = []

    def recompile(dfg, *xs):
        calls.append((dfg.name, len(xs), tuple(x.shape for x in xs)))
        return stub
    result = port.bench("cpu", recompile=recompile)
    ref_rows = load("par_time").run()
    same_fields(port.rows(result), ref_rows, ("paper_vivado",))
    assert calls[0] == ("warmup", 1, ((N,),))
    assert [c[0] for c in calls[1:]] == sorted(R.BENCHMARKS)
    for (name, n_in, shapes), row in zip(calls[1:], result["rows"]):
        ck = R.jit.jit_compile(R.BENCHMARKS[name][0], R.spec(),
                               opts=R.CompileOptions(
                                   max_replicas=R.BENCHMARKS[name][1]))
        assert (n_in, row["replicas"]) == (len(ck.dfg.inputs),
                                           ck.plan.replicas)
        assert shapes == ((port.N_ITEMS,),) * n_in
        assert row["torch_compile"] == stub and row["overlay_par_ms"] > 0
    assert port.PAPER_DIRECT == load("resource_table").PAPER_DIRECT


def test_the_recompile_yardstick_compiles_cold_in_build():
    """One real cold ``torch.compile`` through the shared yardstick: its
    caches lie under ``build/`` and are gone afterwards."""
    sys.path.insert(0, str(BENCH))
    import port_bench
    from repro_torch.core.dfg import trace

    before = set((port_bench.BUILD / "yardstick_test").glob("*")) \
        if (port_bench.BUILD / "yardstick_test").exists() else set()
    x = torch.linspace(-1, 1, 64)
    out = port_bench.recompile_ms(trace(lambda v: v * 2.0 + 1.0, 1, "t"), x,
                                  sub="yardstick_test")
    assert out["first_ms"] > out["warm_ms"] > 0
    assert out["compile_ms"] == out["first_ms"] - out["warm_ms"]
    assert set((port_bench.BUILD / "yardstick_test").glob("*")) == before


def test_resource_table_rows_match_the_reference():
    port = load("torch_resource_table")
    result = port.bench("cpu", items=N)
    ref = load("resource_table")
    same_fields(port.rows(result), ref.run(),
                ("fus", "dsp", "wires", "cfg_bytes", "depth", "fmax",
                 "paper_direct_par", "paper_direct_fmax"))
    assert port.PAPER_DIRECT == ref.PAPER_DIRECT
    assert port.check_gate(result) == []
    for row in result["rows"]:
        assert row["bit_exact"] and row["exec_items_per_s"] > 0
        assert row["modelled_items_per_s"] == row["replicas"] * 300e6


def test_overlay_exec_perf_holds_executor_and_plain_version(monkeypatch):
    """Both CPU legs bit for bit against the reference's ``run_reference``
    (the reference's own benchmark runs the Pallas executor); the compiled
    leg's ``torch.compile`` is replaced by the eager program here."""
    port = load("torch_overlay_exec_perf")
    compiled = []

    def eager(dfg):
        compiled.append(dfg.name)
        return lambda *vs: tuple(dfg.evaluate(list(vs)))
    monkeypatch.setattr(port.port_bench, "compile_dfg", eager)
    result = port.bench("cpu", items=(N, N + 3), reps=2)
    assert port.check_gate(result) == []
    assert [(c["kernel"], c["items"]) for c in result["cells"]] == [
        (k, n) for k in port.KERNELS for n in (N, N + 3)]
    assert compiled == [k for k in port.KERNELS for _ in range(2)]
    for c in result["cells"]:
        ck = R.jit.jit_compile(R.BENCHMARKS[c["kernel"]][0], R.OverlaySpec())
        assert c["model_gops"] == ck.throughput_gops()
        assert c["ops_per_item"] == len(ck.dfg.op_nodes())
        assert c["bit_exact"] == {"executor": True, "plain": True}
        assert all(c[f"{k}_ms"] > 0 for k in ("executor", "plain",
                                                "compiled"))
    names = [r["name"] for r in port.rows(result)]
    assert names == [f"overlay_exec/{c['kernel']}@{c['items']}"
                     for c in result["cells"]]


def test_overlay_exec_cell_is_the_reference_program():
    """The plain version the suite times gives the reference compiler's
    ``run_reference`` on the suite's inputs."""
    sys.path.insert(0, str(BENCH))
    import port_bench
    from repro_torch.kernels.overlay_exec import ops, ref
    port = load("torch_overlay_exec_perf")
    x = np.linspace(-1, 1, N).astype(np.float32)
    for name in port.KERNELS:
        ck_t = port.jit_compile(port.BENCHMARKS[name][0], port.OverlaySpec())
        ck_r = R.jit.jit_compile(R.BENCHMARKS[name][0], R.OverlaySpec())
        image = ops.load_image(ck_t.program, "cpu")
        xs = port_bench.stacked([x] * len(ck_t.dfg.inputs), "cpu")
        got = ref.execute_image(image.instrs, image.imms, image.n_regs, xs,
                                image.n_out)
        want = ck_r.run_reference(*([x] * len(ck_r.dfg.inputs)))
        for j, w in enumerate(want if isinstance(want, tuple) else [want]):
            assert_same_bits(got[j].numpy(), w)


@pytest.mark.parametrize("name", ["replication_scaling", "par_time",
                                  "resource_table", "overlay_exec_perf"])
def test_paper_suite_csv_rows_are_well_formed(name, replication,
                                             monkeypatch):
    """Every suite's rows carry the harness's three keys and a positive
    time, so ``torch_run.py`` prints them as the reference's CSV."""
    if name == "replication_scaling":
        out = load("torch_replication_scaling").rows(replication)
    elif name == "resource_table":
        mod = load("torch_resource_table")
        out = mod.rows(mod.bench("cpu", items=64))
    elif name == "par_time":
        mod = load("torch_par_time")
        stub = dict(first_ms=1.0, warm_ms=0.5, compile_ms=0.5)
        out = mod.rows(mod.bench("cpu", recompile=lambda *a: stub))
    else:
        mod = load("torch_overlay_exec_perf")
        monkeypatch.setattr(mod.port_bench, "compile_dfg", lambda dfg: (
            lambda *vs: tuple(dfg.evaluate(list(vs)))))
        out = mod.rows(mod.bench("cpu", items=(64,), reps=1))
    assert out and all(set(r) == {"name", "us_per_call", "derived"}
                       and r["us_per_call"] > 0
                       and re.fullmatch(r"[a-z_]+/\S+", r["name"])
                       for r in out)


@gpu
def test_paper_suites_run_on_the_card():
    """Fig. 6, Fig. 7, Table III and the executor suite's ``run`` on the
    card: no gate fails, every launch bit-exact."""
    for name in ("torch_replication_scaling", "torch_par_time",
                 "torch_resource_table", "torch_overlay_exec_perf"):
        result = load(name).run("cuda")
        assert result["gate_failures"] == [], name
        assert result["card"] != "cpu (no card)"
