"""The port's paper benchmarks against the reference's.

``benchmarks/torch_graph_replay_perf.py`` and
``benchmarks/torch_reconfig_time.py`` on the CPU (``device="cpu"``: the
executor's plain version) against ``benchmarks/graph_replay_perf.py`` and
the JAX package's compiler.  The graph replay runs in both packages on
Sessions with one build worker and the host clock held at 0 µs (the port's
benchmark does so itself; the reference's is given such a Session here),
so its partitions, configuration charges, compile and re-instantiation
misses and modelled makespans are the queues' model alone and compare
exactly, and its outputs bit for bit.  The reference's reconfiguration
benchmark runs the Pallas executor, so the port's is held against the
reference compiler's artifacts and ``run_reference``.  The benchmarks'
card legs run under the ``gpu`` marker.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch  # noqa: F401 - read by the gpu skipif condition
from torch_runtime_pair import R, assert_same_bits

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


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


@pytest.fixture
def replay(monkeypatch):
    """(reference module, port module), the reference's Sessions on one
    build worker with the host clock held at 0 µs."""
    ref = load("graph_replay_perf")

    class ModelledSession(R.session.Session):
        def __init__(self, *args, **kw):
            kw["max_workers"] = 1
            super().__init__(*args, **kw)

        def now_us(self) -> float:
            return 0.0

    monkeypatch.setattr(ref, "Session", ModelledSession)
    return ref, load("torch_graph_replay_perf")


@pytest.mark.parametrize("mode", ["graph", "nodewise"])
def test_graph_replay_serves_the_reference_trace(replay, mode):
    ref, port = replay
    (r, r_outs), (t, t_outs) = ref._run(mode), port._run(mode, "cpu")
    assert t == r
    assert len(t_outs) == len(r_outs) == ref.N_REQUESTS
    for (tx, ty), (rx, ry) in zip(t_outs, r_outs):
        np.testing.assert_array_equal(tx, rx)
        assert_same_bits(ty, ry)


def test_graph_replay_bench_and_gates_match_the_reference(replay):
    ref, port = replay
    r, t = ref.bench(), port.bench("cpu")
    assert t == r
    assert t["identical_results"] and t["partition_ratio"] == 6.0
    assert t["graph"]["config_charges"] == 1
    assert t["nodewise"]["config_charges"] == len(t["stages"]) * \
        t["requests"]
    assert port.check_gate(t, 1.0) == ref.check_gate(r, 1.0) == []
    out = port.run("cpu")
    assert out["gate_failures"] == [] and out["replay"] == []


def test_reconfig_bench_swaps_the_reference_programs():
    port = load("torch_reconfig_time")
    stub = dict(first_ms=0.0, warm_ms=0.0, compile_ms=0.0)
    compiled = []

    def recompile(dfg, x):
        compiled.append(dfg.name)
        return stub
    result = port.bench("cpu", recompile=recompile)
    assert port.check_gate(result) == []
    assert compiled == ["warmup", *port.NAMES]
    ref = {n: R.jit.jit_compile(R.BENCHMARKS[n][0], R.spec(),
                                opts=R.CompileOptions(max_replicas=1))
           for n in port.NAMES}
    assert result["pad_to"] == max(ck.program.n_instr
                                   for ck in ref.values()) + 8
    assert result["pad_regs"] == max(ck.program.n_regs
                                     for ck in ref.values()) + 3
    x = np.linspace(-1, 1, port.N_ITEMS).astype(np.float32)
    port_cks = port.programs()["cks"]
    for name, row in result["programs"].items():
        ck = ref[name]
        assert (row["n_instr"], row["n_regs"]) == (ck.program.n_instr,
                                                   ck.program.n_regs)
        assert row["config_us_modelled"] == ck.bitstream.load_time_us()
        assert row["bit_exact"] and row["recompile"] == stub
        # what the port's swaps were held against is the reference's
        assert_same_bits(port_cks[name].run_reference(x),
                         ck.run_reference(x))
    assert result["rebuild"] is None


@gpu
def test_paper_benchmarks_run_on_the_card():
    """Both benchmarks' ``run()`` on the card: gates, P against K launches
    per replay, the swap without a rebuild."""
    replay = load("torch_graph_replay_perf").run("cuda")
    assert replay["gate_failures"] == []
    assert [r["items"] for r in replay["replay"]] == [200_000, 1 << 24]
    reconfig = load("torch_reconfig_time").run("cuda")
    assert reconfig["gate_failures"] == []
    assert reconfig["builds_after"] == reconfig["builds_before"] == 1
