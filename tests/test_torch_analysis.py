"""The port's static verifier (`repro_torch.analysis`) against `repro`'s.

Every claim of ``tests/test_analysis.py`` runs through both packages on the
same inputs: each seeded defect gives the same diagnostics (code, severity,
span, message) in both, every paper artifact re-proves with zero findings
in both (the A208 repack included), the ``verify_level`` gate books,
rejects and quarantines the same way, the CLI returns the same exit codes
and JSON, and the port's code registry is the table of
``docs/diagnostics.md``.  Texts that name the package differ only in that
name (``repro_torch`` for ``repro``), and are compared with it mapped back.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch  # noqa: F401 - read by the gpu skipif condition

from torch_runtime_pair import R, T, assert_same_bits, both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every code exercised by a seeded-defect test in this file; the registry
# test at the bottom asserts nothing documented goes untested
SEEDED = set()


def seeded(*codes):
    SEEDED.update(codes)
    return set(codes)


def record(diags):
    """What a finding says, comparable across the two packages."""
    return [(d.code, d.severity, dataclasses.astuple(d.span), d.message)
            for d in diags]


def unport(text: str) -> str:
    return text.replace("repro_torch", "repro")


def same_findings(scenario, *codes):
    """Run ``scenario(pkg) -> diagnostics`` in both packages: the same
    records, holding at least ``codes``.  Returns the port's."""
    r, t = both(scenario)
    assert record(t) == record(r)
    assert seeded(*codes) <= {d.code for d in t}
    return t


def spec(pkg):
    return pkg.OverlaySpec(width=8, height=8, dsp_per_fu=2)


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


# ------------------------------------------------------------- DFG seeds

def clean_dfg(pkg, name="k"):
    g = pkg.dfg.DFG(name)
    a = g.add("input", name="a")
    b = g.add("input", name="b")
    m = g.add("mul", (a, b))
    s = g.add("add", (m, a))
    g.add("output", (s,), name="O0")
    return g, a, b, m, s


def test_clean_dfg_has_no_findings():
    for pkg in (R, T):
        g, *_ = clean_dfg(pkg)
        assert pkg.analysis.check_dfg(g) == []
        assert pkg.analysis.assert_clean(g) == []


def test_a001_undefined_producer():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.nodes[s].args = (m, 999)
        with pytest.raises(pkg.analysis.VerificationError) as ei:
            pkg.analysis.assert_clean(g, origin="test")
        assert "A001" in str(ei.value)
        return ei.value.diagnostics
    assert same_findings(scenario, "A001")


def test_a002_dead_node_is_a_warning_with_fixit():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.add("abs", (m,))
        pkg.analysis.assert_clean(g)          # warnings do not raise
        return pkg.analysis.check_dfg(g)
    r, t = both(scenario)
    assert record(t) == record(r)
    ds = [d for d in t if d.code in seeded("A002")]
    assert ds and all(d.severity == T.analysis.WARNING for d in ds)
    assert "dce" in ds[0].fixit
    assert [unport(d.fixit) for d in t] == [d.fixit for d in r]


def test_a003_dangling_io():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.inputs.remove(a)
        g.outputs.append(m)
        return pkg.analysis.check_dfg(g)
    same_findings(scenario, "A003")


def test_a004_arity_and_unknown_op():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.nodes[m].args = (a,)
        g.nodes[s].op = "frobnicate"
        return pkg.analysis.check_dfg(g)
    same_findings(scenario, "A004")


def test_a005_cycle():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.nodes[m].args = (a, s)
        return pkg.analysis.check_dfg(g)
    same_findings(scenario, "A005")


def test_a006_imm_misuse():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.nodes[s].op, g.nodes[s].args, g.nodes[s].imm = "abs", (m,), 3.0
        c = g.add("const", imm=1.0)
        g.nodes[c].imm = None
        return pkg.analysis.check_dfg(g)
    same_findings(scenario, "A006")


# ----------------------------------------------------------- graph seeds

def unary_dfg(pkg, name):
    g = pkg.dfg.DFG(name)
    a = g.add("input", name="x")
    m = g.add("mul", (a, a))
    g.add("output", (m,), name="O0")
    return g


def capture_pair(pkg, name="tg"):
    """Two chained unary kernels recorded without a Session; distinct
    seeds make the cut one node per partition."""
    g = pkg.graph.KernelGraph(name, lower=lambda s, o, n: s)
    x = g.input("x")
    t = g.call(unary_dfg(pkg, "k1"), pkg.CompileOptions(seed=0), x)
    g.call(unary_dfg(pkg, "k2"), pkg.CompileOptions(seed=1), t)
    g.freeze()
    return g


def buffer(pkg, g, kind, **kw):
    return pkg.graph.GraphBuffer(g, kind, **kw)


def cut(pkg, g):
    return pkg.graph.partition_graph(g, spec(pkg))


def test_clean_graph_and_cut_have_no_findings():
    for pkg in (R, T):
        g = capture_pair(pkg)
        assert pkg.analysis.check_graph(g) == []
        assert pkg.analysis.check_partitions(g, cut(pkg, g)) == []


def graph_seed(mutate):
    def scenario(pkg):
        g = capture_pair(pkg)
        mutate(pkg, g)
        return pkg.analysis.check_graph(g)
    return scenario


@pytest.mark.parametrize("reader,src", [(0, 1), (1, 99)],
                         ids=["later-producer", "unknown-producer"])
def test_a101_use_before_def(reader, src):
    def mutate(pkg, g):
        g.nodes[reader].args = (buffer(pkg, g, "node", nid=src, out_idx=0),)
    same_findings(graph_seed(mutate), "A101")


def test_a102_duplicate_nid():
    def mutate(pkg, g):
        g.nodes[1].nid = 0
    same_findings(graph_seed(mutate), "A102")


def test_a103_input_range():
    def mutate(pkg, g):
        g.nodes[0].args = (buffer(pkg, g, "in", index=5),)
    same_findings(graph_seed(mutate), "A103")


def test_a104_dangling_graph_output():
    def mutate(pkg, g):
        g.outputs = [buffer(pkg, g, "node", nid=99, out_idx=0)]
    same_findings(graph_seed(mutate), "A104")


def cut_seed(mutate):
    def scenario(pkg):
        g = capture_pair(pkg)
        parts = cut(pkg, g)
        assert len(parts) == 2 and parts[1].deps == [0]
        mutate(parts)
        return pkg.analysis.check_partitions(g, parts)
    return scenario


def test_a105_missing_partition_dep():
    def mutate(parts):
        parts[1].deps = []
    same_findings(cut_seed(mutate), "A105")


@pytest.mark.parametrize("owners", [(0, []), (1, [0, 1])],
                         ids=["unassigned", "assigned-twice"])
def test_a106_partition_coverage(owners):
    def mutate(parts):
        parts[owners[0]].node_ids = list(owners[1])
    same_findings(cut_seed(mutate), "A106")


@pytest.mark.parametrize("deps", [[0], [99], [1]],
                         ids=["self", "nonexistent", "forward"])
def test_a107_partition_order(deps):
    def mutate(parts):
        parts[0].deps = list(deps)
    same_findings(cut_seed(mutate), "A107")


@pytest.mark.parametrize("ext", [[("node", 0, 0), ("node", 0, 0)],
                                 [("node", 1, 0)]],
                         ids=["two-slots", "feeds-itself"])
def test_a108_illegal_alias(ext):
    def mutate(parts):
        parts[1].ext = list(ext)
    same_findings(cut_seed(mutate), "A108")


@pytest.mark.parametrize("outputs", [[], [(0, 0)]],
                         ids=["dropped", "non-member"])
def test_a109_fused_io_mismatch(outputs):
    def mutate(parts):
        parts[1].outputs = list(outputs)
    same_findings(cut_seed(mutate), "A109")


# -------------------------------------------------------- artifact seeds

@pytest.fixture(scope="module")
def artifacts():
    """Every paper-suite benchmark compiled at its paper replica count, in
    each package: {root: {name: CompiledKernel}}."""
    return {pkg.root: {name: pkg.jit.jit_compile(
        src, spec(pkg), opts=pkg.CompileOptions(max_replicas=reps))
        for name, (src, reps, _oracle) in pkg.BENCHMARKS.items()}
        for pkg in (R, T)}


@pytest.mark.parametrize("name", sorted(R.BENCHMARKS))
def test_every_benchmark_artifact_reproves_bit_identically(artifacts, name):
    """Zero findings in both packages, A208's repack of the port's own
    packer included, on artifacts whose bitstreams are byte-identical."""
    r, t = artifacts["repro"][name], artifacts["repro_torch"][name]
    assert t.bitstream.data == r.bitstream.data
    assert T.analysis.verify_artifact(t) == []
    assert R.analysis.verify_artifact(r) == []
    assert T.analysis.assert_valid(t) == []


def artifact_seed(artifacts, mutate, name="poly1"):
    def scenario(pkg):
        ck = copy.deepcopy(artifacts[pkg.root][name])
        mutate(pkg, ck)
        return pkg.analysis.verify_artifact(ck)
    return scenario


def test_a201_placement_illegal(artifacts):
    def mutate(pkg, ck):
        ck.placement.fu_pos[next(iter(ck.placement.fu_pos))] = (99, 99)
        with pytest.raises(pkg.analysis.VerificationError):
            pkg.analysis.assert_valid(ck)
    same_findings(artifact_seed(artifacts, mutate), "A201")


def test_a202_pad_overuse(artifacts):
    def mutate(pkg, ck):
        ck.placement.in_pos[next(iter(ck.placement.in_pos))] = (0, 0)
    same_findings(artifact_seed(artifacts, mutate), "A202")


@pytest.mark.parametrize("how", ["bogus-hop", "dropped-net"])
def test_a203_route_discontinuity(artifacts, how):
    def mutate(pkg, ck):
        if how == "bogus-hop":
            ck.routing.nets[0].path.insert(1, (99, 99))
        else:
            del ck.routing.nets[0]
    same_findings(artifact_seed(artifacts, mutate), "A203")


def test_a204_channel_overuse(artifacts):
    def mutate(pkg, ck):
        net = next(n for n in ck.routing.nets if len(n.path) >= 2)
        for i in range(ck.spec.channel_width + 1):
            f = copy.deepcopy(net)
            f.src = (90 + i, 0)
            f.path = [net.path[0], net.path[1]]
            ck.routing.nets.append(f)
    same_findings(artifact_seed(artifacts, mutate), "A204")


def test_a205_latency_misalign(artifacts):
    def mutate(pkg, ck):
        ck.latency.ready[next(iter(ck.latency.ready))] += 1
    same_findings(artifact_seed(artifacts, mutate), "A205")


def test_a206_delay_capacity(artifacts):
    def mutate(pkg, ck):
        assert ck.latency.delays, "poly1 should have delay chains"
        ck.latency.delays[next(iter(ck.latency.delays))] = \
            ck.spec.max_delay + 7
    same_findings(artifact_seed(artifacts, mutate), "A206")


def test_a207_ledger_mismatch(artifacts):
    def mutate(pkg, ck):
        ck.plan = dataclasses.replace(ck.plan, fus_used=ck.plan.fus_used + 1)
    same_findings(artifact_seed(artifacts, mutate), "A207")


def test_a208_bitstream_mismatch(artifacts):
    def mutate(pkg, ck):
        body = bytearray(ck.bitstream.data)
        body[-1] ^= 0xFF
        ck.bitstream = dataclasses.replace(ck.bitstream, data=bytes(body))
    same_findings(artifact_seed(artifacts, mutate), "A208")


# --------------------------------------------- verify_level jit integration

def test_verify_level_validation_and_cache_key():
    for pkg in (R, T):
        with pytest.raises(ValueError):
            pkg.CompileOptions(verify_level="paranoid")
    tails = {(pkg.root, level):
             pkg.CompileOptions(verify_level=level).key_tail()
             for pkg in (R, T) for level in ("off", "fused", "full")}
    assert len(set(tails.values())) == 1


@pytest.mark.parametrize("level", ["off", "fused", "full"])
def test_verify_levels_build_and_book_time(level):
    """A verify stage is booked only when a level is on, and verification
    changes no byte of the artifact."""
    def build(pkg, verify_level):
        src, reps, _ = pkg.BENCHMARKS["poly2"]
        return pkg.jit.jit_compile(src, spec(pkg), opts=pkg.CompileOptions(
            max_replicas=reps, verify_level=verify_level),
            cache=pkg.JITCache())
    r, t = both(build, level)
    off = build(T, "off")
    for ck in (r, t):
        if level == "off":
            assert "verify" not in ck.stage_times_ms
        else:
            assert ck.stage_times_ms["verify"] >= 0.0
    assert t.bitstream.data == r.bitstream.data == off.bitstream.data
    assert t.program.content_hash() == off.program.content_hash()


def test_fused_gate_rejects_corrupt_dfg():
    def scenario(pkg):
        src, reps, _ = pkg.BENCHMARKS["poly1"]
        ck = pkg.jit.jit_compile(src, spec(pkg),
                                 opts=pkg.CompileOptions(max_replicas=reps))
        g = ck.dfg.copy()
        g.nodes[g.outputs[0]].args = (9999,)
        g.optimized = True
        with pytest.raises(pkg.analysis.VerificationError) as ei:
            pkg.jit.jit_compile(g, spec(pkg), opts=pkg.CompileOptions(
                max_replicas=reps, verify_level="fused"),
                cache=pkg.JITCache())
        return ei.value.diagnostics
    same_findings(scenario, "A001")


def test_full_hit_quarantines_corrupted_cache_entry():
    """A hit whose routing was corrupted in memory is quarantined, counted
    the same in both packages, and rebuilt into an artifact that
    re-proves."""
    def scenario(pkg):
        src, reps, _ = pkg.BENCHMARKS["poly1"]
        cache = pkg.JITCache()
        opts = pkg.CompileOptions(max_replicas=reps, verify_level="full")
        ck = pkg.jit.jit_compile(src, spec(pkg), opts=opts, cache=cache)
        assert pkg.jit.jit_compile(src, spec(pkg), opts=opts,
                                   cache=cache) is ck
        ck.routing.nets[0].path.insert(1, (99, 99))
        ck2 = pkg.jit.jit_compile(src, spec(pkg), opts=opts, cache=cache)
        assert ck2 is not ck
        assert pkg.analysis.verify_artifact(ck2) == []
        return cache.stats.as_dict(), ck2.bitstream.data
    r, t = both(scenario)
    assert t == r
    assert t[0]["verify_quarantined"] == 1


def quarantine_in_a_session(pkg, device="cpu"):
    """A "full" Session build whose cached artifact is corrupted in memory
    after its first launch: the next build of the same kernel quarantines
    it, rebuilds, and the new Program launches on an image of the new
    artifact."""
    x = np.linspace(-2, 2, 4096).astype(np.float32)
    src, reps, _ = pkg.BENCHMARKS["poly1"]
    opts = pkg.CompileOptions(max_replicas=reps, verify_level="full")
    kw = {"device": device} if pkg.is_port else {}
    with pkg.session.Session([pkg.Device("a", spec(pkg))], max_workers=1,
                             **kw) as sess:
        first = sess.build(src, opts)
        sess.enqueue(first, x).wait()
        ck = first.compiled
        ck.routing.nets[0].path.insert(1, (99, 99))
        first.release()
        prog = sess.build(src, opts)
        assert prog.compiled is not ck
        assert pkg.analysis.verify_artifact(prog.compiled) == []
        out = sess.enqueue(prog, x).wait()[0]
        if pkg.is_port:
            (img_ck, _img), = prog._images.values()
            assert img_ck is prog.compiled
            assert out.data.device.type == torch.device(device).type
        assert_same_bits(np.asarray(out.read(), np.float32),
                         prog.compiled.run_reference(x))
        return (sess.cache.stats.as_dict(),
                np.asarray(out.read(), np.float32).tobytes())


def test_session_rebuilds_a_quarantined_full_hit():
    r, t = both(quarantine_in_a_session)
    assert t == r
    assert t[0]["verify_quarantined"] == 1


@gpu
def test_session_rebuilds_a_quarantined_full_hit_on_the_card():
    stats, _ = quarantine_in_a_session(T, "cuda")
    assert stats["verify_quarantined"] == 1


@gpu
@pytest.mark.parametrize("level", ["fused", "full"])
def test_verified_artifacts_run_bit_exact_on_the_card(level):
    """The paper's six kernels on both overlays, built through a Session
    at a verifying level, launched on the card against run_reference."""
    rng = np.random.default_rng(0)
    pool = [rng.uniform(-1, 1, 1 << 16).astype(np.float32)
            for _ in range(4)]
    for dims in ((8, 8, 2), (32, 8, 2)):
        with T.session.Session([T.Device("a", T.spec(*dims))]) as sess:
            for src, _, _ in T.BENCHMARKS.values():
                prog = sess.build(src, T.CompileOptions(verify_level=level))
                args = pool[:len(prog.compiled.dfg.inputs)]
                out = sess.enqueue(prog, *args).wait()[0]
                assert out.data.device.type == "cuda"
                assert "verify" in prog.compiled.stage_times_ms
                assert_same_bits(out.data.cpu(),
                                 prog.compiled.run_reference(*args))
                prog.release()


@gpu
def test_verifying_graph_runs_and_refuses_an_alias_on_the_card():
    x = np.linspace(-2, 2, 1 << 16).astype(np.float32)
    opts = T.CompileOptions(n_inputs=1, verify_level="fused")
    with T.session.Session([T.Device("a", spec(T))]) as sess:
        with sess.capture(name="v") as g:
            t = g.call(lambda v: v + 1.0, opts, g.input())
            g.call(lambda v: v * v - 0.5, opts, t)
        gx = sess.instantiate(g)
        fused = sess.launch(gx, x).wait()[0].data
        nodewise = sess.launch_nodewise(g, x).wait()[0].data
        assert fused.device.type == "cuda"
        assert torch.equal(fused.view(torch.int32),
                           nodewise.view(torch.int32))
        bad = copy.deepcopy(sess.graph_plan(g))
        bad[0].ext = bad[0].ext * 2
        with pytest.raises(T.analysis.VerificationError):
            sess.instantiate(g, plan=bad)


# ------------------------------------------------------------ pass manager

def test_pass_manager_crash_becomes_a901():
    def scenario(pkg):
        an = pkg.analysis
        report = an.PassManager([an.Pass("boom", lambda t: 1 / 0)]).run(
            [an.Target("t0", "dfg", object())])
        assert not report.ok and report.targets_analyzed == 1
        return report.diagnostics
    r, t = both(scenario)
    # the message ends in the traceback, whose paths name the package
    first = [(c, s, sp, m.split("\n")[0]) for c, s, sp, m in record(t)]
    assert first == [(c, s, sp, m.split("\n")[0]) for c, s, sp, m in
                     record(r)]
    assert seeded("A901") <= {d.code for d in t}


def test_report_json_roundtrip_and_gate():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.nodes[s].args = (m, 999)
        rep = pkg.analysis.Report(pkg.analysis.check_dfg(g),
                                  targets_analyzed=1)
        clean = pkg.analysis.Report([], targets_analyzed=1)
        assert not rep.ok and clean.ok and clean.counts()["error"] == 0
        return rep.to_json()
    r, t = both(scenario)
    assert t == r
    doc = json.loads(t)
    assert doc["counts"]["error"] >= 1
    assert doc["diagnostics"][0]["code"] == "A001"


def test_severity_filter_orders_errors_first():
    def scenario(pkg):
        g, a, b, m, s = clean_dfg(pkg)
        g.add("abs", (m,))
        g.nodes[s].args = (m, 999)
        rep = pkg.analysis.Report(pkg.analysis.check_dfg(g),
                                  targets_analyzed=1)
        assert all(d.severity == pkg.analysis.ERROR for d in rep.errors())
        return rep.filtered("warning")
    r, t = both(scenario)
    assert record(t) == record(r)
    sevs = [d.severity for d in t]
    assert sevs == sorted(sevs, key=("error", "warning", "info").index)


# --------------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv", [["dfgs", "graphs", "locklint"],
                                  ["--verify"]],
                         ids=["default-suites", "verify"])
def test_cli_clean_run_and_json(tmp_path, argv):
    """Both CLIs return 0 and the same report; the port's sweep holds the
    model and serve stage kernels (imported unconditionally)."""
    def run(pkg):
        out = tmp_path / f"{pkg.root}.json"
        assert pkg.cli.main(argv + ["--json", str(out)]) == 0
        return json.loads(out.read_text())
    r, t = both(run)
    assert t == r
    assert t["counts"]["error"] == 0 and t["targets_analyzed"] > 0
    from repro_torch.models.overlay_ops import KERNELS
    from repro_torch.serve.models import STAGE_KERNELS
    swept = {f"models:{k}" for k in KERNELS} | \
        {f"serve:{k}" for k in STAGE_KERNELS}
    assert swept <= {tg.name for tg in T.cli._dfg_targets()}


def test_cli_exit_code_and_json_on_findings(tmp_path):
    """A lint target that does not parse is an error: exit 1, the same
    report from both."""
    (tmp_path / "broken.py").write_text("def f(:\n")

    def run(pkg):
        out = tmp_path / f"{pkg.root}.json"
        rc = pkg.cli.main(["broken.py", "--root", str(tmp_path),
                           "--json", str(out)])
        return rc, json.loads(out.read_text())
    r, t = both(run)
    assert t == r
    assert t[0] == 1 and t[1]["diagnostics"][0]["code"] == "A302"


def test_cli_list_codes_mentions_docs(capsys):
    outs = {}
    for pkg in (R, T):
        assert pkg.cli.main(["--list-codes"]) == 0
        outs[pkg.root] = capsys.readouterr().out
    for code in T.analysis.CODES:
        assert code in outs["repro_torch"]
    assert "docs/diagnostics.md" in outs["repro_torch"]
    assert unport(outs["repro_torch"]) == outs["repro"]


def test_cli_rejects_unknown_suite():
    for pkg in (R, T):
        with pytest.raises(SystemExit):
            pkg.cli.main(["no-such-suite-or-path"])


# ------------------------------------------------------------- docs sync

def test_docs_table_matches_code_registry():
    """The port shares ``docs/diagnostics.md`` unedited: its registry is
    that table, a fix that names the package naming the port's."""
    rows = {}
    path = os.path.join(REPO, "docs", "diagnostics.md")
    for line in open(path, encoding="utf-8"):
        if line.startswith("| A"):
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            rows[cells[0]] = cells
    assert set(rows) == set(T.analysis.CODES) == set(R.analysis.CODES)
    for code, info in T.analysis.CODES.items():
        assert rows[code][1:4] == [info.severity, info.title, info.meaning]
        assert rows[code][4] == unport(info.fix)


def test_every_documented_code_has_a_seeded_defect_test():
    missing = set(T.analysis.CODES) - SEEDED - {"A301", "A302"}
    assert not missing, missing          # A3xx: test_torch_locklint.py


# ------------------------------------------------- hypothesis properties

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

MUTATIONS = [("missing_arg", "A001"), ("bad_arity", "A004"),
             ("unknown_op", "A004"), ("imm_misuse", "A006"),
             ("off_perimeter", "A003")]

if HAVE_HYPOTHESIS:
    def chain_dfg(pkg, ops):
        g = pkg.dfg.DFG("prop")
        a = g.add("input", name="a")
        b = g.add("input", name="b")
        cur = a
        for op in ops:
            cur = g.add(op, (cur, b))
        g.add("output", (cur,), name="O0")
        return g

    @given(st.lists(st.sampled_from(["add", "mul", "sub", "max"]),
                    min_size=1, max_size=6), st.data())
    @settings(max_examples=60, deadline=None)
    def test_prop_mutated_dfg_fires_matching_code(ops, data):
        mutation, code = data.draw(st.sampled_from(MUTATIONS))
        pick = data.draw(st.integers(0, len(ops) - 1))

        def scenario(pkg):
            g = chain_dfg(pkg, ops)
            assert pkg.analysis.check_dfg(g) == []
            victim = [n for n in g.nodes.values()
                      if n.op not in ("input", "output", "const")][pick]
            if mutation == "missing_arg":
                victim.args = tuple(list(victim.args[:-1]) + [12345])
            elif mutation == "bad_arity":
                victim.args = victim.args[:-1]
            elif mutation == "unknown_op":
                victim.op = "bogus"
            elif mutation == "imm_misuse":
                victim.op, victim.args, victim.imm = \
                    "abs", victim.args[:1], 1.5
            else:
                g.inputs.pop()
            return pkg.analysis.check_dfg(g)
        r, t = both(scenario)
        assert record(t) == record(r)
        assert code in {d.code for d in t}

    @given(st.integers(0, 10_000), st.integers(1, 3))
    @settings(max_examples=8, deadline=None)
    def test_prop_full_verify_rejects_any_routing_corruption(seed_idx, bump):
        """A bogus hop spliced into any net: the same errors in both."""
        def scenario(pkg):
            ck = copy.deepcopy(_poly1_artifact(pkg))
            net = ck.routing.nets[seed_idx % len(ck.routing.nets)]
            net.path.insert(min(bump, len(net.path) - 1), (97, 42))
            return [d for d in pkg.analysis.verify_artifact(ck)
                    if d.severity == pkg.analysis.ERROR]
        r, t = both(scenario)
        assert record(t) == record(r)
        assert t and any(d.code in ("A203", "A204", "A205") for d in t)

    _POLY1 = {}

    def _poly1_artifact(pkg):
        if pkg.root not in _POLY1:
            src, reps, _ = pkg.BENCHMARKS["poly1"]
            _POLY1[pkg.root] = pkg.jit.jit_compile(
                src, spec(pkg), opts=pkg.CompileOptions(max_replicas=reps))
        return _POLY1[pkg.root]
