"""Command line: ``python -m repro_torch.analysis [targets] [options]``.

Targets are either built-in suite names or paths:

* ``dfgs``      — lower every paper-suite kernel, every model kernel
                  (``models/overlay_ops.KERNELS``) and every serve stage
                  kernel (``serve/models.STAGE_KERNELS``) and run the
                  A0xx semantic checks;
* ``graphs``    — record a multi-stage KernelGraph pipeline, partition it
                  against the default overlay, and run the A1xx
                  race/alias analysis;
* ``locklint``  — run the A3xx lock-discipline lint over the runtime
                  modules (``runtime.py``/``cache.py``/``session.py``/
                  ``queue.py``/``faults.py``/``recovery.py``/
                  ``remote.py``/``serve/*``/``obs/*``);
* ``artifacts`` — JIT-compile the same kernels and re-prove
                  every artifact's legality (A2xx); implied by
                  ``--verify``;
* ``path.py`` / ``dir/`` — extra files for the lock-discipline lint.

With no targets, ``dfgs graphs locklint`` run (everything that does not
need a compile).  Exit status is 1 iff any error-severity diagnostic was
reported — the CI gate.  Every code is documented in
``docs/diagnostics.md`` (``--list-codes`` prints the same table).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .diagnostics import CODES, SEVERITIES
from .passes import Pass, PassManager, Target, kind

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))

SUITES = ("dfgs", "graphs", "locklint", "artifacts")


# ------------------------------------------------------------ the targets

def _traced_kernels():
    """(suite, name, fn, arity) of every model and serve stage kernel: the
    kernels the zoo and the server compile, both always part of the sweep."""
    from repro_torch.models.overlay_ops import KERNELS
    from repro_torch.serve.models import STAGE_KERNELS
    for suite, table in (("models", KERNELS), ("serve", STAGE_KERNELS)):
        for name, (fn, n) in sorted(table.items()):
            yield suite, name, fn, n


def _dfg_targets() -> List[Target]:
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.dfg import trace
    from repro_torch.core.jit import lower_to_dfg

    targets = [Target(f"paper:{name}", "dfg",
                      lower_to_dfg(src, parse_source=True))
               for name, (src, _reps, _fn) in sorted(BENCHMARKS.items())]
    targets += [Target(f"{suite}:{name}", "dfg", trace(fn, n, name))
                for suite, name, fn, n in _traced_kernels()]
    return targets


def _graph_targets() -> List[Target]:
    from repro_torch.configs.paper_suite import CHEBYSHEV, MIBENCH, POLY1
    from repro_torch.core.graph import KernelGraph, partition_graph
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.overlay import OverlaySpec

    opts = CompileOptions()
    g = KernelGraph("cli_pipeline")
    x = g.input("x")
    t = g.call(POLY1, opts, x)
    u = g.call(CHEBYSHEV, opts, t)
    g.call(MIBENCH, opts, t, u)
    g.freeze()
    parts = partition_graph(g, OverlaySpec(width=8, height=8, dsp_per_fu=2))
    return [Target("graph:cli_pipeline", "graph", g),
            Target("graph:cli_pipeline/cut", "partitions", (g, parts))]


def _artifact_targets() -> List[Target]:
    from repro_torch.configs.paper_suite import BENCHMARKS
    from repro_torch.core.jit import jit_compile
    from repro_torch.core.options import CompileOptions
    from repro_torch.core.overlay import OverlaySpec

    spec = OverlaySpec(width=8, height=8, dsp_per_fu=2)
    targets = []
    for name, (src, reps, _fn) in sorted(BENCHMARKS.items()):
        ck = jit_compile(src, spec, opts=CompileOptions(
            name=name, max_replicas=reps))
        targets.append(Target(f"artifact:{name}", "artifact", ck))
    for suite, name, fn, n in _traced_kernels():
        ck = jit_compile(fn, spec, opts=CompileOptions(
            n_inputs=n, name=name, max_replicas=1, place_effort=0.25))
        targets.append(Target(f"artifact:{suite}:{name}", "artifact", ck))
    return targets


def _passes() -> List[Pass]:
    from .artifact import verify_artifact
    from .dfg_checks import check_dfg
    from .graph_checks import check_graph, check_partitions
    return [
        Pass("dfg-checks", check_dfg, kind("dfg")),
        Pass("graph-checks", check_graph, kind("graph")),
        Pass("partition-checks", lambda t: check_partitions(*t),
             kind("partitions")),
        Pass("artifact-verify", verify_artifact, kind("artifact")),
    ]


def _codes_table() -> str:
    rows = [(c.code, c.severity, c.title, c.meaning)
            for c in CODES.values()]
    lines = [f"{'code':<6} {'severity':<8} {'title':<24} meaning",
             "-" * 78]
    for code, sev, title, meaning in sorted(rows):
        lines.append(f"{code:<6} {sev:<8} {title:<24} {meaning}")
    lines.append("")
    lines.append("Full table with fixes: docs/diagnostics.md")
    return "\n".join(lines)


# --------------------------------------------------------------- entry point

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verifier for the overlay JIT pipeline: DFG "
                    "semantics (A0xx), graph race/alias analysis (A1xx), "
                    "artifact legality re-proof (A2xx) and lock-discipline "
                    "lint (A3xx).",
        epilog="Every diagnostic code is documented in docs/diagnostics.md "
               "(code, severity, meaning, fix); --list-codes prints the "
               "same table.")
    ap.add_argument("targets", nargs="*",
                    help=f"built-in suites ({', '.join(SUITES)}) and/or "
                         f".py files / directories for the lock lint; "
                         f"default: dfgs graphs locklint")
    ap.add_argument("--json", nargs="?", const="-", metavar="PATH",
                    help="emit the report as JSON to PATH (default: "
                         "stdout)")
    ap.add_argument("--verify", action="store_true",
                    help="also compile the benchmark kernels and re-prove "
                         "every artifact (adds the 'artifacts' suite)")
    ap.add_argument("--min-severity", choices=SEVERITIES, default="info",
                    help="hide diagnostics below this severity in the "
                         "output (the exit code always gates on errors)")
    ap.add_argument("--list-codes", action="store_true",
                    help="print the diagnostic-code table and exit")
    ap.add_argument("--root", default=_REPO_ROOT,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.list_codes:
        print(_codes_table())
        return 0

    suites = [t for t in args.targets if t in SUITES]
    paths = [t for t in args.targets if t not in SUITES]
    bad = [p for p in paths
           if not os.path.exists(p if os.path.isabs(p)
                                 else os.path.join(args.root, p))]
    if bad:
        ap.error(f"unknown suite or missing path: {', '.join(bad)} "
                 f"(suites: {', '.join(SUITES)})")
    if not suites and not paths:
        suites = ["dfgs", "graphs", "locklint"]
    if args.verify and "artifacts" not in suites:
        suites.append("artifacts")

    targets: List[Target] = []
    if "dfgs" in suites:
        targets += _dfg_targets()
    if "graphs" in suites:
        targets += _graph_targets()
    if "artifacts" in suites:
        targets += _artifact_targets()

    report = PassManager(_passes()).run(targets)

    lint_paths: List[str] = []
    if "locklint" in suites:
        from .locklint import DEFAULT_TARGETS
        lint_paths += list(DEFAULT_TARGETS)
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(args.root, p)
        if os.path.isdir(full):
            for dirpath, _dirs, files in os.walk(full):
                lint_paths += [os.path.join(dirpath, f)
                               for f in sorted(files) if f.endswith(".py")]
        else:
            lint_paths.append(full)
    if lint_paths:
        from .locklint import lint_files
        report.extend(lint_files(lint_paths, root=args.root))
        report.targets_analyzed += len(lint_paths)

    if args.json is not None:
        text = report.to_json(args.min_severity)
        if args.json == "-":
            print(text)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(text + "\n")
    else:
        for d in report.filtered(args.min_severity):
            print(d)
    counts = report.counts()
    print(f"repro_torch.analysis: {report.targets_analyzed} target(s), "
          f"{counts['error']} error(s), {counts['warning']} warning(s), "
          f"{counts['info']} info", file=sys.stderr)
    return 0 if report.ok else 1
