"""Structured diagnostics for the static verifier.

Every pass in :mod:`repro_torch.analysis` reports findings as
:class:`Diagnostic` values — ``(code, severity, span, message, fixit)`` —
instead of raising on first error the way ``DFG.validate`` /
``KernelGraph.validate`` do.  A diagnostic is JSON-serializable
(:meth:`Diagnostic.to_dict`), carries a stable machine-readable ``code``
(``A0xx`` DFG semantics, ``A1xx`` graph/partition analysis, ``A2xx``
artifact legality, ``A3xx`` lock discipline — the full table lives in
``docs/diagnostics.md``), and where a mechanical fix exists, says what it
is (``fixit``).

The :data:`CODES` registry is the single source of truth for the code
table: the CLI's ``--list-codes``, the docs page, and the
docs-stay-in-sync test all read it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple

# severity levels, most severe first (order matters for reports/filters)
ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


class VerificationError(RuntimeError):
    """An analysis pass run as a *gate* (``CompileOptions.verify_level``,
    ``fuse_dfgs`` auto-checks, ``Session.instantiate``) found error-severity
    diagnostics.  Carries them on ``.diagnostics``."""

    def __init__(self, message: str, diagnostics: Iterable["Diagnostic"] = ()):
        super().__init__(message)
        self.diagnostics: List[Diagnostic] = list(diagnostics)


@dataclasses.dataclass(frozen=True)
class Span:
    """Where a diagnostic points.  For file-based passes (locklint) that is
    ``file:line:col``; for IR-based passes ``target`` names the object
    (kernel / graph / artifact) and ``node`` the offending node id."""
    target: str = ""                 # kernel/graph/artifact/file name
    node: Optional[str] = None       # node id / attribute / net id
    file: Optional[str] = None
    line: Optional[int] = None
    col: Optional[int] = None

    def __str__(self) -> str:
        if self.file is not None:
            loc = f"{self.file}:{self.line}" if self.line is not None \
                else self.file
            return f"{loc}:{self.col}" if self.col is not None else loc
        return f"{self.target}:{self.node}" if self.node is not None \
            else self.target


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str                    # error | warning | info
    span: Span
    message: str
    fixit: Optional[str] = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_dict(self) -> dict:
        d = dict(code=self.code, severity=self.severity,
                 span=dataclasses.asdict(self.span), message=self.message)
        if self.fixit is not None:
            d["fixit"] = self.fixit
        return d

    def __str__(self) -> str:
        fix = f"  [fix: {self.fixit}]" if self.fixit else ""
        return f"{self.span}: {self.severity} {self.code}: {self.message}{fix}"


def diag(code: str, span: Span, message: str,
         fixit: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic with the registry's default severity for ``code``
    (every emitter goes through here, so a code's severity has ONE home)."""
    meta = CODES.get(code)
    sev = meta.severity if meta is not None else ERROR
    return Diagnostic(code, sev, span, message, fixit)


class Report:
    """A collection of diagnostics plus the JSON/exit-code plumbing the CLI
    and the CI gate consume."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = (),
                 targets_analyzed: int = 0):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        self.targets_analyzed = targets_analyzed

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def ok(self) -> bool:
        """The CI gate: zero error-severity diagnostics."""
        return not self.errors()

    def filtered(self, min_severity: str = INFO) -> List[Diagnostic]:
        cut = _SEV_RANK[min_severity]
        return sorted((d for d in self.diagnostics
                       if _SEV_RANK[d.severity] <= cut),
                      key=lambda d: (_SEV_RANK[d.severity], d.code,
                                     str(d.span)))

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            c[d.severity] += 1
        return c

    def to_dict(self, min_severity: str = INFO) -> dict:
        return dict(targets_analyzed=self.targets_analyzed,
                    counts=self.counts(), ok=self.ok,
                    diagnostics=[d.to_dict()
                                 for d in self.filtered(min_severity)])

    def to_json(self, min_severity: str = INFO, indent: int = 1) -> str:
        return json.dumps(self.to_dict(min_severity), indent=indent)


# ============================================================= code registry

@dataclasses.dataclass(frozen=True)
class CodeInfo:
    code: str
    severity: str
    title: str                       # short name, stable
    meaning: str                     # what the finding means
    fix: str                         # how to fix it


def _c(code: str, severity: str, title: str, meaning: str,
       fix: str) -> Tuple[str, CodeInfo]:
    return code, CodeInfo(code, severity, title, meaning, fix)


CODES: Dict[str, CodeInfo] = dict([
    # ---- A0xx: DFG semantic checks -------------------------------------
    _c("A001", ERROR, "undefined-producer",
       "A node reads an operand node id that does not exist in the DFG — "
       "the value was never produced (evaluate() would KeyError).",
       "Rewire the consumer to an existing producer, or add the missing "
       "node before it."),
    _c("A002", WARNING, "dead-node",
       "An op node is unreachable from every kernel output; it would "
       "occupy an FU without contributing to any result.",
       "Run repro_torch.core.dfg.dce (or full optimize()) before compiling."),
    _c("A003", ERROR, "dangling-io",
       "The kernel's IO perimeter is inconsistent: an outputs-list entry "
       "is not an 'output' node, or an 'input'/'output' op node is missing "
       "from the inputs/outputs list — a read of a never-written buffer "
       "or a store that never leaves the fabric.",
       "Rebuild the DFG through DFG.add(), which maintains both lists."),
    _c("A004", ERROR, "arity-mismatch",
       "A node's operand count (args + immediate, where the op takes one) "
       "does not match its opcode's arity, or the opcode is unknown — the "
       "FU config word cannot express it.",
       "Fix the producer that built the node; see _ARITY in "
       "repro_torch/core/dfg.py for the operand contract."),
    _c("A005", ERROR, "dfg-cycle",
       "The DFG has a dependency cycle; a feed-forward overlay pipeline "
       "cannot evaluate it.",
       "Break the cycle — overlay kernels are pure feed-forward "
       "dataflow."),
    _c("A006", ERROR, "imm-misuse",
       "An immediate is attached to an op that cannot carry one (pass/abs/"
       "neg/output), or a const node has operands — the bitstream packer "
       "would silently drop or misread the field.",
       "Move the constant into a 'const' node or an imm-capable op "
       "(add/sub/mul/muladd/...)."),
    # ---- A1xx: graph race/alias analysis -------------------------------
    _c("A101", ERROR, "use-before-def",
       "A recorded call reads a node output that is unknown, out of "
       "range, or produced by a LATER node in recording order — replay "
       "executes in recording order, so the read would see stale or "
       "missing data (a read-after-write race).",
       "Re-record the capture so producers precede consumers; "
       "KernelGraph.call only hands out buffers for existing nodes."),
    _c("A102", ERROR, "duplicate-nid",
       "Two recorded nodes share one node id — a write-after-write "
       "hazard: every GraphBuffer naming that id silently aliases "
       "whichever node replay resolves last.",
       "Never renumber GraphNode.nid by hand; record through "
       "KernelGraph.call, which assigns unique ids."),
    _c("A103", ERROR, "input-range",
       "A recorded call reads graph input i, but the graph declares "
       "fewer inputs — launch would bind the wrong (or no) buffer.",
       "Declare the input with g.input() before recording calls that "
       "consume it."),
    _c("A104", ERROR, "dangling-graph-output",
       "A graph output names a node or output slot that does not exist; "
       "launch could not materialize the result.",
       "mark_output() only existing node outputs; freeze() derives the "
       "rest."),
    _c("A105", ERROR, "missing-partition-dep",
       "A partition consumes another partition's output but does not "
       "list it in deps — replay would not wait on the producing "
       "partition's event and could read the buffer before it is "
       "written (a cross-partition race).",
       "partition_graph derives deps from ext refs; re-partition rather "
       "than editing Partition.deps."),
    _c("A106", ERROR, "partition-coverage",
       "The partition cut does not cover the graph exactly: a recorded "
       "node is unassigned or assigned to several partitions — replay "
       "would skip it or run it twice.",
       "Re-run partition_graph; do not edit Partition.node_ids."),
    _c("A107", ERROR, "partition-order",
       "Cross-partition wiring violates replay order: a partition "
       "depends on itself, on a later partition, or the dependency "
       "graph has a cycle — fused replay indexes earlier events only.",
       "Partitions must be cut in topological order "
       "(partition_graph guarantees this)."),
    _c("A108", ERROR, "illegal-alias",
       "Illegal aliasing across a fusion boundary: one external buffer "
       "key occupies two fused-input slots of the same partition, or a "
       "partition feeds itself through its own external inputs — the "
       "launch gather would bind the wrong buffer in place.",
       "fuse_dfgs dedups equal ext keys; rebuild the partition instead "
       "of editing Partition.ext."),
    _c("A109", ERROR, "fused-io-mismatch",
       "A partition's fused DFG disagrees with its wiring metadata: "
       "ext-key count != fused-kernel inputs, exposed outputs != fused "
       "outputs, or an exposed output is not produced by a member node.",
       "Rebuild the partition with _fuse_partition; ext/outputs are "
       "derived, not free-standing."),
    # ---- A2xx: artifact legality (independent re-proof) -----------------
    _c("A201", ERROR, "placement-illegal",
       "FU placement is illegal: a super-node placed off-grid, two FUs "
       "sharing one tile, a missing/unknown (replica, sid) key, or a "
       "count inconsistent with the replication plan.",
       "The artifact is miscompiled — rebuild; if it came from a cache, "
       "the verifier quarantines the entry automatically."),
    _c("A202", ERROR, "pad-overuse",
       "IO placement violates the perimeter pad capacity table: a pad "
       "off the perimeter, or more placements on one site than "
       "io_per_edge_tile allows.",
       "Rebuild the artifact; quarantine handles cached entries."),
    _c("A203", ERROR, "route-discontinuity",
       "A routed net is not a contiguous legal path: non-adjacent hops, "
       "an edge absent from the routing graph, or endpoints that do not "
       "match the placement of its source/sink.",
       "Rebuild the artifact; quarantine handles cached entries."),
    _c("A204", ERROR, "channel-overuse",
       "Recomputed channel load (tree wire segments counted once per "
       "net, as the router and the fabric do) exceeds a channel "
       "bundle's capacity — two signals would share one wire.",
       "Rebuild the artifact; quarantine handles cached entries."),
    _c("A205", ERROR, "latency-misalign",
       "The latency certificate does not re-prove: FU input arrivals "
       "(source ready + hops + delay-chain) disagree at some FU, replica "
       "outputs are not aligned, or pipeline_depth is not the real "
       "output-ready maximum — the II=1 datapath would mix work-items.",
       "Rebuild the artifact; quarantine handles cached entries."),
    _c("A206", ERROR, "delay-capacity",
       "A delay-chain assignment is negative or exceeds the overlay's "
       "max_delay — the config field cannot express it on hardware.",
       "Rebuild the artifact; quarantine handles cached entries."),
    _c("A207", ERROR, "ledger-mismatch",
       "Resource-ledger conservation fails: the replication plan's "
       "FU/IO usage does not equal replicas x kernel footprint, exceeds "
       "the overlay totals, or disagrees with the placement.",
       "Rebuild the artifact; quarantine handles cached entries."),
    _c("A208", ERROR, "bitstream-mismatch",
       "The packed bitstream is not the one this artifact's P&R implies: "
       "header fields disagree with spec/plan, or regenerating the "
       "configuration from the placement/routing/latency yields "
       "different bytes — the loaded config would not be the verified "
       "datapath.",
       "Rebuild the artifact; quarantine handles cached entries."),
    # ---- A9xx: analyzer internal ----------------------------------------
    _c("A901", ERROR, "pass-crash",
       "An analysis pass raised an unhandled exception on a target — the "
       "target was NOT fully checked, so this is as severe as a finding.",
       "Fix the crash (it is an analyzer bug or a target so malformed "
       "the pass could not start); the traceback is in the message."),
    # ---- A3xx: lock-discipline lint -------------------------------------
    _c("A301", ERROR, "unlocked-mutation",
       "A shared attribute declared `# lock: <spec>` is mutated outside "
       "a with-block holding the declared lock (and outside a function "
       "annotated `# lock: held(<name>)`).",
       "Wrap the mutation in `with <owner>.<lock>:`, or annotate the "
       "enclosing function `# lock: held(<name>)` if its contract is "
       "caller-holds-lock."),
    _c("A302", ERROR, "bad-lock-annotation",
       "A `# lock:` annotation does not parse (unknown form) or is "
       "attached to a line the linter cannot interpret — the contract "
       "it states is not being enforced.",
       "Use `# lock: NAME`, `# lock: ctx.NAME`, `# lock: any(NAME)` on "
       "attribute assignments, or `# lock: held(NAME)` on a def line."),
])
