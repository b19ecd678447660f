"""Static verifier and lint subsystem for the overlay JIT pipeline.

Four pass families over four layers of the stack:

* :mod:`repro_torch.analysis.dfg_checks`   — A0xx DFG semantic checks (run
  automatically on every ``fuse_dfgs`` output);
* :mod:`repro_torch.analysis.graph_checks` — A1xx race/alias analysis over
  captured KernelGraphs and their partition cuts (the gate of
  ``Session.instantiate`` when a node asks for verification);
* :mod:`repro_torch.analysis.artifact`     — A2xx independent legality
  re-proof of CompiledKernels (the ``CompileOptions.verify_level`` gate);
* :mod:`repro_torch.analysis.locklint`     — A3xx AST lock-discipline lint
  over the port's runtime, serving and observability modules.

All of it is host work over host data: no pass reads a tensor.  Library
use returns :class:`Diagnostic` lists; ``python -m repro_torch.analysis``
is the CLI (``docs/diagnostics.md`` holds the code table, shared with the
JAX package).
"""

from .artifact import assert_valid, verify_artifact
from .dfg_checks import assert_clean, check_dfg
from .diagnostics import (CODES, ERROR, INFO, WARNING, Diagnostic, Report,
                          Span, VerificationError, diag)
from .graph_checks import check_graph, check_partitions
from .locklint import lint_files
from .passes import Pass, PassManager, Target

__all__ = [
    "CODES", "ERROR", "INFO", "WARNING", "Diagnostic", "Report", "Span",
    "VerificationError", "diag", "Pass", "PassManager", "Target",
    "check_dfg", "assert_clean", "check_graph", "check_partitions",
    "verify_artifact", "assert_valid", "lint_files",
]
