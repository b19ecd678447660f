"""Static checks of the overlay JIT pipeline.

Only the DFG checks are part of this package so far:

* :mod:`repro_torch.analysis.diagnostics` — the structured diagnostic
  (code, severity, span) every check reports, and the code table;
* :mod:`repro_torch.analysis.dfg_checks`  — A0xx DFG semantic checks, run
  on every ``fuse_dfgs`` output.

The graph race/alias analysis, the artifact re-proof behind
``CompileOptions.verify_level``, the lock lint and the command line arrive
with the analysis slice.
"""

from .dfg_checks import assert_clean, check_dfg
from .diagnostics import (CODES, ERROR, INFO, WARNING, Diagnostic, Report,
                          Span, VerificationError, diag)

__all__ = [
    "CODES", "ERROR", "INFO", "WARNING", "Diagnostic", "Report", "Span",
    "VerificationError", "diag", "check_dfg", "assert_clean",
]
