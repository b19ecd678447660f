"""Tiny pass manager for the static analyzer.

A *pass* is a named callable ``(target) -> Iterable[Diagnostic]``; a
:class:`PassManager` runs a list of them over a list of targets, skipping
passes whose predicate says the target is not their kind, and collects
everything into a :class:`~repro_torch.analysis.diagnostics.Report`.

This indirection is small on purpose: the library hooks (``fuse_dfgs``,
``jit_compile``, ``Session.instantiate``) call the individual check
functions directly, while the CLI and tests compose them through the
manager so one invocation can sweep heterogeneous targets (DFGs, captured
graphs, compiled artifacts) with uniform error handling — a crashing pass
becomes a diagnostic, not a crashed analyzer.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Callable, Iterable, List, Optional, Sequence

from .diagnostics import Diagnostic, Report, Span, diag


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    run: Callable[[Any], Iterable[Diagnostic]]
    # applies(target) -> bool; None means the pass accepts every target
    applies: Optional[Callable[[Any], bool]] = None


@dataclasses.dataclass(frozen=True)
class Target:
    """A named analysis subject.  ``kind`` is matched by pass predicates
    ("dfg" | "graph" | "artifact" | ...)."""
    name: str
    kind: str
    obj: Any


def kind(*kinds: str) -> Callable[[Any], bool]:
    return lambda t: isinstance(t, Target) and t.kind in kinds


class PassManager:
    def __init__(self, passes: Sequence[Pass] = ()):
        self.passes: List[Pass] = list(passes)

    def add(self, p: Pass) -> "PassManager":
        self.passes.append(p)
        return self

    def run(self, targets: Iterable[Target]) -> Report:
        report = Report()
        n = 0
        for t in targets:
            n += 1
            for p in self.passes:
                if p.applies is not None and not p.applies(t):
                    continue
                try:
                    report.extend(p.run(t.obj))
                except Exception as e:  # noqa: BLE001 - pass crash -> diag
                    tb = traceback.format_exc(limit=3)
                    report.extend([diag(
                        "A901", Span(target=t.name, node=p.name),
                        f"analysis pass {p.name!r} crashed on "
                        f"{t.kind} {t.name!r}: {e!r}\n{tb}")])
        report.targets_analyzed = n
        return report
