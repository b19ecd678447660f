"""Pass family 4: AST-based lock-discipline lint (codes A301, A302).

The runtime's locking invariants were first kept by hand (device ledger
under ``Context.lock``, timeline under ``Context.timeline_lock``, cache
tiers under ``JITCache._lock``, session state under ``Session._lock``,
each Program's resident executor images under ``Program._image_lock``).
This lint turns those invariants into a checked contract via ``# lock:``
annotations in the source:

On the attribute's initializing assignment (its declaration)::

    self._entries = OrderedDict()        # lock: _lock
    self.compiled = None                 # lock: ctx.lock
    self.fu_used = 0                     # lock: any(lock)

* ``# lock: NAME`` — every mutation of the attribute through a path
  ``<base>.<attr>`` must be inside ``with <base>.NAME:``.  (Mutating
  ``self.ctx._engine_busy`` requires ``with self.ctx.timeline_lock:`` —
  the lock is looked up on the *owner* of the attribute, so holding
  *your own* unrelated ``self._lock`` does not satisfy it.)
* ``# lock: ctx.lock`` (dotted) — the guard hangs off a sibling
  attribute: satisfied by ``with <base>.ctx.lock:`` or, for code holding
  a direct reference to the owner's context, ``with ctx.lock:`` exactly.
* ``# lock: any(NAME)`` — satisfied by *any* held lock whose final
  component is ``NAME`` (for attributes reachable from several roots,
  e.g. a Program mutated via a fleet-held reference).

On a ``def`` line::

    def _insert(self, ...):              # lock: held(_lock)

declares caller-holds-lock: inside that function, ``NAME`` counts as
held.  Mutations rooted at ``self`` inside ``__init__`` are exempt
(construction precedes sharing).

Detected mutations: assignments (plain / annotated / augmented /
starred-tuple), ``del``, subscript stores (``d[k] = v`` mutates ``d``),
mutating method calls (``.append``/``.update``/...) and the arg-based
mutators (``bisect.insort(target, ...)``, ``heapq.heappush``).  Paths
are tracked only for pure ``Name``/``Attribute`` chains — anything else
is outside the contract's vocabulary.  The attribute registry is global
across the scanned files, so ``session.py`` touching a cache-owned
attribute is checked against the *cache's* declared lock.

A302 flags the meta-failure: a ``# lock:`` annotation that does not
parse or is attached to a line the linter cannot interpret — a stated
contract that silently is not being enforced.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, Span, diag

# the port's runtime modules that carry `# lock:` contracts; CLI/CI default
DEFAULT_TARGETS = tuple(f"src/repro_torch/{m}.py" for m in (
    "core/runtime", "core/cache", "core/session", "core/queue", "core/faults",
    "core/recovery", "core/remote", "serve/server", "serve/batcher",
    "obs/trace", "obs/metrics", "obs/profile", "obs/recut"))

_LOCK_RE = re.compile(r"#\s*lock:\s*(?P<spec>[^#]+?)\s*$")
_NAME_RE = re.compile(r"^[A-Za-z_]\w*$")
_DOTTED_RE = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)+$")
_CALL_RE = re.compile(r"^(?P<kind>any|held)\(\s*(?P<name>[A-Za-z_]\w*)\s*\)$")

# methods that mutate their receiver in place
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "move_to_end", "add", "discard", "sort",
    "reverse",
})
# functions that mutate their FIRST ARGUMENT in place
_ARG_MUTATORS = frozenset({
    "bisect.insort", "bisect.insort_left", "bisect.insort_right",
    "heapq.heappush", "heapq.heapify", "heapq.heappop",
})


def _attr_path(node: ast.AST) -> Optional[str]:
    """Dotted path of a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return ".".join(parts)
    return None


class LockSpec:
    """A parsed `# lock:` contract for one attribute."""

    __slots__ = ("kind", "value", "decl_file", "decl_line")

    def __init__(self, kind: str, value: str, decl_file: str,
                 decl_line: int):
        self.kind = kind          # "name" | "dotted" | "any"
        self.value = value
        self.decl_file = decl_file
        self.decl_line = decl_line

    @property
    def final(self) -> str:
        return self.value.rsplit(".", 1)[-1]

    def describe(self, base: str) -> str:
        if self.kind == "any":
            return f"any lock named {self.value!r}"
        return f"{base}.{self.value}"

    def satisfied(self, base: str, withs: Sequence[str],
                  held: Set[str]) -> bool:
        if self.kind == "any":
            return self.value in held or \
                any(w.rsplit(".", 1)[-1] == self.value for w in withs)
        required = f"{base}.{self.value}"
        if required in withs:
            return True
        if self.kind == "dotted" and self.value in withs:
            return True           # direct owner reference, e.g. `ctx.lock`
        return self.final in held


def _parse_spec(text: str) -> Optional[Tuple[str, str]]:
    """-> (kind, value) where kind in name|dotted|any|held, else None."""
    text = text.strip()
    m = _CALL_RE.match(text)
    if m:
        return m.group("kind"), m.group("name")
    if _NAME_RE.match(text):
        return "name", text
    if _DOTTED_RE.match(text):
        return "dotted", text
    return None


# ------------------------------------------------------------ registry scan

class _Declarations:
    """All `# lock:` annotations of one file, by role."""

    def __init__(self) -> None:
        self.attrs: Dict[str, LockSpec] = {}          # attr name -> spec
        self.fn_held: Dict[int, Set[str]] = {}        # def lineno -> names
        self.consumed: Set[int] = set()               # line numbers used
        self.diags: List[Diagnostic] = []


def _annotated_lines(lines: Sequence[str]) -> Dict[int, str]:
    out = {}
    for i, line in enumerate(lines, start=1):
        m = _LOCK_RE.search(line)
        if m:
            out[i] = m.group("spec")
    return out


def _scan_declarations(path: str, tree: ast.Module,
                       lines: Sequence[str]) -> _Declarations:
    decl = _Declarations()
    annotated = _annotated_lines(lines)
    rel = path

    def span(line: int) -> Span:
        return Span(target=rel, file=rel, line=line)

    for node in ast.walk(tree):
        # ---- attribute declarations -------------------------------------
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            stmt_lines = [ln for ln in range(node.lineno,
                                             (node.end_lineno or
                                              node.lineno) + 1)
                          if ln in annotated]
            if not stmt_lines:
                continue
            ln = stmt_lines[0]
            parsed = _parse_spec(annotated[ln])
            # declarations: `self.X = ...` attribute inits AND class-body
            # field declarations (`fu_used: int = 0` in a dataclass)
            attr_names = [t.attr for t in targets
                          if isinstance(t, ast.Attribute)]
            attr_names += [t.id for t in targets if isinstance(t, ast.Name)]
            if parsed is None or parsed[0] == "held" or not attr_names:
                decl.consumed.add(ln)
                if parsed is None:
                    msg = (f"`# lock: {annotated[ln].strip()}` does not "
                           f"parse (expected NAME, OWNER.NAME, any(NAME) "
                           f"or held(NAME))")
                elif parsed[0] == "held":
                    msg = (f"`# lock: {annotated[ln].strip()}` — held() "
                           f"belongs on a def line, not an attribute "
                           f"assignment")
                else:
                    msg = (f"`# lock: {annotated[ln].strip()}` must "
                           f"annotate an attribute assignment "
                           f"(self.X = ... or a class field)")
                decl.diags.append(diag("A302", span(ln), msg))
                continue
            kind, value = parsed
            for attr in attr_names:
                prev = decl.attrs.get(attr)
                if prev is not None and (prev.kind, prev.value) != \
                        (kind, value):
                    decl.diags.append(diag(
                        "A302", span(ln),
                        f"attribute {attr!r} re-declared with lock "
                        f"{value!r}, conflicting with {prev.value!r} at "
                        f"{prev.decl_file}:{prev.decl_line}"))
                    continue
                decl.attrs[attr] = LockSpec(kind, value, rel, ln)
            decl.consumed.add(ln)
        # ---- function contracts -----------------------------------------
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            first_body = node.body[0].lineno if node.body else node.lineno
            for ln in range(node.lineno, first_body):
                if ln not in annotated:
                    continue
                parsed = _parse_spec(annotated[ln])
                decl.consumed.add(ln)
                if parsed is None or parsed[0] != "held":
                    decl.diags.append(diag(
                        "A302", span(ln),
                        f"`# lock: {annotated[ln].strip()}` on a def "
                        f"line must be held(NAME)"))
                    continue
                decl.fn_held.setdefault(node.lineno,
                                        set()).add(parsed[1])

    # annotations the scan could not attach to anything
    for ln, spec in annotated.items():
        if ln not in decl.consumed:
            decl.consumed.add(ln)
            decl.diags.append(diag(
                "A302", span(ln),
                f"`# lock: {spec.strip()}` is attached to a line the "
                f"linter cannot interpret (not an attribute assignment "
                f"or def line) — the contract is not enforced"))
    return decl


# ------------------------------------------------------------- mutation scan

class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, registry: Dict[str, LockSpec],
                 fn_held: Dict[int, Set[str]],
                 diags: List[Diagnostic]) -> None:
        self.path = path
        self.registry = registry
        self.fn_held = fn_held
        self.diags = diags
        self.withs: List[str] = []
        self.held: List[Set[str]] = [set()]
        self.fn: List[str] = []

    # ---- scope handling -------------------------------------------------
    def _visit_function(self, node) -> None:
        saved = self.withs
        self.withs = []           # a nested fn runs later: locks not held
        self.held.append(set(self.fn_held.get(node.lineno, ())))
        self.fn.append(node.name)
        self.generic_visit(node)
        self.fn.pop()
        self.held.pop()
        self.withs = saved

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            p = _attr_path(item.context_expr)
            if p is not None:
                self.withs.append(p)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for item in node.items:
            self.visit(item.context_expr)
        del self.withs[len(self.withs) - pushed:len(self.withs)]

    visit_AsyncWith = visit_With

    # ---- mutations ------------------------------------------------------
    def _targets(self, t: ast.AST) -> List[str]:
        if isinstance(t, (ast.Tuple, ast.List)):
            out: List[str] = []
            for e in t.elts:
                out.extend(self._targets(e))
            return out
        if isinstance(t, ast.Starred):
            return self._targets(t.value)
        if isinstance(t, ast.Subscript):
            p = _attr_path(t.value)
            return [p] if p else []
        if isinstance(t, ast.Attribute):
            p = _attr_path(t)
            return [p] if p else []
        return []

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for p in self._targets(t):
                self._check(p, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            for p in self._targets(node.target):
                self._check(p, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        for p in self._targets(node.target):
            self._check(p, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            for p in self._targets(t):
                self._check(p, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fpath = _attr_path(node.func)
        if fpath is not None:
            head, _, tail = fpath.rpartition(".")
            if tail in _MUTATORS and head:
                self._check(head, node.lineno)
            elif fpath in _ARG_MUTATORS and node.args:
                p = _attr_path(node.args[0])
                if p is not None:
                    self._check(p, node.lineno)
        self.generic_visit(node)

    # ---- the rule -------------------------------------------------------
    def _check(self, path: str, lineno: int) -> None:
        comps = path.split(".")
        if comps[0] == "self" and self.fn and self.fn[-1] == "__init__":
            return                # construction precedes sharing
        # deepest registered component owns the contract: mutating
        # `self.cache.stats.hits` is a mutation OF `stats`, guarded by
        # stats' owner (`self.cache`), not by the mutator's own locks
        for i in range(len(comps) - 1, 0, -1):
            spec = self.registry.get(comps[i])
            if spec is None:
                continue
            base = ".".join(comps[:i])
            held = self.held[-1]
            if not spec.satisfied(base, self.withs, held):
                holding = ", ".join(f"with {w}" for w in self.withs) \
                    or "no lock"
                if held:
                    holding += " (held(" + ", ".join(sorted(held)) + "))"
                self.diags.append(diag(
                    "A301",
                    Span(target=self.path, file=self.path, line=lineno),
                    f"{path} is mutated under {holding}, but "
                    f"{comps[i]!r} (declared {spec.decl_file}:"
                    f"{spec.decl_line}) requires "
                    f"{spec.describe(base)}"))
            return


# --------------------------------------------------------------- entry point

def lint_files(paths: Sequence[str] = DEFAULT_TARGETS,
               root: Optional[str] = None) -> List[Diagnostic]:
    """Lint ``paths`` (project-relative unless absolute) as one unit: the
    attribute registry is shared, so a cross-module mutation is checked
    against the owning module's declared lock."""
    root = root or os.getcwd()
    diags: List[Diagnostic] = []
    parsed: List[Tuple[str, ast.Module, _Declarations]] = []
    registry: Dict[str, LockSpec] = {}

    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        rel = os.path.relpath(full, root)
        try:
            with open(full, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=full)
        except (OSError, SyntaxError) as e:
            diags.append(diag(
                "A302", Span(target=rel, file=rel),
                f"cannot lint {rel}: {e}"))
            continue
        decl = _scan_declarations(rel, tree, src.splitlines())
        diags.extend(decl.diags)
        for attr, spec in decl.attrs.items():
            prev = registry.get(attr)
            if prev is not None and (prev.kind, prev.value) != \
                    (spec.kind, spec.value):
                diags.append(diag(
                    "A302", Span(target=rel, file=rel,
                                 line=spec.decl_line),
                    f"attribute {attr!r} declared with lock "
                    f"{spec.value!r} here but {prev.value!r} at "
                    f"{prev.decl_file}:{prev.decl_line} — one attribute "
                    f"name, one contract"))
                continue
            registry[attr] = spec
        parsed.append((rel, tree, decl))

    for rel, tree, decl in parsed:
        _Checker(rel, registry, decl.fn_held, diags).visit(tree)
    return diags
