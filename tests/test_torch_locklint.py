"""The port's lock-discipline lint (A3xx) against `repro`'s.

Every claim of ``tests/test_locklint.py`` runs through both packages on the
same synthetic modules: the same diagnostics (code, severity, span,
message) for each rule of the ``# lock:`` grammar.  Then the port's own
runtime, serving and observability modules lint clean, and declare every
attribute contract of the reference's modules plus the port's resident
image lock.
"""

import ast
import dataclasses
import os
import textwrap

from torch_runtime_pair import R, T, both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record(diags):
    return [(d.code, d.severity, dataclasses.astuple(d.span), d.message)
            for d in diags]


def lint_both(tmp_path, sources):
    """Write ``{filename: source}`` under tmp_path and lint them as one unit
    with each package: the same records.  Returns the port's findings."""
    paths = []
    for name, src in sources.items():
        p = tmp_path / name
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    r, t = both(lambda pkg: pkg.analysis.lint_files(paths,
                                                     root=str(tmp_path)))
    assert record(t) == record(r)
    return t


def codes_of(diags):
    return [d.code for d in diags]


# -------------------------------------------------------------- clean paths

def test_clean_module_has_no_findings(tmp_path):
    diags = lint_both(tmp_path, {"box.py": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []              # lock: _lock
                self.items.append(0)         # __init__ is exempt

            def add(self, x):
                with self._lock:
                    self.items.append(x)

            def reset(self):
                with self._lock:
                    self.items = []
                    del self.items[:]
        """})
    assert diags == []


def test_init_exemption_is_init_only(tmp_path):
    diags = lint_both(tmp_path, {"box.py": """
        class Box:
            def __init__(self):
                self.items = []              # lock: _lock

            def not_init(self):
                self.items = [1]             # unprotected
        """})
    assert codes_of(diags) == ["A301"]


# ----------------------------------------------------- every mutation kind

def test_a301_fires_on_every_mutation_kind(tmp_path):
    diags = lint_both(tmp_path, {"box.py": """
        import bisect
        import heapq

        class Box:
            def __init__(self):
                self.items = []              # lock: _lock
                self.table = {}              # lock: _lock
                self.count = 0               # lock: _lock

            def plain(self):
                self.items = [1]

            def augmented(self):
                self.count += 1

            def method(self):
                self.items.append(1)

            def deleter(self):
                del self.table["k"]

            def subscript(self):
                self.table["k"] = 1

            def arg_mutator(self):
                bisect.insort(self.items, 3)
                heapq.heappush(self.items, 4)
        """})
    assert codes_of(diags) == ["A301"] * 7


def test_nested_function_does_not_inherit_the_with(tmp_path):
    diags = lint_both(tmp_path, {"box.py": """
        class Box:
            def __init__(self):
                self.items = []              # lock: _lock

            def sched(self, pool):
                with self._lock:
                    def later():
                        self.items.append(1)
                    pool.submit(later)
        """})
    assert codes_of(diags) == ["A301"]


# ------------------------------------------------------------- the grammar

def test_dotted_owner_lock(tmp_path):
    diags = lint_both(tmp_path, {"prog.py": """
        class Program:
            def __init__(self, ctx):
                self.ctx = ctx
                self.compiled = None         # lock: ctx.lock

            def good(self, ck):
                with self.ctx.lock:
                    self.compiled = ck

            def bad(self, ck):
                with self._lock:             # wrong lock entirely
                    self.compiled = ck
        """})
    assert codes_of(diags) == ["A301"]
    assert "ctx.lock" in diags[0].message


def test_any_lock_accepts_every_owner(tmp_path):
    diags = lint_both(tmp_path, {"dev.py": """
        class Device:
            def __init__(self):
                self.fu_used = 0             # lock: any(lock)

        class Fleet:
            def seize(self, dev):
                with dev.lock:
                    dev.fu_used += 1

            def steal(self, dev):
                dev.fu_used += 1
        """})
    assert codes_of(diags) == ["A301"]
    assert diags[0].span.line == 12          # in steal()


def test_held_def_annotation_trusts_the_caller(tmp_path):
    diags = lint_both(tmp_path, {"cache.py": """
        class Cache:
            def __init__(self):
                self._entries = {}           # lock: _lock

            def _insert(self, k, v):         # lock: held(_lock)
                self._entries[k] = v

            def put(self, k, v):
                with self._lock:
                    self._insert(k, v)
        """})
    assert diags == []


def test_a302_flags_broken_annotations(tmp_path):
    diags = lint_both(tmp_path, {"bad.py": """
        class Box:
            def __init__(self):
                self.items = []              # lock: not a spec!!
        """})
    assert "A302" in codes_of(diags)


def test_a302_on_unparsable_file(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    r, t = both(lambda pkg: pkg.analysis.lint_files([str(p)],
                                                     root=str(tmp_path)))
    assert record(t) == record(r)
    assert codes_of(t) == ["A302"]


# ------------------------------------------------------ cross-file registry

def test_cross_file_mutation_checked_against_owners_lock(tmp_path):
    """Session-side code mutating a cache-owned counter under the session's
    lock, not the cache's."""
    sources = {
        "cachelike.py": """
            class Cache:
                def __init__(self):
                    self.stats = {}          # lock: _lock

                def bump(self, k):
                    with self._lock:
                        self.stats[k] = self.stats.get(k, 0) + 1
            """,
        "sessionlike.py": """
            class Session:
                def __init__(self, cache):
                    self.cache = cache

                def dedup(self, key):
                    with self._lock:         # wrong domain: session's lock
                        self.cache.stats[key] = 1
            """,
    }
    diags = lint_both(tmp_path, sources)
    assert codes_of(diags) == ["A301"]
    assert "sessionlike.py" in diags[0].span.file

    sources["sessionlike.py"] = """
        class Session:
            def __init__(self, cache):
                self.cache = cache

            def dedup(self, key):
                with self.cache._lock:       # the owner's lock: fine
                    self.cache.stats[key] = 1
        """
    assert lint_both(tmp_path, sources) == []


# --------------------------------------------------------- the real modules

def test_runtime_modules_lint_clean():
    """The port's lint targets are its own copies, and they lint clean."""
    targets = T.locklint.DEFAULT_TARGETS
    assert [t.replace("src/repro_torch/", "src/repro/") for t in targets] \
        == list(R.locklint.DEFAULT_TARGETS)
    diags = T.analysis.lint_files(targets, root=REPO)
    assert diags == [], [str(d) for d in diags]


def declared(pkg):
    """(module, attribute) -> (lock kind, lock) over a package's lint
    targets, the module named as in the reference."""
    out = {}
    for rel in pkg.locklint.DEFAULT_TARGETS:
        src = open(os.path.join(REPO, rel), encoding="utf-8").read()
        decl = pkg.locklint._scan_declarations(rel, ast.parse(src),
                                               src.splitlines())
        assert not decl.diags, [str(d) for d in decl.diags]
        module = rel.replace("src/repro_torch/", "src/repro/")
        out.update({(module, a): (s.kind, s.value)
                    for a, s in decl.attrs.items()})
    return out


def test_contract_is_actually_declared():
    """Guard against the lint passing vacuously: the port declares every
    contract of the reference's modules, plus the lock of its resident
    executor images."""
    port, ref = declared(T), declared(R)
    assert len(port) >= 72
    assert set(port) - set(ref) == {("src/repro/core/runtime.py",
                                     "_images")}
    assert {k: port[k] for k in ref} == ref
    assert port["src/repro/core/runtime.py", "_images"] == \
        ("name", "_image_lock")
