"""The port stands alone: nothing under ``src/repro_torch/``, and not
``chip_smoke.py`` or the port's benchmarks (``benchmarks/torch_*.py`` and
the helper they share, ``benchmarks/port_bench.py``), imports JAX or any
module of the JAX package ``repro``.

Checked twice: statically over every import statement, and in a fresh
interpreter that imports every module of the port and then looks at
``sys.modules``.  Also: importing builds no kernel, and ``chip_smoke.py``
refuses to run without a card or outside a checkout.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
BENCHMARKS = sorted((ROOT / "benchmarks").glob("torch_*.py"))
# what the port's benchmarks share; a helper, not a script
BENCH_HELPER = ROOT / "benchmarks" / "port_bench.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PORT.rglob("*.py")) + [SMOKE] + BENCHMARKS + [BENCH_HELPER]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_no_source_imports_jax_or_the_reference_package():
    bad = [f"{p.relative_to(ROOT)}:{line}: {name}"
           for p in _sources() for line, name in _imports(p)
           if _forbidden(name)]
    assert not bad, bad


def test_port_mirrors_the_reference_layout():
    """Each port module sits at its reference's relative path; only the
    package's own helpers (the device rule, the CUDA build) have none."""
    own = {"__init__.py", "device.py", "cuda_build.py"}
    missing = [str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
               if p.name not in own
               and not (ROOT / "src" / "repro" / p.relative_to(PORT)).exists()]
    assert not missing, missing


_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.overlay_exec import kernel as ox
from repro_torch.kernels.rmsnorm import kernel as rn
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
builds = (ox.LIBRARY.builds + rn.LIBRARY.builds + fa.LIBRARY.builds
          + fa.LIBRARY_WGMMA.builds + fa.LIBRARY_BWD.builds)
print(len(mods), builds, torch.cuda.is_initialized(), bad)
"""


def test_importing_every_module_loads_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(SMOKE)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n_mods, builds, cuda_init, bad = out.stdout.strip().rsplit("\n", 1)[-1] \
        .split(" ", 3)
    assert int(n_mods) >= 40
    assert (builds, cuda_init, bad) == ("0", "False", "[]")


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=""))


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, script)
    out = _run_smoke(script, tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = _run_smoke(SMOKE, ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("script", BENCHMARKS, ids=lambda p: p.name)
def test_port_benchmarks_without_a_card_fail(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the benchmark would run for real")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
