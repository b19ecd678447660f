"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu`` at their smallest arguments and exit 0 with their own
checks holding; without ``--device cpu`` and with no card they exit
non-zero, never falling back to the CPU.  The figures that quickstart,
resource_aware_scaling and opencl_runtime_demo print are held against the
JAX package's own library calls (``repro.core.jit.jit_compile``,
``repro.core.runtime.Context.build_program``), not its scripts run whole:
those reach the Pallas executor, which does not run under this JAX.

Every script starts at once, in its own interpreter, when the first test
asks for the runs."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.paper_suite import BENCHMARKS
from repro.core.jit import jit_compile
from repro.core.options import CompileOptions
from repro.core.overlay import OverlaySpec
from repro.core.runtime import Buffer, Context, Device, Platform

ROOT = Path(__file__).resolve().parents[1]
# each example's smallest arguments (torch_train_lm's loss must fall only
# in runs of LEARNS_BY steps or more)
EXAMPLES = {
    "quickstart": [], "opencl_runtime_demo": [],
    "resource_aware_scaling": [], "graph_replay": [],
    "multi_tenant_serving": [], "serve_zoo": [], "trace_serving": [],
    "serve_lm": [], "elastic_restart": [],
    "train_lm": ["--steps", "3", "--batch", "2", "--seq", "16"],
}
TIMEOUT_S = 240


def _start(name: str, args, cwd: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
         *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name → (exit code, stdout, stderr) of every example run with
    ``--device cpu``, and under ("no card", name) without it."""
    procs = {}
    for name, args in EXAMPLES.items():
        d = tmp_path_factory.mktemp(name)
        procs[name] = _start(name, [*args, "--device", "cpu"], d)
        if not torch.cuda.is_available():
            procs[("no card", name)] = _start(name, args, d)
    out = {}
    try:
        for key, proc in procs.items():
            so, se = proc.communicate(timeout=TIMEOUT_S)
            out[key] = (proc.returncode, so, se)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, so[-2000:] + se[-4000:]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_exits_nonzero(runs, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the scripts run on it")
    rc, so, se = runs[("no card", name)]
    assert rc != 0
    assert "no CUDA device is available" in se, se[-2000:]


QUICKSTART_SRC = """
__kernel void chebyshev(__global int *A, __global int *B)
{
  int idx = get_global_id(0);
  int x = A[idx];
  B[idx] = (x*(x*(16*x*x-20)*x+5));
}
"""


def test_quickstart_figures_are_the_reference_compilers(runs):
    rc, so, _ = runs["quickstart"]
    assert rc == 0
    ck = jit_compile(QUICKSTART_SRC, OverlaySpec(width=8, height=8,
                                                 dsp_per_fu=2))
    for line in (
            f"kernel needs {ck.fug.n_fus} FUs + {ck.fug.n_io} IO per copy",
            f"resource-aware replication: {ck.plan.replicas} copies "
            f"({ck.plan.fu_utilisation:.0%} FU utilisation, limited by "
            f"{ck.plan.limited_by})",
            f"routed wirelength {ck.routing.total_wirelength}, pipeline "
            f"depth {ck.pipeline_depth} cycles",
            f"config bitstream {ck.bitstream.n_bytes} bytes (paper: 1061 B "
            f"for 8x8), load {ck.bitstream.load_time_us():.1f} us",
            f"modelled throughput {ck.throughput_gops():.1f} GOPS",
            f"executed {1 << 14} work-items on the overlay executor (cpu), "
            f"bit-identical to run_reference: True"):
        assert line in so, line
    block = so.split("=== compile pipeline ===")[1].split("kernel needs")[0]
    stages = [ln.split()[0] for ln in block.strip().splitlines()]
    assert stages == list(ck.stage_times_ms), stages


def test_resource_aware_scaling_rows_are_the_reference_runtimes(runs):
    rc, so, _ = runs["resource_aware_scaling"]
    assert rc == 0
    src = BENCHMARKS["chebyshev"][0]
    rows = []
    for size in (2, 4, 6, 8):
        ctx = Context(Device(f"ovl{size}", OverlaySpec(width=size,
                                                       height=size)))
        ck = ctx.build_program(src, opts=CompileOptions()).compiled
        rows.append(f"  {size}x{size}   |      0 FUs  |   "
                    f"{ck.plan.replicas:4d}  | {ck.throughput_gops():4.1f} |")
    for reserve in (0, 16, 32, 48, 56):
        ctx = Context(Device("ovl8", OverlaySpec(width=8, height=8)))
        if reserve:
            ctx.reserve(fus=reserve)
        ck = ctx.build_program(src, opts=CompileOptions()).compiled
        rows.append(f"  8x8   |   {reserve:3d} FUs   |   "
                    f"{ck.plan.replicas:4d}  | {ck.throughput_gops():4.1f} |")
    got = [ln for ln in so.splitlines() if "FUs" in ln]
    assert len(got) == len(rows)
    for line, want in zip(got, rows):
        assert line.startswith(want), (line, want)


def test_opencl_runtime_demo_figures_are_the_reference_runtimes(runs):
    """The reference's flow with its queue on ``run_reference`` (its
    executor is the Pallas kernel): the same builds, ledger and modelled
    config and exec times."""
    rc, so, _ = runs["opencl_runtime_demo"]
    assert rc == 0
    dev = Platform([Device("zynq-overlay", OverlaySpec(
        width=8, height=8, dsp_per_fu=2))]).devices[0]
    ctx = Context(dev)
    prog = ctx.build_program(BENCHMARKS["poly1"][0], opts=CompileOptions())
    lines = [f"({prog.compiled.plan.replicas} replicas); overlay config "
             f"{prog.compiled.bitstream.n_bytes} B, load "
             f"{prog.configure_overlay():.1f} us; ledger: {dev.fu_used}/"
             f"{dev.spec.n_fus} FUs in use"]
    x = np.linspace(-2, 2, 1000).astype(np.float32)
    queue = ctx.create_queue(use_overlay_executor=False)
    ev = queue.enqueue_kernel(prog.create_kernel().set_args(Buffer(x)))
    ev.wait()
    lines.append(f"(config {ev.config_us:.1f} us + exec {ev.exec_us:.1f} us "
                 f"modelled)")
    prog.release()
    prog2 = ctx.build_program(BENCHMARKS["sgfilter"][0],
                              opts=CompileOptions())
    lines.append(f"({prog2.compiled.plan.replicas} replicas)")
    y = np.linspace(-1, 1, 1000).astype(np.float32)
    ev2 = queue.enqueue_kernel(
        prog2.create_kernel().set_args(Buffer(x), Buffer(y)))
    ev2.wait()
    lines.append(f"(reconfig charged: {ev2.config_us:.1f} us)")
    for line in lines:
        assert line in so, line
