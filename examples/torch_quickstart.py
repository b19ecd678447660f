"""Quickstart of the PyTorch port: JIT-compile an OpenCL kernel to the
overlay and run it on the overlay executor, on one CUDA card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Walks the paper's whole Fig. 2 flow on the chebyshev kernel and prints every
intermediate artifact; the executor's output is held bit for bit against
``CompiledKernel.run_reference``.
"""

import argparse

import numpy as np

from repro_torch.core.ir import optimize_module, parse_kernel
from repro_torch.core.jit import jit_compile
from repro_torch.core.overlay import OverlaySpec
from repro_torch.device import target_device

SRC = """
__kernel void chebyshev(__global int *A, __global int *B)
{
  int idx = get_global_id(0);
  int x = A[idx];
  B[idx] = (x*(x*(16*x*x-20)*x+5));
}
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the executor runs (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)

    print("=== OpenCL source (paper Table I(a)) ===")
    print(SRC)

    m = parse_kernel(SRC)
    print("=== IR (paper Table I(b)) ===")
    print(m.render(), "\n")
    print("=== optimized IR (paper Table I(c)) ===")
    print(optimize_module(m).render(), "\n")

    spec = OverlaySpec(width=8, height=8, dsp_per_fu=2)
    ck = jit_compile(SRC, spec)
    print("=== DFG (paper Table II) ===")
    print(ck.dfg.to_dot(), "\n")

    print("=== compile pipeline ===")
    for stage, ms in ck.stage_times_ms.items():
        print(f"  {stage:10s} {ms:8.2f} ms")
    print(f"  kernel needs {ck.fug.n_fus} FUs + {ck.fug.n_io} IO per copy")
    print(f"  resource-aware replication: {ck.plan.replicas} copies "
          f"({ck.plan.fu_utilisation:.0%} FU utilisation, "
          f"limited by {ck.plan.limited_by})")
    print(f"  routed wirelength {ck.routing.total_wirelength}, "
          f"pipeline depth {ck.pipeline_depth} cycles")
    print(f"  config bitstream {ck.bitstream.n_bytes} bytes "
          f"(paper: 1061 B for 8x8), load "
          f"{ck.bitstream.load_time_us():.1f} us")
    print(f"  modelled throughput {ck.throughput_gops():.1f} GOPS\n")

    x = np.linspace(-1, 1, 1 << 14).astype(np.float32)
    got = ck.run_overlay(x, device=dev).cpu().numpy()
    want = ck.run_reference(x)
    err = float(np.abs(got - x * (x * (16 * x * x - 20) * x + 5)).max())
    same = np.array_equal(got.view(np.uint32), want.view(np.uint32))
    print(f"executed {x.size} work-items on the overlay executor ({dev}), "
          f"bit-identical to run_reference: {same}; max |err| against "
          f"the polynomial = {err:.2e}")
    assert same, "the executor differs from run_reference"
    print("OK")


if __name__ == "__main__":
    main()
