"""Paper Figs. 5-6 on the PyTorch port: the OpenCL runtime exposes
shrinking overlay resources ('other logic' grows), and the JIT compiler
adapts the replication factor — same source, different hardware budgets.
Each build runs once on the overlay executor, on one CUDA card unless
``--device cpu``, bit for bit against ``CompiledKernel.run_reference``.

    PYTHONPATH=src python examples/torch_resource_aware_scaling.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.runtime import Buffer, Context, Device
from repro_torch.device import target_device

SRC = BENCHMARKS["chebyshev"][0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the executor runs (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)
    x = np.linspace(-1, 1, 2048).astype(np.float32)

    print("overlay | other logic | replicas | GOPS | PAR ms")
    print("--------|-------------|----------|------|-------")
    # Fig. 6: different overlay sizes
    for size in (2, 4, 6, 8):
        ctx = Context(Device(f"ovl{size}", OverlaySpec(width=size,
                                                       height=size)))
        try:
            prog = ctx.build_program(SRC, opts=CompileOptions())
        except Exception as e:  # noqa: BLE001
            print(f"  {size}x{size} |      0 FUs  |  (kernel does not fit: "
                  f"{type(e).__name__})")
            continue
        ck = prog.compiled
        (out,) = prog.create_kernel().set_args(Buffer(x, device=dev)) \
            .enqueue()
        assert np.array_equal(out.read().view(np.uint32),
                              ck.run_reference(x).view(np.uint32))
        print(f"  {size}x{size}   |      0 FUs  |   {ck.plan.replicas:4d}  "
              f"| {ck.throughput_gops():4.1f} | {ck.par_time_ms:6.1f}")

    # Fig. 5: fixed 8x8 overlay, growing 'other logic' reservation
    for reserve in (0, 16, 32, 48, 56):
        ctx = Context(Device("ovl8", OverlaySpec(width=8, height=8)))
        if reserve:
            ctx.reserve(fus=reserve)
        try:
            prog = ctx.build_program(SRC, opts=CompileOptions())
        except Exception:  # noqa: BLE001
            print(f"  8x8   |   {reserve:3d} FUs   |   none (does not fit)")
            continue
        ck = prog.compiled
        print(f"  8x8   |   {reserve:3d} FUs   |   {ck.plan.replicas:4d}  "
              f"| {ck.throughput_gops():4.1f} | {ck.par_time_ms:6.1f}")
    print(f"every build ran on the overlay executor ({dev}), bit-identical "
          f"to run_reference")


if __name__ == "__main__":
    main()
