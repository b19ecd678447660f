"""OpenCL-runtime-style session on the PyTorch port (paper section IV,
pocl-on-Zynq analogue): platform → device → context → build (JIT) → set
args → enqueue → read, including a mid-session kernel swap that reuses the
configured overlay, on one CUDA card unless ``--device cpu``.

Builds debit the device's resource ledger (release() credits it back), a
shared JIT cache makes the rebuild of a seen kernel free, the command queue
charges bitstream reconfiguration only on program switches, and every
enqueue runs the overlay executor on the buffers' device, held bit for bit
against ``CompiledKernel.run_reference``.

    PYTHONPATH=src python examples/torch_opencl_runtime_demo.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core.cache import JITCache
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.runtime import Buffer, Context, Device, Platform
from repro_torch.device import target_device


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the buffers live (default: the CUDA card)")
    args = ap.parse_args()
    dev_t = target_device([], args.device)

    platform = Platform([Device("zynq-overlay",
                                OverlaySpec(width=8, height=8,
                                            dsp_per_fu=2))])
    dev = platform.devices[0]
    print("device info:", dev.info())
    cache = JITCache()
    ctx = Context(dev, cache=cache)

    # build + run poly1
    prog = ctx.build_program(BENCHMARKS["poly1"][0], opts=CompileOptions())
    print(f"built poly1 in {prog.build_ms:.1f} ms "
          f"({prog.compiled.plan.replicas} replicas); "
          f"overlay config {prog.compiled.bitstream.n_bytes} B, "
          f"load {prog.configure_overlay():.1f} us; "
          f"ledger: {dev.fu_used}/{dev.spec.n_fus} FUs in use")
    x = np.linspace(-2, 2, 1000).astype(np.float32)
    queue = ctx.create_queue(use_overlay_executor=True)
    ev = queue.enqueue_kernel(
        prog.create_kernel().set_args(Buffer(x, device=dev_t)))
    (out,) = ev.wait()
    assert same_bits(out.read(), prog.compiled.run_reference(x))
    print(f"poly1 results verified on {out.device}, bit for bit "
          f"(config {ev.config_us:.1f} us + exec {ev.exec_us:.1f} us "
          f"modelled)")

    # JIT a second kernel at run time — seconds, not hours.  Releasing the
    # first program credits its FUs back so the new build sees a full overlay.
    prog.release()
    prog2 = ctx.build_program(BENCHMARKS["sgfilter"][0],
                              opts=CompileOptions())
    print(f"built sgfilter in {prog2.build_ms:.1f} ms "
          f"({prog2.compiled.plan.replicas} replicas)")
    y = np.linspace(-1, 1, 1000).astype(np.float32)
    ev2 = queue.enqueue_kernel(prog2.create_kernel().set_args(
        Buffer(x, device=dev_t), Buffer(y, device=dev_t)))
    (out2,) = ev2.wait()
    assert same_bits(out2.read(), prog2.compiled.run_reference(x, y))
    print(f"sgfilter results verified — JIT kernel swap OK "
          f"(reconfig charged: {ev2.config_us:.1f} us)")

    # rebuild poly1: the JIT cache returns the artifact without recompiling
    prog2.release()
    prog3 = ctx.build_program(BENCHMARKS["poly1"][0], opts=CompileOptions())
    print(f"rebuilt poly1 in {prog3.build_ms:.3f} ms (cache: "
          f"{cache.stats.as_dict()})")
    assert cache.stats.hits >= 1, "the rebuild missed the JIT cache"


if __name__ == "__main__":
    main()
