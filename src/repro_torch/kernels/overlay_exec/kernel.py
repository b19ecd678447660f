"""Binding of the CUDA overlay executor (``csrc/overlay_exec.cu``).

Replaces the Pallas kernel ``_exec_kernel`` / ``overlay_execute`` of the
JAX package (``repro/kernels/overlay_exec/kernel.py``).  The TPU kernel was
compiled once per (n_in, n_out, n_instr, n_regs) signature; this one takes
all four at run time, so ONE build serves every program and a new kernel is
a write into the instruction buffers of an :class:`ExecImage`.

Build: at first use ``nvcc`` compiles the source for ``sm_90a`` into the
checkout's ``build/`` directory and ctypes loads it
(:class:`repro_torch.cuda_build.CudaLibrary`).  Nothing is built or
imported from CUDA when this module is imported.

:func:`overlay_execute` is the wrapper: a CUDA tensor launches the kernel
(``overlay_execute.launches`` counts the launches), a CPU tensor takes the
plain version :func:`repro_torch.kernels.overlay_exec.ref.execute_image`,
anything else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.program import N_OPCODES
from repro_torch.cuda_build import CudaLibrary
from repro_torch.kernels.overlay_exec import ref

# -fmad=false with the explicit __fmul_rn/__fadd_rn intrinsics keeps every
# op singly rounded like numpy; no --use_fast_math, so denormals survive
NVCC_FLAGS = ("-fmad=false",)

# (work-items a thread, threads a block) in order of preference: the most
# items a thread at a block of at least 128, then smaller blocks.  The
# register file takes n_regs * block * items * 4 bytes of shared memory.
# The interpreter's cost is per warp and per instruction, so more items a
# thread spread it: on an H100 the paper's 12 cells ran fastest at
# (8, 128) (``benchmarks/torch_kernel_times.py --alternatives``, PERF.md).
PLANS = ((8, 128), (4, 256), (4, 128), (2, 256), (2, 128), (1, 256),
         (1, 128), (4, 64), (2, 64), (1, 64), (4, 32), (2, 32), (1, 32))
_WARP = 32
# one 16-byte word per instruction, staged in shared memory before the
# register file; after it the count and list of slots zeroed per tile
_WORD_BYTES = 16
# slots are 16-bit fields of the instruction word
MAX_REGS = 1 << 16


class LaunchConfig(NamedTuple):
    items: int       # work-items a thread
    block: int       # threads a block
    smem: int        # dynamic shared-memory bytes


def smem_bytes(n_regs: int, n_instr: int, items: int, block: int) -> int:
    """Dynamic shared memory of one block."""
    return (n_instr * _WORD_BYTES + n_regs * block * items * 4
            + 4 * (n_regs + 1))


def item_width(n: int, x_address: int) -> int:
    """The most work-items a thread may take, 8, 4, 2 or 1: ``items``
    divides N, and each input row ``x[i]`` starts on ``4 * items`` bytes
    (16 for 8 items, which move as two 16-byte loads).  (The output, fresh
    from PyTorch's allocator, starts on at least 512 bytes.)"""
    for items in (8, 4, 2, 1):
        if n % items == 0 and x_address % (4 * min(items, 4)) == 0:
            return items
    return 1


def launch_config(n_regs: int, n_instr: int, smem_limit: int,
                  width: int = 8) -> LaunchConfig:
    """→ the first of :data:`PLANS` with at most ``width`` items a thread
    that fits ``smem_limit``.  Raises when not even one warp of one item
    fits."""
    for items, block in PLANS:
        smem = smem_bytes(n_regs, n_instr, items, block)
        if items <= width and smem <= smem_limit:
            return LaunchConfig(items, block, smem)
    raise ValueError(
        f"a register file of {n_regs} slots and {n_instr} instructions "
        f"needs {smem_bytes(n_regs, n_instr, 1, _WARP)} B of shared memory "
        f"for one warp; the device allows {smem_limit} B")


def prefetch_depth(n_in: int) -> int:
    """Tiles whose inputs a thread loads ahead: four registers of a
    thread's work-items hold four tiles of one input, two of two, else one
    (four inputs; any further ones load when their tile runs)."""
    return 4 if n_in <= 1 else 2 if n_in == 2 else 1


def grid_size(n: int, items: int, block: int, n_sm: int,
              blocks_per_sm: int) -> int:
    """Blocks of the launch: as many as the ``n_sm`` SMs hold at once
    (``blocks_per_sm`` each), and no more than there are tiles of
    ``block * items`` work-items, so each block walks its tiles in one
    wave."""
    tiles = -(-n // (block * items))
    return max(1, min(tiles, n_sm * blocks_per_sm))


def validate_image(instrs: np.ndarray, imms: np.ndarray, n_regs: int,
                   n_out: int) -> None:
    """Raise ValueError on an image the kernel must not run: wrong shapes,
    an unknown opcode or immediate port, or a slot outside the file."""
    if instrs.ndim != 2 or instrs.shape[1] != 6:
        raise ValueError(f"instrs must be (M, 6), got {instrs.shape}")
    if n_regs > MAX_REGS:
        raise ValueError(f"n_regs={n_regs}: register slots are 16 bits, "
                         f"at most {MAX_REGS} slots")
    if imms.shape != (instrs.shape[0],):
        raise ValueError(f"imms must be ({instrs.shape[0]},), got "
                         f"{imms.shape}")
    if not 1 <= n_out <= n_regs:
        raise ValueError(f"n_out={n_out} outside [1, n_regs={n_regs}]")
    ops, ports, slots = instrs[:, 0], instrs[:, 5], instrs[:, 1:5]
    if ((ops < 0) | (ops >= N_OPCODES)).any():
        raise ValueError(f"opcode outside [0, {N_OPCODES}): "
                         f"{sorted(set(ops[(ops < 0) | (ops >= N_OPCODES)]))}")
    if not np.isin(ports, (0, 1, 2)).all():
        raise ValueError("imm_port must be 0, 1 or 2")
    if ((slots < 0) | (slots >= n_regs)).any():
        raise ValueError(f"register slot outside [0, {n_regs})")


@dataclasses.dataclass
class ExecImage:
    """A validated execution image resident on one device.

    ``instrs`` (M, 6) int32 and ``imms`` (M,) float32 are the buffers the
    kernel reads; :meth:`write` swaps another program of the same
    (M, n_regs, n_out) signature into them in place.  Make one with
    :meth:`from_arrays`, which checks the values on the host before they
    reach the device (checking them there would synchronise)."""
    instrs: torch.Tensor
    imms: torch.Tensor
    n_regs: int
    n_out: int

    @classmethod
    def from_arrays(cls, instrs, imms, n_regs: int, n_out: int,
                    device) -> "ExecImage":
        instrs = np.ascontiguousarray(instrs, np.int32)
        imms = np.ascontiguousarray(imms, np.float32)
        validate_image(instrs, imms, int(n_regs), int(n_out))
        return cls(torch.as_tensor(instrs, device=device),
                   torch.as_tensor(imms, device=device),
                   int(n_regs), int(n_out))

    @property
    def device(self) -> torch.device:
        return self.instrs.device

    @property
    def n_instr(self) -> int:
        return int(self.instrs.shape[0])

    def write(self, instrs, imms, n_regs: int, n_out: int) -> None:
        """Swap in another program's image (``build_image``'s four values):
        an in-place, stream-ordered copy into the device buffers, with no
        rebuild.  The signature (M, n_regs, n_out) must be this image's:
        the output slots are the last ``n_out`` of ``n_regs``."""
        instrs = np.ascontiguousarray(instrs, np.int32)
        imms = np.ascontiguousarray(imms, np.float32)
        new = (instrs.shape, int(n_regs), int(n_out))
        have = (tuple(self.instrs.shape), self.n_regs, self.n_out)
        if new != have:
            raise ValueError(f"image signature (instrs shape, n_regs, n_out) "
                             f"is {have}, new program's {new}")
        validate_image(instrs, imms, self.n_regs, self.n_out)
        self.instrs.copy_(torch.from_numpy(instrs))
        self.imms.copy_(torch.from_numpy(imms))


_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "overlay_exec",
    {"overlay_exec_launch": (
        [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_size_t, _P],
        ctypes.c_int),
     "overlay_exec_device_limits": (
        [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int),
     "overlay_exec_blocks_per_sm": (
        [_I, _I, _I, ctypes.c_size_t, ctypes.POINTER(_I)], ctypes.c_int)},
    extra_flags=NVCC_FLAGS)
_LIMITS_LOCK = threading.Lock()
_LIMITS: Dict[tuple, Tuple[int, ...]] = {}


def _query(key: tuple, fn, *args, n: int = 1) -> Tuple[int, ...]:
    """``fn(*args, *n int pointers)`` once per ``key``, cached."""
    with _LIMITS_LOCK:
        if key not in _LIMITS:
            vals = [ctypes.c_int(0) for _ in range(n)]
            err = fn(*args, *(ctypes.byref(v) for v in vals))
            LIBRARY.check(err, fn.__name__)
            _LIMITS[key] = tuple(v.value for v in vals)
        return _LIMITS[key]


def device_limits(device_index: int) -> Tuple[int, int]:
    """→ (dynamic shared memory one block may opt in to, SMs) of the
    card."""
    lib = LIBRARY.get()
    return _query(("device", device_index), lib.overlay_exec_device_limits,
                  device_index, n=2)


class Launch(NamedTuple):
    items: int       # work-items a thread
    block: int       # threads a block
    smem: int        # dynamic shared-memory bytes
    depth: int       # tiles whose inputs a thread loads ahead
    grid: int        # blocks


def plan(image: "ExecImage", x: torch.Tensor) -> Launch:
    """The launch of ``image`` over x on its card."""
    dev = x.device.index
    optin, n_sm = device_limits(dev)
    n_in, n = x.shape
    cfg = launch_config(image.n_regs, image.n_instr, optin,
                        item_width(n, x.data_ptr()))
    depth = prefetch_depth(n_in)
    key = ("occupancy", dev, cfg.items, depth, cfg.block, cfg.smem)
    with torch.cuda.device(dev):
        per_sm, = _query(key, LIBRARY.get().overlay_exec_blocks_per_sm,
                         cfg.items, depth, cfg.block, cfg.smem)
    return Launch(*cfg, depth,
                  grid_size(n, cfg.items, cfg.block, n_sm, per_sm))


def overlay_execute(image: ExecImage, x: torch.Tensor) -> torch.Tensor:
    """x: (n_in, N) float32 on the image's device → (n_out, N) float32.

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor runs the plain version."""
    if x.device != image.device or image.imms.device != image.device:
        raise ValueError(f"x on {x.device}, image on {image.device} and "
                         f"{image.imms.device}")
    m = image.n_instr
    if (image.instrs.dtype != torch.int32 or image.imms.dtype != torch.float32
            or tuple(image.instrs.shape) != (m, 6)
            or tuple(image.imms.shape) != (m,)
            or not image.instrs.is_contiguous()
            or not image.imms.is_contiguous()):
        raise ValueError("image buffers must be contiguous (M, 6) int32 and "
                         "(M,) float32; build them with ExecImage.from_arrays")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-d float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n_in, n = x.shape
    if n_in > image.n_regs:
        raise ValueError(f"{n_in} inputs exceed {image.n_regs} registers")
    if x.device.type == "cpu":
        return ref.execute_image(image.instrs, image.imms, image.n_regs, x,
                                 image.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"no overlay executor for device {x.device}")
    out = torch.empty((image.n_out, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = LIBRARY.get()
    dev = x.device.index
    p = plan(image, x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.overlay_exec_launch(
            image.instrs.data_ptr(), image.imms.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, n_in, image.n_out, image.n_instr,
            image.n_regs, p.items, p.depth, p.block, p.grid, p.smem, stream)
    LIBRARY.check(err, "overlay_exec launch")
    overlay_execute.launches += 1
    return out


overlay_execute.launches = 0
