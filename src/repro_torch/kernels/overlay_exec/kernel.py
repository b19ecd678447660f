"""Binding of the CUDA overlay executor (``csrc/overlay_exec.cu``).

Replaces the Pallas kernel ``_exec_kernel`` / ``overlay_execute`` of the
JAX package (``repro/kernels/overlay_exec/kernel.py``).  The TPU kernel was
compiled once per (n_in, n_out, n_instr, n_regs) signature; this one takes
all four at run time, so ONE build serves every program and a new kernel is
a write into the instruction buffers of an :class:`ExecImage`.

Build: at first use ``nvcc`` compiles the source for ``sm_90a`` into the
checkout's ``build/`` directory, under a name keyed on the hash of the
source and the flags, and the shared library is loaded with ctypes.  Nothing is built or imported from CUDA when this
module is imported.

:func:`overlay_execute` is the wrapper: a CUDA tensor launches the kernel
(``overlay_execute.launches`` counts the launches), a CPU tensor takes the
plain version :func:`repro_torch.kernels.overlay_exec.ref.execute_image`,
anything else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.program import N_OPCODES
from repro_torch.kernels.overlay_exec import ref

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "overlay_exec.cu"
_REPO_ROOT = Path(__file__).resolve().parents[4]

# -fmad=false with the explicit __fmul_rn/__fadd_rn intrinsics keeps every
# op singly rounded like numpy; no --use_fast_math, so denormals survive
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

# threads per block before the register file forces a smaller block
DEFAULT_BLOCK = 256
_WARP = 32
# 6 int32 instruction words + 1 f32 immediate per instruction, staged in
# shared memory behind the register file
_INSTR_BYTES = 7 * 4


def launch_config(n_regs: int, n_instr: int,
                  smem_limit: int) -> Tuple[int, int]:
    """→ (threads per block, dynamic shared-memory bytes).

    The register file takes ``n_regs * block * 4`` bytes; the block halves
    from ``DEFAULT_BLOCK`` until it fits ``smem_limit`` together with the
    staged instructions.  Raises when not even one warp fits."""
    fixed = n_instr * _INSTR_BYTES
    block = DEFAULT_BLOCK
    while block >= _WARP:
        smem = n_regs * block * 4 + fixed
        if smem <= smem_limit:
            return block, smem
        block //= 2
    raise ValueError(
        f"a register file of {n_regs} slots and {n_instr} instructions "
        f"needs {n_regs * _WARP * 4 + fixed} B of shared memory for one "
        f"warp; the device allows {smem_limit} B")


def validate_image(instrs: np.ndarray, imms: np.ndarray, n_regs: int,
                   n_out: int) -> None:
    """Raise ValueError on an image the kernel must not run: wrong shapes,
    an unknown opcode or immediate port, or a slot outside the file."""
    if instrs.ndim != 2 or instrs.shape[1] != 6:
        raise ValueError(f"instrs must be (M, 6), got {instrs.shape}")
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


class _Library:
    """The built and loaded shared library, once per process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib = None
        self._smem: Dict[int, int] = {}
        self.builds = 0          # libraries built or loaded by this process
        self.build_log = ""      # nvcc's output (ptxas register/smem usage)

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def smem_optin(self, device_index: int) -> int:
        lib = self.get()
        with self._lock:
            if device_index not in self._smem:
                val = ctypes.c_int(0)
                err = lib.overlay_exec_smem_optin(device_index,
                                                  ctypes.byref(val))
                _check(lib, err, "cudaDeviceGetAttribute")
                self._smem[device_index] = val.value
            return self._smem[device_index]

    def _load(self):
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
        out_dir = _REPO_ROOT / "build"
        so = out_dir / f"overlay_exec_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.overlay_exec_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_void_p]
        lib.overlay_exec_launch.restype = ctypes.c_int
        lib.overlay_exec_smem_optin.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.overlay_exec_smem_optin.restype = ctypes.c_int
        lib.overlay_exec_error_string.argtypes = [ctypes.c_int]
        lib.overlay_exec_error_string.restype = ctypes.c_char_p
        self.builds += 1
        return lib


LIBRARY = _Library()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the overlay executor")
    return found


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.overlay_exec_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


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
    block, smem = launch_config(image.n_regs, image.n_instr,
                                LIBRARY.smem_optin(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.overlay_exec_launch(
            image.instrs.data_ptr(), image.imms.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, n_in, image.n_out, image.n_instr,
            image.n_regs, block, smem, stream)
    _check(lib, err, "overlay_exec launch")
    overlay_execute.launches += 1
    return out


overlay_execute.launches = 0
